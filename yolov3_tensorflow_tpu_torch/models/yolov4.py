"""YOLOv4: CSPDarknet-53 backbone, SPP, PANet neck and 3 detection heads
(Bochkovskiy, Wang, Liao, arXiv:2004.10934), from darknet's
`cfg/yolov4.cfg` (AlexeyAB/darknet): the live-BN eval forward, the folded
serving body and the packed forward.

The network is the cfg's 162 layers as a table (`layer_plan`), walked by
one interpreter. Its variable tree has `init_yolov3`'s schema, so the BN
fold, the channels_last weights and the packed head of the YOLOv3 path
take it unchanged:

    variables = {
      "params": {"backbone": {"conv_0": {w, gamma, beta}, ... conv_71},
                 "head": {"conv_0": {...}, ..., "conv_37": {w, b}}},
      "batch_stats": {"backbone": {"conv_0": {mean, var}, ...}, "head": ...},
    }

conv weights OIHW. Backbone convs (layers 0-104) are conv_0..71, the neck
and head convs (layers 105-161) conv_0..37, each in the cfg's order; the
three detection convs (head conv_21, conv_29, conv_37, strides 8, 16, 32)
carry a plain bias.

Darknet's channel orders are the cfg's routes: a CSP stage concatenates
[transition | part2], the SPP [mp13 | mp9 | mp5 | x], a PAN top-down
junction [lateral conv | upsampled] and a bottom-up one [down | route].
The backbone's 72 convs are Mish, the neck's 35 LeakyReLU(0.1).
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from yolov3_tensorflow_tpu_torch.models.layers import (batch_norm, conv2d,
                                                       conv_bias, conv_folded,
                                                       leaky_relu,
                                                       upsample_nearest_2x)
from yolov3_tensorflow_tpu_torch.models.yolov3 import Params, nhwc
from yolov3_tensorflow_tpu_torch.ops.conv_epilogue import mish_activation
from yolov3_tensorflow_tpu_torch.utils.profiling import annotate

# the first layer of the neck (SPP, PAN and the heads)
NECK_START = 105
# the detection convs in the packed maps' order, strides 32, 16, 8
DETECTION_CONVS = ("conv_37", "conv_29", "conv_21")
# the cfg's per-scale grid sensitivity, strides 32, 16, 8
SCALE_X_Y = (1.05, 1.1, 1.2)


def layer_plan(num_classes: int = 80) -> List[Tuple]:
    """The 162 layers of `cfg/yolov4.cfg`, in order, sources resolved to
    absolute layer indices:

        ("conv", cout, k, stride, act)   act "mish", "leaky" or "linear"
        ("shortcut", src)                the previous layer + layer src
        ("route", (src, ...))            channel concat of those layers
        ("maxpool", size)                stride 1, padding size // 2
        ("upsample",)                    nearest 2x
        ("yolo", mask, scale_x_y)        a detection layer over the
                                         previous conv's map
    """
    plan: List[Tuple] = []

    def conv(cout, k, stride=1, act="mish"):
        plan.append(("conv", cout, k, stride, act))

    def route(*srcs):           # negative: relative, as darknet reads them
        plan.append(("route", tuple(s if s >= 0 else len(plan) + s
                                    for s in srcs)))

    def shortcut():
        plan.append(("shortcut", len(plan) - 3))

    def res(c_mid, c_out):
        conv(c_mid, 1)
        conv(c_out, 3)
        shortcut()

    def csp(cout, blocks):
        half = cout // 2
        conv(cout, 3, 2)                 # downsample
        conv(half, 1)                    # part2
        route(-2)
        conv(half, 1)                    # part1
        for _ in range(blocks):
            res(half, half)
        conv(half, 1)                    # transition
        route(-1, -(3 * blocks + 4))     # [transition | part2]
        conv(cout, 1)                    # fuse

    conv(32, 3)
    # stage 1 keeps its full width inside the block (64, bottleneck 32)
    conv(64, 3, 2)
    conv(64, 1)
    route(-2)
    conv(64, 1)
    res(32, 64)
    conv(64, 1)
    route(-1, -7)
    conv(64, 1)
    csp(128, 2)
    csp(256, 8)                          # layer 54: the stride-8 route
    csp(512, 8)                          # layer 85: the stride-16 route
    csp(1024, 4)
    assert len(plan) == NECK_START

    out_c = 3 * (5 + num_classes)

    def leaky(cout, k, stride=1):
        conv(cout, k, stride, "leaky")

    def five(c):                         # 1x1, 3x3, 1x1, 3x3, 1x1
        for _ in range(2):
            leaky(c, 1)
            leaky(2 * c, 3)
        leaky(c, 1)

    def head(c, mask, scale):
        leaky(2 * c, 3)
        conv(out_c, 1, 1, "linear")
        plan.append(("yolo", mask, scale))

    leaky(512, 1)
    leaky(1024, 3)
    leaky(512, 1)
    plan.append(("maxpool", 5))          # SPP
    route(-2)
    plan.append(("maxpool", 9))
    route(-4)
    plan.append(("maxpool", 13))
    route(-1, -3, -5, -6)                # [mp13 | mp9 | mp5 | x]
    leaky(512, 1)
    leaky(1024, 3)
    leaky(512, 1)                        # layer 116
    for c, src in ((256, 85), (128, 54)):         # PAN top-down
        leaky(c, 1)
        plan.append(("upsample",))
        route(src)
        leaky(c, 1)
        route(-1, -3)                    # [lateral conv | upsampled]
        five(c)
    head(128, (0, 1, 2), 1.2)            # stride 8
    for c, back in ((256, -16), (512, -37)):      # PAN bottom-up
        route(-4)
        leaky(c, 3, 2)
        route(-1, back)                  # [down | route]
        five(c)
        head(c, (3, 4, 5) if c == 256 else (6, 7, 8),
             1.1 if c == 256 else 1.05)
    return plan


def conv_table(num_classes: int = 80) -> List[Tuple[int, str, str, int, int,
                                                    int, int, str]]:
    """Every conv as (layer, scope, name, cin, cout, k, stride, act), in
    the cfg's order: the 72 backbone convs, then the 38 of the neck and
    heads."""
    plan = layer_plan(num_classes)
    chans: List[int] = []
    rows = []
    count = {"backbone": 0, "head": 0}
    for i, op in enumerate(plan):
        prev = chans[-1] if chans else 3
        if op[0] == "conv":
            _, cout, k, stride, act = op
            scope = "backbone" if i < NECK_START else "head"
            rows.append((i, scope, f"conv_{count[scope]}", prev, cout, k,
                         stride, act))
            count[scope] += 1
            chans.append(cout)
        elif op[0] == "route":
            chans.append(sum(chans[s] for s in op[1]))
        else:
            chans.append(prev)
    return rows


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init_yolov4(generator: torch.Generator, num_classes: int = 80, *,
                device: torch.device) -> Dict[str, Params]:
    """The full variable tree as `init_yolov3` makes it: glorot-uniform
    kernels, gamma=1, beta=0, moving mean=0, moving var=1, zero detection
    biases, drawn from `generator` (on its own device) in the cfg's conv
    order and placed on `device`."""
    params: Params = {"backbone": {}, "head": {}}
    stats: Params = {"backbone": {}, "head": {}}
    for _, scope, name, cin, cout, k, _, act in conv_table(num_classes):
        limit = math.sqrt(6.0 / (k * k * cin + k * k * cout))
        u = torch.rand((cout, cin, k, k), generator=generator,
                       device=generator.device, dtype=torch.float32)
        w = ((u * 2.0 - 1.0) * limit).to(device)
        zeros = torch.zeros(cout, device=device)
        if act == "linear":
            params[scope][name] = {"w": w, "b": zeros}
            continue
        ones = torch.ones(cout, device=device)
        params[scope][name] = {"w": w, "gamma": ones, "beta": zeros}
        stats[scope][name] = {"mean": zeros.clone(), "var": ones.clone()}
    return {"params": params, "batch_stats": stats}


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

ConvFn = Callable[[int, torch.Tensor, Optional[torch.Tensor]], torch.Tensor]


def _last_reads(plan: Sequence[Tuple]) -> List[List[int]]:
    """For each layer, the earlier outputs that no later layer reads: the
    walk drops them there, so that a batch holds only the live maps."""
    last = {}
    for i, op in enumerate(plan):
        srcs = op[1] if op[0] == "route" else (i - 1,)
        if op[0] == "shortcut":
            srcs = (i - 1, op[1])
        for s in srcs:
            if s >= 0:
                last[s] = i
    drops: List[List[int]] = [[] for _ in plan]
    for s, i in last.items():
        drops[i].append(s)
    return drops


def walk(plan: Sequence[Tuple], x: torch.Tensor, conv_fn: ConvFn
         ) -> List[torch.Tensor]:
    """Run the layer table on x [N, 3, H, W] (NCHW). `conv_fn(layer, x,
    shortcut)` applies the conv of layer `layer` with its activation and,
    where a shortcut layer follows it, adds `shortcut` (that layer's
    source) after the activation: the residual add is the conv's, and the
    shortcut layer's output is the conv's. Returns the detection convs'
    outputs in the order their yolo layers come (strides 8, 16, 32).
    Spans (`utils.profiling.annotate`): "yolov4.backbone" (layers 0-104)
    and "yolov4.neck" (the SPP, PAN and heads)."""
    outs: List[Optional[torch.Tensor]] = []
    heads: List[torch.Tensor] = []
    drops = _last_reads(plan)

    def layer(i: int, op: Tuple) -> torch.Tensor:
        prev = outs[-1] if outs else x
        kind = op[0]
        if kind == "conv":
            after = plan[i + 1] if i + 1 < len(plan) else ("",)
            return conv_fn(i, prev, outs[after[1]]
                           if after[0] == "shortcut" else None)
        if kind == "route":
            parts = [outs[s] for s in op[1]]
            return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
        if kind == "maxpool":
            return F.max_pool2d(prev, op[1], 1, op[1] // 2)
        if kind == "upsample":
            return upsample_nearest_2x(prev)
        if kind == "yolo":
            heads.append(prev)
        return prev                      # shortcut: added in its conv

    for name, lo, hi in (("yolov4.backbone", 0, NECK_START),
                         ("yolov4.neck", NECK_START, len(plan))):
        with annotate(name):
            for i in range(lo, hi):
                outs.append(layer(i, plan[i]))
                for s in drops[i]:
                    outs[s] = None
    return heads


@functools.lru_cache(maxsize=None)
def _plan() -> Tuple[Tuple[Tuple, ...], Dict[int, Tuple[str, str, str]]]:
    """The layer table and, per conv layer, (scope, name, act). Only the
    detection convs' widths depend on the class count, and the walk reads
    neither, so one table serves every tree."""
    return (tuple(layer_plan()),
            {row[0]: (row[1], row[2], row[7]) for row in conv_table()})


def yolov4_forward(variables: Dict[str, Params], images: torch.Tensor, *,
                   compute_dtype: torch.dtype = torch.bfloat16,
                   bn_eps: float = 1e-5) -> Tuple[torch.Tensor, ...]:
    """The eval forward with live batch norm (moving statistics).
    images: [N, H, W, 3] float in [0, 1] (NHWC), H and W divisible by 32.
    Returns (fmap_1, fmap_2, fmap_3), each [N, H/s, W/s, 3*(5+C)] fp32,
    s in (32, 16, 8), NHWC views."""
    params, stats = variables["params"], variables["batch_stats"]
    plan, convs = _plan()

    def conv_fn(i, x, shortcut):
        scope, name, act = convs[i]
        p = params[scope][name]
        if act == "linear":
            return conv_bias(x, p, compute_dtype=compute_dtype)
        y = conv2d(x, p["w"], stride=plan[i][3], compute_dtype=compute_dtype)
        y, _ = batch_norm(y, p, stats[scope][name], train=False, eps=bn_eps)
        y = mish_activation(y) if act == "mish" else leaky_relu(y)
        return y if shortcut is None else y + shortcut

    x = images.permute(0, 3, 1, 2).to(compute_dtype)
    heads = walk(plan, x, conv_fn)
    return tuple(nhwc(h) for h in heads[::-1])


def folded_body(folded: Params, images: torch.Tensor, out_fn, *,
                compute_dtype: torch.dtype) -> List[torch.Tensor]:
    """Every conv of a folded tree (`models.yolov3.fold_batch_norm`) through
    `layers.conv_folded` and its epilogue (`ops.conv_epilogue`: Mish, and
    the residual add in the last conv of each residual block, in one pass
    on the card), the detection convs through `out_fn(name, x)`. images:
    [N, H, W, 3] float (NHWC). Returns the 3 detection outputs, strides
    (32, 16, 8), as NHWC views of channels_last tensors."""
    plan, convs = _plan()

    def conv_fn(i, x, shortcut):
        scope, name, act = convs[i]
        if act == "linear":
            return out_fn(name, x)
        return conv_folded(x, folded[scope][name], stride=plan[i][3],
                           compute_dtype=compute_dtype, shortcut=shortcut,
                           mish=act == "mish")

    x = images.to(compute_dtype).permute(0, 3, 1, 2)  # NCHW, channels_last
    return [nhwc(h) for h in walk(plan, x, conv_fn)[::-1]]


def yolov4_forward_folded(folded: Params, images: torch.Tensor, *,
                          compute_dtype: torch.dtype = torch.bfloat16
                          ) -> Tuple[torch.Tensor, ...]:
    """Inference forward with BN pre-folded: the 3 raw maps [N, H/s, W/s,
    3*(5+C)] fp32, s in (32, 16, 8)."""
    return tuple(folded_body(
        folded, images,
        lambda name, x: conv_bias(x, folded["head"][name],
                                  compute_dtype=compute_dtype),
        compute_dtype=compute_dtype))


def yolov4_forward_packed(packed: Params, images: torch.Tensor, *,
                          compute_dtype: torch.dtype = torch.bfloat16,
                          out_dtype: torch.dtype = torch.bfloat16
                          ) -> List[torch.Tensor]:
    """The packed serving forward: 3 tensors [N, Hg, Wg, 3*row] in
    `out_dtype`, strides (32, 16, 8), so in the global anchor order that
    `ops.fast_postprocess.packed_scores` and `packed_decode` read. Params
    come from `ops.fast_postprocess.pack_serving_head(folded, C,
    names=DETECTION_CONVS)`."""
    from yolov3_tensorflow_tpu_torch.ops.fast_postprocess import \
        apply_packed_output_conv

    def out_packed(name, x):
        return apply_packed_output_conv(packed["head"][name], x,
                                        compute_dtype=compute_dtype,
                                        out_dtype=out_dtype)

    return folded_body(packed, images, out_packed,
                       compute_dtype=compute_dtype)
