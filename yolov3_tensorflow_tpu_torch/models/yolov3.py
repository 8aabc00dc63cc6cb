"""YOLOv3: Darknet-53 backbone + FPN neck + 3 detection heads: the folded
inference forward and the live-BN training and eval forward.

Counterpart of `yolov3_tensorflow_tpu/models/yolov3.py`. The layer plan is
copied verbatim (a test holds it equal to the JAX plan), so parameter names
and order are the same in both packages:

    variables = {
      "params": {"backbone": {"conv_0": {w, gamma, beta}, ...},
                 "head": {"conv_0": {...}, ..., "conv_6": {w, b}, ...}},
      "batch_stats": {"backbone": {"conv_0": {mean, var}, ...}, "head": ...},
    }

with conv weights in OIHW (`[cout, cin, k, k]`) instead of JAX's HWIO.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from yolov3_tensorflow_tpu_torch.models.layers import (conv_bias,
                                                       conv_bn_leaky,
                                                       conv_folded,
                                                       conv_folded_asym,
                                                       neck_split_bn_leaky,
                                                       neck_split_folded,
                                                       space_to_depth_2x,
                                                       upsample_nearest_2x)

Params = Dict[str, dict]

# ---------------------------------------------------------------------------
# Architecture plan (copied from the JAX package)
# ---------------------------------------------------------------------------

# Backbone plan ops: ("conv", cout, k, stride) | ("res_begin",) | ("res_end",)
# | ("route",). Stage layout of 1-2-8-8-4 residual blocks with stride-2
# transition convs, emitting 3 routes at strides 8/16/32.
def _darknet53_plan() -> List[Tuple]:
    plan: List[Tuple] = []

    def c(cout: int, k: int, stride: int = 1) -> None:
        plan.append(("conv", cout, k, stride))

    def res(filters: int) -> None:
        plan.append(("res_begin",))
        c(filters, 1)
        c(filters * 2, 3)
        plan.append(("res_end",))

    c(32, 3)
    c(64, 3, 2)
    res(32)
    c(128, 3, 2)
    for _ in range(2):
        res(64)
    c(256, 3, 2)
    for _ in range(8):
        res(128)
    plan.append(("route",))          # route_1, stride 8
    c(512, 3, 2)
    for _ in range(8):
        res(256)
    plan.append(("route",))          # route_2, stride 16
    c(1024, 3, 2)
    for _ in range(4):
        res(512)
    plan.append(("route",))          # route_3, stride 32
    return plan


BACKBONE_PLAN = _darknet53_plan()

# the three bias-carrying detection output convs (strides 32, 16, 8)
DETECTION_CONVS = ("conv_6", "conv_14", "conv_22")


# Head conv table, darknet serialization order. Entries:
#   (name_idx, cout, k, has_bn)    detection convs have cout 3*(5+num_classes)
def head_plan(num_classes: int) -> List[Tuple[int, int, int, bool]]:
    out_c = 3 * (5 + num_classes)

    def block(start: int, f: int) -> List[Tuple[int, int, int, bool]]:
        ks = [1, 3, 1, 3, 1, 3]
        cs = [f, 2 * f, f, 2 * f, f, 2 * f]
        return [(start + i, cs[i], ks[i], True) for i in range(6)]

    plan: List[Tuple[int, int, int, bool]] = []
    plan += block(0, 512)
    plan += [(6, out_c, 1, False)]       # detection output, stride 32
    plan += [(7, 256, 1, True)]          # pre-upsample lateral conv
    plan += block(8, 256)
    plan += [(14, out_c, 1, False)]      # detection output, stride 16
    plan += [(15, 128, 1, True)]         # pre-upsample lateral conv
    plan += block(16, 128)
    plan += [(22, out_c, 1, False)]      # detection output, stride 8
    return plan


def darknet_layer_order(num_classes: int) -> List[Tuple[str, str, bool]]:
    """Ordered (scope, conv_name, has_bn) matching darknet .weights layout:
    52 backbone convs then 23 head convs."""
    order = []
    idx = 0
    for op in BACKBONE_PLAN:
        if op[0] == "conv":
            order.append(("backbone", f"conv_{idx}", True))
            idx += 1
    for name_idx, _, _, has_bn in head_plan(num_classes):
        order.append(("head", f"conv_{name_idx}", has_bn))
    return order


def _head_input_channels(num_classes: int) -> Dict[int, int]:
    """Input channel count for each head conv, from the FPN dataflow."""
    cin: Dict[int, int] = {}
    # block 1 on route_3 (1024 ch)
    c = 1024
    for i, (_, cout, _, _) in enumerate(head_plan(num_classes)[:6]):
        cin[i] = c
        c = cout
    cin[6] = 1024        # after conv_5 (3x3, 1024)
    cin[7] = 512         # inter1 = output of conv_4 (512)
    # block 2 on concat(upsample(conv_7)=256, route_2=512) = 768
    c = 768
    for i in range(8, 14):
        cin[i] = c
        c = head_plan(num_classes)[i][1]
    cin[14] = 512
    cin[15] = 256        # inter2 = output of conv_12 (256)
    # block 3 on concat(upsample(conv_15)=128, route_1=256) = 384
    c = 384
    for i in range(16, 22):
        cin[i] = c
        c = head_plan(num_classes)[i][1]
    cin[22] = 256
    return cin


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _glorot_uniform(generator: torch.Generator, k: int, cin: int, cout: int
                    ) -> torch.Tensor:
    """OIHW kernel from U(-l, l), l = sqrt(6 / (fan_in + fan_out)) with
    fan = k*k*channels: the distribution of jax's glorot_uniform (the
    draws differ)."""
    limit = math.sqrt(6.0 / (k * k * cin + k * k * cout))
    u = torch.rand((cout, cin, k, k), generator=generator,
                   device=generator.device, dtype=torch.float32)
    return (u * 2.0 - 1.0) * limit


def init_yolov3(generator: torch.Generator, num_classes: int = 80, *,
                device: torch.device) -> Dict[str, Params]:
    """Initialize the full variable tree: glorot-uniform kernels, gamma=1,
    beta=0, moving mean=0, moving var=1, zero detection biases. Draws come
    from `generator` (on its own device) and land on `device`."""
    params: Params = {"backbone": {}, "head": {}}
    stats: Params = {"backbone": {}, "head": {}}

    def conv_bn(k: int, cin: int, cout: int):
        w = _glorot_uniform(generator, k, cin, cout).to(device)
        ones = torch.ones(cout, device=device)
        zeros = torch.zeros(cout, device=device)
        return ({"w": w, "gamma": ones, "beta": zeros},
                {"mean": zeros.clone(), "var": ones.clone()})

    cin = 3
    idx = 0
    for op in BACKBONE_PLAN:
        if op[0] != "conv":
            continue
        _, cout, k, _ = op
        p, s = conv_bn(k, cin, cout)
        params["backbone"][f"conv_{idx}"] = p
        stats["backbone"][f"conv_{idx}"] = s
        cin = cout
        idx += 1

    head_cin = _head_input_channels(num_classes)
    for name_idx, cout, k, has_bn in head_plan(num_classes):
        name = f"conv_{name_idx}"
        cin = head_cin[name_idx]
        if has_bn:
            params["head"][name], stats["head"][name] = conv_bn(k, cin, cout)
        else:
            params["head"][name] = {
                "w": _glorot_uniform(generator, k, cin, cout).to(device),
                "b": torch.zeros(cout, device=device)}
    return {"params": params, "batch_stats": stats}


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _backbone_forward(conv_fn, x: torch.Tensor, *,
                      fused_residual: bool = False
                      ) -> Tuple[torch.Tensor, ...]:
    """Walk BACKBONE_PLAN; `conv_fn(idx, x, stride)` applies conv idx.
    Returns the 3 routes (strides 8, 16, 32).

    fused_residual=True passes the pending shortcut to the last conv of
    each residual block as `conv_fn(idx, x, stride, shortcut)` and skips
    the `x + shortcut` here: for forwards that add it in the conv's
    epilogue (the folded forwards in `ops.conv_epilogue`'s pass; the
    int8-chained forward in the dequantized domain, before
    requantizing)."""
    routes: List[torch.Tensor] = []
    shortcut = None
    idx = 0
    for i, op in enumerate(BACKBONE_PLAN):
        kind = op[0]
        if kind == "conv":
            closes_res = (fused_residual and i + 1 < len(BACKBONE_PLAN)
                          and BACKBONE_PLAN[i + 1][0] == "res_end")
            if closes_res:
                x = conv_fn(idx, x, op[3], shortcut)
                shortcut = None
            else:
                x = conv_fn(idx, x, op[3])
            idx += 1
        elif kind == "res_begin":
            shortcut = x
        elif kind == "res_end":
            if not fused_residual:
                x = x + shortcut
        elif kind == "route":
            routes.append(x)
    return tuple(routes)


def _head_forward(conv_fn, out_fn, routes: Sequence[torch.Tensor],
                  neck_fn=None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """FPN neck + 3 heads. `conv_fn(idx, x)` is a BN conv (folded, live or
    int8), `out_fn(idx, x)` a detection conv. `neck_fn(lat_idx, first_idx,
    inter, route)`, when given, returns the output of head conv
    `first_idx` at each junction (see layers.neck_split_folded and
    neck_split_bn_leaky); without it the junction is the literal lateral
    conv, upsample, concat and first conv, whose concat tensor the int8
    calibration observes."""
    route_1, route_2, route_3 = routes

    def junction(lat_idx, first_idx, inter, route):
        if neck_fn is not None:
            return neck_fn(lat_idx, first_idx, inter, route)
        x = upsample_nearest_2x(conv_fn(lat_idx, inter))
        x = torch.cat([x, route.to(x.dtype)], dim=1)
        return conv_fn(first_idx, x)

    x = route_3
    for i in range(5):
        x = conv_fn(i, x)
    inter1 = x
    x = conv_fn(5, x)
    fmap_1 = out_fn(6, x)                       # stride 32

    x = junction(7, 8, inter1, route_2)
    for i in range(9, 13):
        x = conv_fn(i, x)
    inter2 = x
    x = conv_fn(13, x)
    fmap_2 = out_fn(14, x)                      # stride 16

    x = junction(15, 16, inter2, route_1)
    for i in range(17, 21):
        x = conv_fn(i, x)
    x = conv_fn(21, x)
    fmap_3 = out_fn(22, x)                      # stride 8
    return fmap_1, fmap_2, fmap_3


def yolov3_forward(variables: Dict[str, Params], images: torch.Tensor, *,
                   train: bool = False,
                   compute_dtype: torch.dtype = torch.bfloat16,
                   bn_momentum: float = 0.99, bn_eps: float = 1e-5,
                   split_neck: bool = True, group=None
                   ) -> Tuple[Tuple[torch.Tensor, ...], Dict[str, Params]]:
    """The forward with live batch norm: the training forward (train=True:
    batch moments, moving statistics updated) and the eval forward
    (train=False: moving statistics).

    images: [N, H, W, 3] float in [0, 1] (NHWC), H and W divisible by 32.
    Returns ((fmap_1, fmap_2, fmap_3), new_batch_stats): fmap_i is
    [N, H/s, W/s, 3*(5+C)] fp32, s in (32, 16, 8), an NHWC view of a
    channels_last tensor; the new statistics mirror variables["batch_stats"]
    and carry no gradient. split_neck=True (the default) takes each FPN
    junction in the split form (`layers.neck_split_bn_leaky`); False the
    literal upsample + concat + conv. With a process `group` (JAX's
    `axis_name`) the training batch norms sync their moments over it
    (`layers.batch_norm`); without one no collective runs.
    """
    params, stats = variables["params"], variables["batch_stats"]
    new_stats: Params = {"backbone": {}, "head": {}}
    bn = dict(train=train, momentum=bn_momentum, eps=bn_eps,
              compute_dtype=compute_dtype, group=group)

    def bn_conv(scope: str, idx: int, x: torch.Tensor, stride: int = 1):
        name = f"conv_{idx}"
        y, new_stats[scope][name] = conv_bn_leaky(
            x, params[scope][name], stats[scope][name], stride=stride, **bn)
        return y

    def neck_fn(lat_idx, first_idx, inter, route):
        lat, first = f"conv_{lat_idx}", f"conv_{first_idx}"
        head, head_stats = params["head"], stats["head"]
        out, new_stats["head"][lat], new_stats["head"][first] = \
            neck_split_bn_leaky(inter, route, head[lat], head_stats[lat],
                                head[first], head_stats[first], **bn)
        return out

    x = images.permute(0, 3, 1, 2).to(compute_dtype)   # NCHW, channels_last
    routes = _backbone_forward(lambda i, x, s: bn_conv("backbone", i, x, s), x)
    fmaps = _head_forward(
        lambda i, x: bn_conv("head", i, x),
        lambda i, x: conv_bias(x, params["head"][f"conv_{i}"],
                               compute_dtype=compute_dtype),
        routes, neck_fn if split_neck else None)
    return tuple(f.permute(0, 2, 3, 1) for f in fmaps), new_stats


def fold_batch_norm(variables: Dict[str, Params],
                    dtype: torch.dtype = torch.bfloat16) -> Params:
    """Fold BN statistics into conv kernels for inference.

    w' = w * gamma / sqrt(var + eps);  b' = beta - mean * gamma / sqrt(var+eps)
    Detection convs keep (w, b), with w cast to `dtype` and b in fp32.
    The fp32 square root is taken in float64 and rounded once, which gives
    the correctly rounded value, as JAX's: PyTorch's vectorized fp32
    `sqrt` on the CPU is off by an ulp on some inputs.
    """
    eps = 1e-5
    params, stats = variables["params"], variables["batch_stats"]
    folded: Params = {}
    for scope in params:
        folded[scope] = {}
        for name, p in params[scope].items():
            if "gamma" in p:
                s = stats[scope][name]
                scale = p["gamma"] / torch.sqrt((s["var"] + eps).double()
                                                ).float()
                folded[scope][name] = {
                    "w": (p["w"] * scale.view(-1, 1, 1, 1)).to(dtype),
                    "b": (p["beta"] - s["mean"] * scale).float(),
                }
            else:
                folded[scope][name] = {"w": p["w"].to(dtype),
                                       "b": p["b"].float()}
    return folded


def channels_last_weights(tree: Params) -> Params:
    """Store every 4-D conv kernel of a folded (or quantized) tree, the
    packed and split detection convs' included, in channels_last memory,
    the layout cuDNN runs fastest with channels_last activations. In
    place; returns the tree."""
    for convs in tree.values():
        for p in convs.values():
            for q in (p, *(v for v in p.values() if isinstance(v, dict))):
                if "w" in q:
                    q["w"] = q["w"].contiguous(
                        memory_format=torch.channels_last)
    return tree


def nhwc(out):
    """An NCHW head output, or a tuple of them (the split head's), as NHWC
    views: channels_last tensors, so no copy."""
    if isinstance(out, tuple):
        return tuple(t.permute(0, 2, 3, 1) for t in out)
    return out.permute(0, 2, 3, 1)


def folded_body(folded: Params, images: torch.Tensor, out_fn, *,
                compute_dtype: torch.dtype, stem_s2d: bool = False,
                split_neck: bool = True) -> List:
    """Folded backbone + neck + head convs, with the detection convs applied
    by `out_fn(i, x)` (i in 6, 14, 22) (JAX `_serving_body`). images:
    [N, H, W, 3] float (NHWC). Returns the 3 head outputs, strides (32, 16,
    8), as NHWC views of channels_last tensors (`nhwc`).

    stem_s2d=True takes a tree rewritten by `space_to_depth_stem` and runs
    conv_0 and conv_1 on the space-to-depth(2) images: conv_0 as a 3x3
    12->128 conv at half resolution, conv_1 as a 2x2 conv padded top and
    left (`layers.conv_folded_asym`). split_neck=True (the default) takes
    every FPN junction in the split form (`layers.neck_split_folded`),
    False the literal upsample + concat + conv. The last conv of each
    residual block adds the shortcut in its epilogue (`fused_residual`)."""

    def bn_conv(scope: str, idx: int, x: torch.Tensor, stride: int = 1,
                shortcut=None):
        return conv_folded(x, folded[scope][f"conv_{idx}"], stride=stride,
                           compute_dtype=compute_dtype, shortcut=shortcut)

    def neck_fn(lat_idx, first_idx, inter, route):
        return neck_split_folded(inter, route, folded["head"][f"conv_{lat_idx}"],
                                 folded["head"][f"conv_{first_idx}"],
                                 compute_dtype=compute_dtype)

    if stem_s2d:
        def backbone_conv(i, x, s, shortcut=None):
            if i == 0:              # [N, 12, H/2, W/2] -> [N, 128, H/2, W/2]
                return bn_conv("backbone", 0, x)
            if i == 1:              # 2x2 over cells (m-1..m, n-1..n)
                return conv_folded_asym(x, folded["backbone"]["conv_1"],
                                        padding=((1, 0), (1, 0)),
                                        compute_dtype=compute_dtype)
            return bn_conv("backbone", i, x, s, shortcut)
        x = space_to_depth_2x(images, dtype=compute_dtype)
    else:
        def backbone_conv(i, x, s, shortcut=None):
            return bn_conv("backbone", i, x, s, shortcut)
        x = images.to(compute_dtype)
    x = x.permute(0, 3, 1, 2)                          # NCHW, channels_last
    routes = _backbone_forward(backbone_conv, x, fused_residual=True)
    fmaps = _head_forward(lambda i, x: bn_conv("head", i, x), out_fn, routes,
                          neck_fn if split_neck else None)
    return [nhwc(f) for f in fmaps]


def yolov3_forward_folded(folded: Params, images: torch.Tensor, *,
                          compute_dtype: torch.dtype = torch.bfloat16,
                          stem_s2d: bool = False, split_neck: bool = True
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Inference forward with BN pre-folded (see `fold_batch_norm`).
    images: [N, H, W, 3], H and W divisible by 32. Returns (fmap_1, fmap_2,
    fmap_3), each [N, H/s, W/s, 3*(5+C)] fp32, s in (32, 16, 8).

    stem_s2d=True expects a tree rewritten by `space_to_depth_stem` and
    runs the first two convs in space-to-depth form (the same sums,
    reassociated). split_neck=True (the default) takes the split-neck
    junctions, False the literal reference dataflow (see `folded_body`).
    """
    fmaps = folded_body(
        folded, images,
        lambda i, x: conv_bias(x, folded["head"][f"conv_{i}"],
                               compute_dtype=compute_dtype),
        compute_dtype=compute_dtype, stem_s2d=stem_s2d,
        split_neck=split_neck)
    return tuple(fmaps)


def space_to_depth_stem(folded: Params) -> Params:
    """Rewrite the folded stem convs into space-to-depth(2) equivalents
    (JAX `space_to_depth_stem`, the same numpy arithmetic on the host):

      conv_0 (3x3 s1, 3->32 at H x W) becomes 3x3 s1, 12->128 at H/2 x W/2;
        output channel block (dy*2+dx)*32+o holds conv_0's output for pixel
        phase (dy, dx): w0'[a, b, (py*2+px)*3+c, (dy*2+dx)*32+o]
          = w0[u+1, v+1, c, o], u = 2(a-1)+py-dy, v = 2(b-1)+px-dx
          (zero where u or v falls outside {-1, 0, 1});
      conv_1 (3x3 s2, 32->64) becomes 2x2 s1, 128->64 over s2d cells
        (m-1..m, n-1..n), padded top and left:
          w1'[a, b, (py*2+px)*32+c, o] = w1[2(a-1)+py+1, 2(b-1)+px+1, c, o]

    (indices in JAX's HWIO; the kernels are stored OIHW here). The same
    multiply-adds, reassociated; the rest of the tree is shared, not
    copied. Both kernels take conv_0's dtype and device, the biases fp32.
    """
    p0, p1 = folded["backbone"]["conv_0"], folded["backbone"]["conv_1"]

    def hwio(w: torch.Tensor) -> np.ndarray:
        return w.detach().float().cpu().numpy().transpose(2, 3, 1, 0)

    w0, w1 = hwio(p0["w"]), hwio(p1["w"])       # [3,3,3,32], [3,3,32,64]
    b0 = p0["b"].detach().float().cpu().numpy()
    cin0, cout0 = w0.shape[2], w0.shape[3]
    cin1, cout1 = w1.shape[2], w1.shape[3]
    if cin1 != cout0:
        raise ValueError(f"conv_1 reads {cin1} channels, conv_0 writes "
                         f"{cout0}")

    w0p = np.zeros((3, 3, 4 * cin0, 4 * cout0), np.float32)
    for a in range(3):
        for b in range(3):
            for py in range(2):
                for px in range(2):
                    for dy in range(2):
                        for dx in range(2):
                            u = 2 * (a - 1) + py - dy
                            v = 2 * (b - 1) + px - dx
                            if u < -1 or u > 1 or v < -1 or v > 1:
                                continue
                            w0p[a, b,
                                (py * 2 + px) * cin0:(py * 2 + px + 1) * cin0,
                                (dy * 2 + dx) * cout0:(dy * 2 + dx + 1) * cout0
                                ] = w0[u + 1, v + 1]
    w1p = np.zeros((2, 2, 4 * cout0, cout1), np.float32)
    for a in range(2):
        for b in range(2):
            for py in range(2):
                for px in range(2):
                    u = 2 * (a - 1) + py
                    v = 2 * (b - 1) + px
                    if u < -1 or u > 1 or v < -1 or v > 1:
                        continue
                    w1p[a, b,
                        (py * 2 + px) * cin1:(py * 2 + px + 1) * cin1, :
                        ] = w1[u + 1, v + 1]

    def oihw(w: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(
            w.transpose(3, 2, 0, 1))).to(p0["w"].device, p0["w"].dtype)

    out = {scope: dict(v) for scope, v in folded.items()}
    out["backbone"]["conv_0"] = {
        "w": oihw(w0p),
        "b": torch.from_numpy(np.tile(b0, 4)).to(p0["b"].device)}
    out["backbone"]["conv_1"] = {"w": oihw(w1p), "b": p1["b"].float()}
    return out


# ---------------------------------------------------------------------------
# Convenience wrapper
# ---------------------------------------------------------------------------

class YoloV3:
    """Thin stateless wrapper bundling the architecture's hyperparameters,
    with the JAX package's defaults (its `YoloV3`, after the reference
    `yolov3` class): `init`, `forward`, `predict`, `compute_loss`, all
    functions of explicit variables."""

    def __init__(self, num_classes: int, anchors: np.ndarray,
                 use_label_smooth: bool = False, use_focal_loss: bool = False,
                 batch_norm_decay: float = 0.999, weight_decay: float = 5e-4,
                 compute_dtype: torch.dtype = torch.bfloat16):
        self.num_classes = int(num_classes)
        self.anchors = np.asarray(anchors, np.float32)
        self.use_label_smooth = use_label_smooth
        self.use_focal_loss = use_focal_loss
        self.batch_norm_decay = batch_norm_decay
        self.weight_decay = weight_decay
        self.compute_dtype = compute_dtype

    def init(self, generator: torch.Generator, *, device: torch.device
             ) -> Dict[str, Params]:
        """The variable tree of `init_yolov3`, on `device`: required, as
        every build function of the port takes it, so the weights land on
        the card the caller names and never on the CPU by default."""
        return init_yolov3(generator, self.num_classes, device=device)

    def forward(self, variables: Dict[str, Params], images: torch.Tensor,
                train: bool = False, group=None):
        return yolov3_forward(variables, images, train=train,
                              compute_dtype=self.compute_dtype,
                              bn_momentum=self.batch_norm_decay, group=group)

    def predict(self, feature_maps, img_size: Tuple[int, int]):
        from yolov3_tensorflow_tpu_torch.models.decode import predict_boxes
        return predict_boxes(feature_maps, self.anchors, self.num_classes,
                             img_size)

    def compute_loss(self, feature_maps, y_true, img_size: Tuple[int, int]):
        from yolov3_tensorflow_tpu_torch.ops.losses import compute_loss
        return compute_loss(
            feature_maps, y_true, self.anchors, self.num_classes, img_size,
            use_label_smooth=self.use_label_smooth,
            use_focal_loss=self.use_focal_loss)
