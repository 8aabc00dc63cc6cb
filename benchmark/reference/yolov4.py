"""YOLOv4 (CSPDarknet-53, SPP, PANet, Mish) in plain float32 PyTorch.

Written from the paper (Bochkovskiy, Wang, Liao, arXiv:2004.10934) and
darknet's `cfg/yolov4.cfg` (AlexeyAB/darknet), with no kernel, cache or
batching trick: the 162 layers as a table, each conv with batch norm
unfolded (moving statistics, or the batch's moments where asked), Mish as
`x * torch.tanh(F.softplus(x))`, the SPP's max pools padded with -inf,
nearest 2x upsamples, the routes' channel concats in the cfg's orders, and
the yolo layers' decode with their `scale_x_y` (darknet's
`forward_yolo_layer` and `get_yolo_box`). It imports neither JAX nor the
package under test; selection and greedy NMS stay `benchmark/check.py`'s,
which takes the rows `flat_rows` gives.

Departures from the cfg, each where the benchmark needs its own form:
- the [net] section's training settings (batch, subdivisions, momentum,
  decay, augmentation, the learning-rate schedule) are not read: this is
  the inference network only;
- the yolo layers' loss settings (jitter, ignore_thresh, truth_thresh,
  iou_thresh, cls_normalizer, iou_normalizer, iou_loss=ciou, max_delta)
  are not read, nor is nms_kind=greedynms with beta_nms=0.6 (DIoU-free
  greedy NMS at the serving IoU threshold is `check.py`'s);
- the maps are returned strides 32, 16, 8 (the cfg's yolo layers come 8,
  16, 32), and the rows are in that global order, the program's;
- boxes are xyxy in input pixels (darknet's are relative centres), and
  exp(tw) is clamped at exp(60) so that no box is infinite;
- the input is RGB in [0, 1] as given, with no letterbox or resize;
- `precision="fp8"` rounds each conv's input, kernel and output to float8
  e4m3 under a per-tensor scale (the control, one precision below the
  configuration's bfloat16), `precision="bf16"` to bfloat16 (a witness);
- `moments=True` normalizes every batch norm by the batch's own moments
  and records them in `self.moments` (the benchmark's weights take their
  moving statistics from them).

Tensors are NCHW inside, NHWC at the boundary; kernels are OIHW. The
weight tree: {"params": {scope: {conv: {"w", "gamma", "beta"} or {"w",
"b"}}}, "batch_stats": {scope: {conv: {"mean", "var"}}}}, scopes
"backbone" (conv_0..71, layers 0-104) and "head" (conv_0..37, layers
105-161), convs numbered in the cfg's order.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

FP8_MAX = 448.0
LEAKY = 0.1
BN_EPS = 1e-5
NECK_START = 105
ANCHORS = ((12, 16), (19, 36), (40, 28), (36, 75), (76, 55), (72, 146),
           (142, 110), (192, 243), (459, 401))


def layers(num_classes: int) -> List[Tuple]:
    """The cfg's 162 layers, sources as absolute indices:
    ("conv", filters, size, stride, activation), ("shortcut", from),
    ("route", (layers...)), ("maxpool", size), ("upsample",),
    ("yolo", mask, scale_x_y)."""
    out: List[Tuple] = []

    def conv(f, size, stride=1, act="mish"):
        out.append(("conv", f, size, stride, act))

    def route(*ls):
        out.append(("route", tuple(i if i >= 0 else len(out) + i
                                   for i in ls)))

    def block(mid, f):
        conv(mid, 1)
        conv(f, 3)
        out.append(("shortcut", len(out) - 3))

    conv(32, 3)
    # [downsample, part2, route -2, part1, blocks, transition,
    #  route -1,-(3n+4), fuse] per stage, the first at full width
    for f, n in ((64, 1), (128, 2), (256, 8), (512, 8), (1024, 4)):
        part = 64 if n == 1 else f // 2
        conv(f, 3, 2)
        conv(part, 1)
        route(-2)
        conv(part, 1)
        for _ in range(n):
            block(32 if n == 1 else part, part)
        conv(part, 1)
        route(-1, -(3 * n + 4))
        conv(f, 1)

    def lk(f, size, stride=1):
        conv(f, size, stride, "leaky")

    out_c = 3 * (5 + num_classes)
    lk(512, 1)
    lk(1024, 3)
    lk(512, 1)
    out.append(("maxpool", 5))
    route(-2)
    out.append(("maxpool", 9))
    route(-4)
    out.append(("maxpool", 13))
    route(-1, -3, -5, -6)
    lk(512, 1)
    lk(1024, 3)
    lk(512, 1)
    for f, r in ((256, 85), (128, 54)):
        lk(f, 1)
        out.append(("upsample",))
        route(r)
        lk(f, 1)
        route(-1, -3)
        for size in (1, 3, 1, 3, 1):
            lk(f if size == 1 else 2 * f, size)
    heads = (((0, 1, 2), 1.2, 128, None), ((3, 4, 5), 1.1, 256, -16),
             ((6, 7, 8), 1.05, 512, -37))
    for mask, sxy, f, back in heads:
        if back is not None:
            route(-4)
            lk(f, 3, 2)
            route(-1, back)
            for size in (1, 3, 1, 3, 1):
                lk(f if size == 1 else 2 * f, size)
        lk(2 * f, 3)
        conv(out_c, 1, 1, "linear")
        out.append(("yolo", mask, sxy))
    return out


def conv_table(num_classes: int) -> List[Tuple[str, str, int, int, int, int,
                                                bool]]:
    """Every conv as (scope, name, cin, cout, k, stride, has_bn), in the
    cfg's order: 72 backbone convs, then 38 of the neck and heads."""
    rows, chans = [], []
    n = {"backbone": 0, "head": 0}
    for i, op in enumerate(layers(num_classes)):
        cin = chans[-1] if chans else 3
        if op[0] == "conv":
            scope = "backbone" if i < NECK_START else "head"
            rows.append((scope, f"conv_{n[scope]}", cin, op[1], op[2],
                         op[3], op[4] != "linear"))
            n[scope] += 1
            chans.append(op[1])
        elif op[0] == "route":
            chans.append(sum(chans[j] for j in op[1]))
        else:
            chans.append(cin)
    return rows


# --------------------------------------------------------------------------
# Forward
# --------------------------------------------------------------------------

def _scaled(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    scale = x.abs().amax().clamp(min=1e-30) / top
    return (x / scale).to(dtype).float() * scale


ROUNDING = {"fp32": lambda t: t,
            "bf16": lambda t: t.bfloat16().float(),
            "fp8": lambda t: _scaled(t, torch.float8_e4m3fn, FP8_MAX)}


def mish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.tanh(F.softplus(x))


class Net:
    """The network over one weight tree, in float32 (eval: moving
    statistics; moments=True: each batch norm by the batch's moments,
    recorded in `self.moments[scope][name]` as {"mean", "var"}).
    `on_activation(act, h)`, if given, sees each activation's input."""

    def __init__(self, variables, num_classes: int, *,
                 precision: str = "fp32", moments: bool = False,
                 on_activation=None):
        if precision not in ROUNDING:
            raise ValueError(f"precision fp32, bf16 or fp8, got "
                             f"{precision!r}")
        self.params = variables["params"]
        self.stats = variables["batch_stats"]
        self.num_classes = num_classes
        self.round = ROUNDING[precision]
        self.use_moments = moments
        self.on_activation = on_activation
        self.moments: Dict[str, Dict[str, dict]] = {"backbone": {},
                                                    "head": {}}

    def conv(self, scope: str, name: str, x: torch.Tensor, stride: int,
             act: str) -> torch.Tensor:
        p = self.params[scope][name]
        w = p["w"]
        y = self.round(F.conv2d(self.round(x), self.round(w), stride=stride,
                                padding=(w.shape[-1] - 1) // 2))
        if act == "linear":
            return y + p["b"].view(1, -1, 1, 1)
        if self.use_moments:
            mean = y.mean(dim=(0, 2, 3))
            var = y.var(dim=(0, 2, 3), unbiased=False)
            self.moments[scope][name] = {"mean": mean, "var": var}
        else:
            s = self.stats[scope][name]
            mean, var = s["mean"], s["var"]
        y = (y - mean.view(1, -1, 1, 1)) / torch.sqrt(
            var.view(1, -1, 1, 1) + BN_EPS)
        y = y * p["gamma"].view(1, -1, 1, 1) + p["beta"].view(1, -1, 1, 1)
        if self.on_activation is not None:
            self.on_activation(act, y)
        return mish(y) if act == "mish" else F.leaky_relu(y, LEAKY)

    def __call__(self, images: torch.Tensor) -> List[torch.Tensor]:
        """images [N, H, W, 3] float in [0, 1] -> the three raw maps
        [N, H/s, W/s, 3*(5+C)] for s = 32, 16, 8."""
        x = images.float().permute(0, 3, 1, 2)
        outs: List[torch.Tensor] = []
        heads = []
        n = {"backbone": 0, "head": 0}
        for i, op in enumerate(layers(self.num_classes)):
            prev = outs[-1] if outs else x
            if op[0] == "conv":
                scope = "backbone" if i < NECK_START else "head"
                y = self.conv(scope, f"conv_{n[scope]}", prev, op[3], op[4])
                n[scope] += 1
            elif op[0] == "shortcut":
                y = prev + outs[op[1]]
            elif op[0] == "route":
                y = torch.cat([outs[j] for j in op[1]], dim=1)
            elif op[0] == "maxpool":
                k = op[1]
                y = F.max_pool2d(F.pad(prev, [k // 2] * 4,
                                       value=-math.inf), k, 1)
            elif op[0] == "upsample":
                y = F.interpolate(prev, scale_factor=2, mode="nearest")
            else:
                heads.append(prev)
                y = prev
            outs.append(y)
        return [h.permute(0, 2, 3, 1) for h in heads[::-1]]


# --------------------------------------------------------------------------
# Decode
# --------------------------------------------------------------------------

def yolo_layers(num_classes: int) -> List[Tuple[Tuple[int, ...], float]]:
    """(mask, scale_x_y) of each yolo layer, strides 32, 16, 8."""
    return [(op[1], op[2]) for op in layers(num_classes)
            if op[0] == "yolo"][::-1]


def flat_rows(maps: Sequence[torch.Tensor], anchors, img_hw: Tuple[int, int],
              num_classes: int) -> Dict[str, torch.Tensor]:
    """Every anchor of the three maps (strides 32, 16, 8), in global order
    (scale, y, x, anchor): "box" [N, A, 4] xyxy input pixels, "conf"
    [N, A] logit, "cls" [N, A, C] logits. Centres as darknet's yolo layer
    with scale_x_y = s: (sigmoid(t) * s - (s - 1) / 2 + cell) * stride;
    sizes exp(t) * anchor."""
    a = torch.as_tensor(anchors, dtype=torch.float32).reshape(9, 2)
    boxes, confs, clss = [], [], []
    for m, (mask, s) in zip(maps, yolo_layers(num_classes)):
        n, hg, wg, ch = m.shape
        r = m.float().reshape(n, hg, wg, 3, ch // 3)
        gy, gx = torch.meshgrid(torch.arange(hg, device=m.device),
                                torch.arange(wg, device=m.device),
                                indexing="ij")
        shift = -0.5 * (s - 1.0)
        cx = (torch.sigmoid(r[..., 0]) * s + shift + gx[..., None]) * (
            img_hw[1] / wg)
        cy = (torch.sigmoid(r[..., 1]) * s + shift + gy[..., None]) * (
            img_hw[0] / hg)
        g = a[list(mask)].to(m.device)
        w = torch.exp(r[..., 2].clamp(max=60.0)) * g[:, 0]
        h = torch.exp(r[..., 3].clamp(max=60.0)) * g[:, 1]
        boxes.append(torch.stack([cx - w / 2, cy - h / 2, cx + w / 2,
                                  cy + h / 2], -1).reshape(n, -1, 4))
        confs.append(r[..., 4].reshape(n, -1))
        clss.append(r[..., 5:].reshape(n, hg * wg * 3, -1))
    return {"box": torch.cat(boxes, 1), "conf": torch.cat(confs, 1),
            "cls": torch.cat(clss, 1)}
