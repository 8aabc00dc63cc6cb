"""YOLOv3 (Darknet-53 + the three-scale FPN head) in plain float32 PyTorch.

The forward with batch norm unfolded (moving statistics in eval, batch
moments in training), the anchor decode, the selection of candidates, a
greedy per-class NMS, the VOC recipe's loss, the label grids and the
momentum step. `precision="fp8"` rounds each conv's input, kernel and
output where the program rounds them to bfloat16, to float8 e4m3 under a
per-tensor scale, and their gradients to e5m2: the control, one
precision below the configurations' bfloat16. `precision="bf16"` rounds
at the same places to bfloat16: a witness.

Tensors are NCHW inside, NHWC at the boundary; kernels are OIHW. The
weight tree is the one `benchmark.weights` draws:
{"params": {scope: {conv: {"w", "gamma", "beta"} or {"w", "b"}}},
 "batch_stats": {scope: {conv: {"mean", "var"}}}}.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

FP8_MAX = 448.0
LEAKY = 0.1
BN_EPS = 1e-5


# --------------------------------------------------------------------------
# Architecture
# --------------------------------------------------------------------------

def backbone_plan() -> List[Tuple]:
    """Darknet-53: ("conv", cout, k, stride), ("res", filters) for one
    residual block of a 1x1 and a 3x3 conv, ("route",) after the stage
    whose output feeds the head."""
    plan: List[Tuple] = [("conv", 32, 3, 1), ("conv", 64, 3, 2), ("res", 32),
                         ("conv", 128, 3, 2)]
    plan += [("res", 64)] * 2 + [("conv", 256, 3, 2)]
    plan += [("res", 128)] * 8 + [("route",), ("conv", 512, 3, 2)]
    plan += [("res", 256)] * 8 + [("route",), ("conv", 1024, 3, 2)]
    plan += [("res", 512)] * 4 + [("route",)]
    return plan


def conv_table(num_classes: int) -> List[Tuple[str, str, int, int, int, int,
                                                bool]]:
    """Every conv as (scope, name, cin, cout, k, stride, has_bn), in the
    darknet order: 52 backbone convs, then the 23 head convs."""
    rows = []
    cin, i = 3, 0
    for op in backbone_plan():
        convs = []
        if op[0] == "conv":
            convs = [(op[1], op[2], op[3])]
        elif op[0] == "res":
            convs = [(op[1], 1, 1), (2 * op[1], 3, 1)]
        for cout, k, stride in convs:
            rows.append(("backbone", f"conv_{i}", cin, cout, k, stride, True))
            cin, i = cout, i + 1
    out_c = 3 * (5 + num_classes)

    def block(start, cin, f):
        for j, (cout, k) in enumerate([(f, 1), (2 * f, 3)] * 3):
            rows.append(("head", f"conv_{start + j}", cin, cout, k, 1, True))
            cin = cout

    block(0, 1024, 512)
    rows.append(("head", "conv_6", 1024, out_c, 1, 1, False))
    rows.append(("head", "conv_7", 512, 256, 1, 1, True))
    block(8, 256 + 512, 256)
    rows.append(("head", "conv_14", 512, out_c, 1, 1, False))
    rows.append(("head", "conv_15", 256, 128, 1, 1, True))
    block(16, 128 + 256, 128)
    rows.append(("head", "conv_22", 256, out_c, 1, 1, False))
    return rows


# --------------------------------------------------------------------------
# Forward
# --------------------------------------------------------------------------

class _Round(torch.autograd.Function):
    """Rounds a tensor on the way forward and its gradient on the way
    back, each by its own rule."""

    @staticmethod
    def forward(ctx, x, forward_rule, backward_rule):
        ctx.backward_rule = backward_rule
        return forward_rule(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.backward_rule(grad), None, None


def _scaled(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    """x rounded to a float8 type under a per-tensor scale that maps its
    largest magnitude to the type's largest value."""
    scale = x.abs().amax().clamp(min=1e-30) / top
    return (x / scale).to(dtype).float() * scale


def _e4m3(x):
    return _scaled(x, torch.float8_e4m3fn, FP8_MAX)


def _e5m2(x):
    return _scaled(x, torch.float8_e5m2, 57344.0)


def _bf16(x):
    return x.bfloat16().float()


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x in float8 as FP8 training keeps it: e4m3 on the way forward, its
    gradient in e5m2 on the way back, each under a per-tensor scale."""
    return _Round.apply(x, _e4m3, _e5m2)


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """x and its gradient rounded to bfloat16: a witness, the reference
    rounded where the program rounds, in the program's own precision."""
    return _Round.apply(x, _bf16, _bf16)


class Net:
    """The network over one weight tree. train=True normalizes by batch
    moments and records the new moving statistics in `self.new_stats`
    (momentum `bn_momentum`, JAX's decay convention)."""

    def __init__(self, variables, num_classes: int, *, train: bool = False,
                 bn_momentum: float = 0.99, precision: str = "fp32"):
        rounding = {"fp32": lambda t: t, "bf16": bf16_round,
                    "fp8": fp8_round}
        if precision not in rounding:
            raise ValueError(f"precision fp32, bf16 or fp8, got "
                             f"{precision!r}")
        self.params = variables["params"]
        self.stats = variables["batch_stats"]
        self.num_classes = num_classes
        self.train = train
        self.momentum = bn_momentum
        self.round = rounding[precision]
        self.new_stats: Dict[str, Dict[str, dict]] = {"backbone": {},
                                                      "head": {}}

    def conv(self, scope: str, idx: int, x: torch.Tensor,
             stride: int = 1) -> torch.Tensor:
        name = f"conv_{idx}"
        p = self.params[scope][name]
        w = p["w"]
        y = self.round(F.conv2d(self.round(x), self.round(w), stride=stride,
                                padding=(w.shape[-1] - 1) // 2))
        if "gamma" not in p:
            return y + p["b"].view(1, -1, 1, 1)
        s = self.stats[scope][name]
        if self.train:
            mean = y.mean(dim=(0, 2, 3))
            var = y.var(dim=(0, 2, 3), unbiased=False)
            m = self.momentum
            self.new_stats[scope][name] = {
                "mean": m * s["mean"] + (1 - m) * mean.detach(),
                "var": m * s["var"] + (1 - m) * var.detach()}
        else:
            mean, var = s["mean"], s["var"]
        y = (y - mean.view(1, -1, 1, 1)) / torch.sqrt(
            var.view(1, -1, 1, 1) + BN_EPS)
        y = y * p["gamma"].view(1, -1, 1, 1) + p["beta"].view(1, -1, 1, 1)
        return F.leaky_relu(y, LEAKY)

    def __call__(self, images: torch.Tensor) -> List[torch.Tensor]:
        """images [N, H, W, 3] float in [0, 1] -> the three raw maps
        [N, H/s, W/s, 3*(5+C)] for s = 32, 16, 8."""
        x = images.float().permute(0, 3, 1, 2)
        routes, i = [], 0
        for op in backbone_plan():
            if op[0] == "conv":
                x = self.conv("backbone", i, x, op[3])
                i += 1
            elif op[0] == "res":
                y = self.conv("backbone", i, x)
                x = x + self.conv("backbone", i + 1, y)
                i += 2
            else:
                routes.append(x)
        outs = []
        x, start = routes[2], 0
        for route in (routes[1], routes[0], None):
            for j in range(5):
                x = self.conv("head", start + j, x)
            inter = x
            outs.append(self.conv("head", start + 6, self.conv(
                "head", start + 5, x)))
            if route is None:
                break
            lat = self.conv("head", start + 7, inter)
            x = torch.cat([F.interpolate(lat, scale_factor=2,
                                         mode="nearest"), route], dim=1)
            start += 8
        return [o.permute(0, 2, 3, 1) for o in outs]


def letterbox(frames: torch.Tensor, dst_hw: Tuple[int, int], *,
              bgr: bool) -> torch.Tensor:
    """uint8 frames [N, H, W, 3] -> network input [N, dh, dw, 3] RGB in
    [0, 1]: the frame scaled by the largest ratio that fits (sizes
    truncated to whole pixels), bilinear with antialiasing, clipped to
    [0, 255], centred on gray 128."""
    n, sh, sw, _ = frames.shape
    dh, dw = dst_hw
    ratio = min(dw / sw, dh / sh)
    rw, rh = int(ratio * sw), int(ratio * sh)
    top, left = (dh - rh) // 2, (dw - rw) // 2
    x = frames.flip(-1) if bgr else frames
    x = F.interpolate(x.permute(0, 3, 1, 2).float(), size=(rh, rw),
                      mode="bilinear", align_corners=False, antialias=True)
    out = torch.full((n, 3, dh, dw), 128.0, device=frames.device)
    out[:, :, top:top + rh, left:left + rw] = x.clamp(0.0, 255.0)
    return (out / 255.0).permute(0, 2, 3, 1)


# --------------------------------------------------------------------------
# Decode, selection and NMS
# --------------------------------------------------------------------------

def anchor_groups(anchors) -> List[torch.Tensor]:
    """The 9 anchors [(w, h)] as the three scales' groups, strides 32, 16,
    8: anchors 6-8, 3-5, 0-2."""
    a = torch.as_tensor(anchors, dtype=torch.float32).reshape(9, 2)
    return [a[6:9], a[3:6], a[0:3]]


def flat_rows(maps: Sequence[torch.Tensor], anchors, img_hw: Tuple[int, int]
              ) -> Dict[str, torch.Tensor]:
    """Every anchor of the three maps, in global order (scale, y, x,
    anchor): "box" [N, A, 4] xyxy input pixels, "conf" [N, A] logit,
    "cls" [N, A, C] logits, "twh" [N, A, 2] raw size logits."""
    boxes, confs, clss = [], [], []
    for m, group in zip(maps, anchor_groups(anchors)):
        n, hg, wg, ch = m.shape
        r = m.float().reshape(n, hg, wg, 3, ch // 3)
        gy, gx = torch.meshgrid(torch.arange(hg, device=m.device),
                                torch.arange(wg, device=m.device),
                                indexing="ij")
        cx = (torch.sigmoid(r[..., 0]) + gx[..., None]) * (img_hw[1] / wg)
        cy = (torch.sigmoid(r[..., 1]) + gy[..., None]) * (img_hw[0] / hg)
        g = group.to(m.device)
        w = torch.exp(r[..., 2].clamp(max=60.0)) * g[:, 0]
        h = torch.exp(r[..., 3].clamp(max=60.0)) * g[:, 1]
        boxes.append(torch.stack([cx - w / 2, cy - h / 2, cx + w / 2,
                                  cy + h / 2], -1).reshape(n, -1, 4))
        confs.append(r[..., 4].reshape(n, -1))
        clss.append(r[..., 5:].reshape(n, hg * wg * 3, -1))
    return {"box": torch.cat(boxes, 1), "conf": torch.cat(confs, 1),
            "cls": torch.cat(clss, 1)}


def iou_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU of xyxy boxes a [..., N, 4] against b [..., M, 4] -> [..., N, M]."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    inter = (rb - lt).clamp(min=0).prod(-1)
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    return inter / (area_a[..., :, None] + area_b[..., None, :] - inter
                    + 1e-10)


def greedy_nms(boxes: torch.Tensor, scores: torch.Tensor, score_thresh: float,
               iou_thresh: float) -> torch.Tensor:
    """Greedy NMS of one class: boxes [K, 4], scores [K] -> keep [K] bool.
    Candidates at or above the threshold, best score first (ties to the
    lower index); one is kept when no kept one overlaps it by more than
    iou_thresh."""
    order = torch.sort(scores, descending=True, stable=True).indices
    over = (iou_matrix(boxes, boxes) > iou_thresh).cpu().numpy()
    valid = (scores >= score_thresh).cpu().numpy()
    keep = np.zeros(len(scores), dtype=bool)
    suppressed = np.zeros(len(scores), dtype=bool)
    for i in order.cpu().tolist():
        if not valid[i]:
            break
        if not suppressed[i]:
            keep[i] = True
            suppressed |= over[i]
    return torch.from_numpy(keep)


def greedy_nms_sorted(boxes: torch.Tensor, scores: torch.Tensor,
                      score_thresh: float, iou_thresh: float,
                      block: int = 64) -> torch.Tensor:
    """`greedy_nms` of many groups at once, each already in score order:
    boxes [G, K, 4], scores [G, K] (descending) -> keep [G, K] bool. Rank
    by rank, a candidate at or above the threshold is kept unless a kept
    one before it overlaps it by more than iou_thresh; `block` groups at a
    time bound the [block, K, K] overlap matrix."""
    keep = torch.zeros(scores.shape, dtype=torch.bool, device=scores.device)
    for g in range(0, scores.shape[0], block):
        over = iou_matrix(boxes[g:g + block], boxes[g:g + block]) \
            > iou_thresh
        out = ~(scores[g:g + block] >= score_thresh)     # decided: dropped
        for i in range(scores.shape[1]):
            take = ~out[:, i]
            keep[g:g + block, i] = take
            out |= over[:, i] & take[:, None]
    return keep


# --------------------------------------------------------------------------
# Training: labels, loss, step
# --------------------------------------------------------------------------

def label_grids(gt_boxes, gt_labels, gt_mask, img_hw: Tuple[int, int],
                num_classes: int, anchors) -> List[torch.Tensor]:
    """Padded ground truth (boxes [N, M, 4] xyxy, labels [N, M], mask
    [N, M]) -> the three grids [N, H/s, W/s, 3, 6+C] (s = 32, 16, 8): cx,
    cy, w, h, objectness, one-hot class, weight 1. Each box goes to the
    anchor of best width/height IoU among all nine and to the cell of its
    center; where two boxes share a slot the later one's box stays and
    both classes are set."""
    img_h, img_w = img_hw
    a = torch.as_tensor(anchors, dtype=torch.float32).reshape(9, 2)
    boxes = torch.as_tensor(gt_boxes, dtype=torch.float32).cpu()
    labels = torch.as_tensor(gt_labels).cpu()
    mask = torch.as_tensor(gt_mask).cpu()
    n = boxes.shape[0]
    grids = []
    for s in (32, 16, 8):
        g = torch.zeros(n, img_h // s, img_w // s, 3, 6 + num_classes)
        g[..., -1] = 1.0
        grids.append(g)
    for i in range(n):
        for j in range(boxes.shape[1]):
            if not mask[i, j]:
                continue
            x0, y0, x1, y1 = boxes[i, j, :4].tolist()
            w, h = x1 - x0, y1 - y0
            inter = torch.minimum(a[:, 0], torch.tensor(w)) * torch.minimum(
                a[:, 1], torch.tensor(h))
            iou = inter / (w * h + a[:, 0] * a[:, 1] - inter + 1e-10)
            best = int(torch.argmax(iou))
            scale = 2 - best // 3
            stride = (32, 16, 8)[scale]
            g = grids[scale]
            cx, cy = (x0 + x1) / 2, (y0 + y1) / 2
            gx = min(int(cx // stride), g.shape[2] - 1)
            gy = min(int(cy // stride), g.shape[1] - 1)
            slot = g[i, gy, gx, best % 3]
            slot[0:5] = torch.tensor([cx, cy, w, h, 1.0])
            slot[5 + int(labels[i, j])] = 1.0
    return grids


def bce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Sigmoid cross-entropy, written to stay finite."""
    return (logits.clamp(min=0) - logits * targets
            + torch.log1p(torch.exp(-logits.abs())))


def xywh_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU of center-format boxes a [..., 4] against b [..., V, 4]."""
    a = a[..., None, :]
    lt = torch.maximum(a[..., :2] - a[..., 2:] / 2, b[..., :2] - b[..., 2:] / 2)
    rb = torch.minimum(a[..., :2] + a[..., 2:] / 2, b[..., :2] + b[..., 2:] / 2)
    inter = (rb - lt).clamp(min=0).prod(-1)
    return inter / (a[..., 2] * a[..., 3] + b[..., 2] * b[..., 3] - inter
                    + 1e-10)


def yolo_loss(maps: Sequence[torch.Tensor], grids: Sequence[torch.Tensor],
              anchors, num_classes: int, img_hw: Tuple[int, int], *,
              label_smooth: bool, focal: bool) -> Dict[str, torch.Tensor]:
    """The YOLOv3 loss of the VOC recipe, each term summed over cells and
    divided by the batch: squared error of the in-cell centers and of the
    log sizes (weighted 2 - w*h/area), the objectness cross-entropy with
    the negatives that overlap a ground-truth box of their scale by 0.5 or
    more ignored (focal: times |target - p|^2), and the class
    cross-entropy (label smoothing: targets 0.99 one-hot + 0.01 / C)."""
    img_h, img_w = img_hw
    terms = {"xy": 0.0, "wh": 0.0, "conf": 0.0, "class": 0.0}
    for m, y, group in zip(maps, grids, anchor_groups(anchors)):
        n, hg, wg, _ = m.shape
        r = m.float().reshape(n, hg, wg, 3, 5 + num_classes)
        y = y.to(m.device)
        g = group.to(m.device)
        ratio = torch.tensor([img_w / wg, img_h / hg], device=m.device)
        gy, gx = torch.meshgrid(torch.arange(hg, device=m.device),
                                torch.arange(wg, device=m.device),
                                indexing="ij")
        offset = torch.stack([gx, gy], -1)[:, :, None, :].float()
        pred_xy = torch.sigmoid(r[..., 0:2]) + offset
        pred_wh = torch.exp(r[..., 2:4].clamp(max=60.0)) * g
        obj = y[..., 4:5]
        with torch.no_grad():
            pred_box = torch.cat([pred_xy * ratio, pred_wh], -1)
            ignore = torch.empty_like(obj)
            for i in range(n):
                truth = y[i][y[i, ..., 4] > 0][:, 0:4]
                if len(truth) == 0:
                    ignore[i] = 1.0
                    continue
                best = xywh_iou(pred_box[i], truth).amax(-1)
                ignore[i] = (best < 0.5).float()[..., None]
        true_xy = y[..., 0:2] / ratio
        t_wh = y[..., 2:4] / g
        t_wh = torch.log(torch.where(t_wh == 0, 1.0, t_wh).clamp(1e-9, 1e9))
        p_wh = r[..., 2:4].clamp(-math.log(1e9), math.log(1e9))
        scale = 2.0 - y[..., 2:3] * y[..., 3:4] / (img_w * img_h)
        terms["xy"] = terms["xy"] + ((true_xy - pred_xy) ** 2 * obj
                                     * scale).sum() / n
        terms["wh"] = terms["wh"] + ((t_wh - p_wh) ** 2 * obj
                                     * scale).sum() / n
        conf_logit = r[..., 4:5]
        conf = bce(conf_logit, obj) * (obj + (1 - obj) * ignore)
        if focal:
            conf = conf * (obj - torch.sigmoid(conf_logit)).abs() ** 2
        terms["conf"] = terms["conf"] + conf.sum() / n
        target = y[..., 5:-1]
        if label_smooth:
            target = 0.99 * target + 0.01 / num_classes
        terms["class"] = terms["class"] + (obj * bce(r[..., 5:], target)
                                           ).sum() / n
    terms["total"] = terms["xy"] + terms["wh"] + terms["conf"] + terms["class"]
    return terms


def leaves(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """A nested dict of tensors as {"a/b/c": tensor}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(leaves(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def nest(flat: Dict[str, torch.Tensor]):
    """Inverse of `leaves`."""
    tree: dict = {}
    for path, v in flat.items():
        node = tree
        *parents, last = path.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[last] = v
    return tree


class TrainStep:
    """The recipe's train step in float32: loss + L2 (weight decay / 2 over
    every conv kernel), gradients of every leaf, each clipped to norm
    `clip` on its own, the momentum trace a = m * a + g, and p - lr * a;
    the moving statistics from the batch moments. `state` is
    {"params", "batch_stats", "trace"}."""

    def __init__(self, cfg: dict, anchors, *, precision: str = "fp32"):
        self.cfg = cfg
        self.anchors = anchors
        self.precision = precision

    def init(self, variables) -> dict:
        params = {k: v.detach().clone() for k, v in
                  leaves(variables["params"]).items()}
        return {"params": params,
                "batch_stats": variables["batch_stats"],
                "trace": {k: torch.zeros_like(v) for k, v in params.items()}}

    def __call__(self, state: dict, images: torch.Tensor, grids):
        c = self.cfg
        live = {k: v.detach().requires_grad_(True)
                for k, v in state["params"].items()}
        net = Net({"params": nest(live), "batch_stats": state["batch_stats"]},
                  c["num_classes"], train=True,
                  bn_momentum=c["batch_norm_decay"], precision=self.precision)
        with torch.enable_grad():
            maps = net(images)
            losses = yolo_loss(maps, grids, self.anchors, c["num_classes"],
                               tuple(images.shape[1:3]),
                               label_smooth=c["use_label_smooth"],
                               focal=c["use_focal_loss"])
            l2 = 0.5 * c["weight_decay"] * sum(
                (v ** 2).sum() for k, v in live.items() if k.endswith("/w"))
            grads = torch.autograd.grad(losses["total"] + l2,
                                        list(live.values()))
        params, trace = {}, {}
        for (k, p), g in zip(state["params"].items(), grads):
            norm = g.norm()
            g = g * torch.clamp(c["grad_clip_norm"] / norm.clamp(min=1e-20),
                                max=1.0)
            trace[k] = c["momentum"] * state["trace"][k] + g
            params[k] = p - c["learning_rate"] * trace[k]
        new = {"params": params, "batch_stats": net.new_stats,
               "trace": trace}
        return new, {k: float(v.detach()) for k, v in losses.items()}, grads
