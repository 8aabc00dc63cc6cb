"""Box geometry (counterpart of `yolov3_tensorflow_tpu/ops/boxes.py`)."""

from __future__ import annotations

import torch


def _at_least_zero(x: torch.Tensor) -> torch.Tensor:
    """max(x, 0) with JAX's gradient: half the cotangent at x == 0, where
    `torch.clamp` passes all of it."""
    return torch.maximum(x, x.new_zeros(()))


def xywh_to_xyxy(boxes: torch.Tensor) -> torch.Tensor:
    """(cx, cy, w, h) -> (x0, y0, x1, y1) on the last axis."""
    center, size = boxes[..., 0:2], boxes[..., 2:4]
    half = size * 0.5
    return torch.cat([center - half, center + half], dim=-1)


def xyxy_to_xywh(boxes: torch.Tensor) -> torch.Tensor:
    """(x0, y0, x1, y1) -> (cx, cy, w, h) on the last axis."""
    mins, maxs = boxes[..., 0:2], boxes[..., 2:4]
    return torch.cat([(mins + maxs) * 0.5, maxs - mins], dim=-1)


def iou_xywh(pred_boxes: torch.Tensor, true_boxes: torch.Tensor,
             eps: float = 1e-10) -> torch.Tensor:
    """Broadcast IoU between center-format boxes: pred_boxes [..., 4]
    (cx, cy, w, h) against true_boxes [..., V, 4] (leading dimensions
    broadcast against pred_boxes'; the JAX function takes [V, 4]) ->
    [..., V], with the JAX formula's 1e-10 denominator epsilon."""
    pred_xy = pred_boxes[..., None, 0:2]
    pred_wh = pred_boxes[..., None, 2:4]
    true_xy = true_boxes[..., 0:2]
    true_wh = true_boxes[..., 2:4]

    mins = torch.maximum(pred_xy - pred_wh * 0.5, true_xy - true_wh * 0.5)
    maxs = torch.minimum(pred_xy + pred_wh * 0.5, true_xy + true_wh * 0.5)
    wh = _at_least_zero(maxs - mins)

    inter = wh[..., 0] * wh[..., 1]
    pred_area = pred_wh[..., 0] * pred_wh[..., 1]
    true_area = true_wh[..., 0] * true_wh[..., 1]
    return inter / (pred_area + true_area - inter + eps)


def giou_xywh(boxes_a: torch.Tensor, boxes_b: torch.Tensor,
              eps: float = 1e-10) -> torch.Tensor:
    """Elementwise Generalized IoU between center-format boxes:
    [..., 4] x [..., 4] -> [...] in [-1, 1],
    IoU - (enclosing area - union) / enclosing area."""
    a_min = boxes_a[..., 0:2] - boxes_a[..., 2:4] * 0.5
    a_max = boxes_a[..., 0:2] + boxes_a[..., 2:4] * 0.5
    b_min = boxes_b[..., 0:2] - boxes_b[..., 2:4] * 0.5
    b_max = boxes_b[..., 0:2] + boxes_b[..., 2:4] * 0.5

    inter_wh = _at_least_zero(torch.minimum(a_max, b_max)
                              - torch.maximum(a_min, b_min))
    inter = inter_wh[..., 0] * inter_wh[..., 1]
    area_a = boxes_a[..., 2] * boxes_a[..., 3]
    area_b = boxes_b[..., 2] * boxes_b[..., 3]
    union = area_a + area_b - inter
    iou = inter / (union + eps)

    enc_wh = _at_least_zero(torch.maximum(a_max, b_max)
                            - torch.minimum(a_min, b_min))
    enc = enc_wh[..., 0] * enc_wh[..., 1]
    return iou - (enc - union) / (enc + eps)


def iou_xyxy(boxes_a: torch.Tensor, boxes_b: torch.Tensor,
             eps: float = 1e-10) -> torch.Tensor:
    """Pairwise IoU between corner-format boxes: [..., N, 4] x [..., M, 4]
    -> [..., N, M].

    The JAX package's formula, operation for operation, including the
    1e-10 epsilon: inter / (area_a + area_b - inter + eps). The NMS kernel
    (csrc/nms_shared.cu) evaluates the same expression in the same order,
    so IoU>t decisions agree bit for bit.
    """
    a = boxes_a[..., :, None, :]
    b = boxes_b[..., None, :, :]
    mins = torch.maximum(a[..., 0:2], b[..., 0:2])
    maxs = torch.minimum(a[..., 2:4], b[..., 2:4])
    wh = torch.clamp(maxs - mins, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    return inter / (area_a + area_b - inter + eps)
