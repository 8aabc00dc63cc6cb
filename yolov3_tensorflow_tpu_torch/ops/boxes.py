"""Box geometry (counterpart of `yolov3_tensorflow_tpu/ops/boxes.py`)."""

from __future__ import annotations

import torch


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
