"""The YOLOv3 training loss (counterpart of `yolov3_tensorflow_tpu/ops/losses.py`).

Per scale, each term summed over the batch and divided by the batch size,
then summed over the three scales:

- xy: squared error of the in-cell offsets, weighted by the object mask,
  box_loss_scale = 2 - w*h / image area, and the mixup weight
- wh: squared error in log-anchor space, the ground truth with its 0 -> 1
  substitution and [1e-9, 1e9] clip, the prediction clipped straight from
  the raw logits
- conf: sigmoid BCE over every cell, the negatives multiplied by the ignore
  mask; optional focal modulation (alpha 1, gamma 2)
- class: sigmoid BCE on object cells, optional label smoothing (delta 0.01)

The ignore mask takes a fixed-capacity selection of the ground-truth cells
(`_ignore_mask`), as the JAX package does, so an image with more occupied
cells than `max_gt` ignores against the same `max_gt` boxes in both.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from yolov3_tensorflow_tpu_torch.models.decode import (decode_feature_map,
                                                       device_anchors,
                                                       grid_ratio)
from yolov3_tensorflow_tpu_torch.ops.boxes import giou_xywh, iou_xywh

LOSS_TERMS = ("total", "xy", "wh", "conf", "class")


def sigmoid_bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Numerically stable sigmoid cross-entropy, written out as the JAX
    package writes it: max(x, 0) - x*z + log(1 + exp(-|x|)). (`max` with
    JAX's gradient at x == 0, half the cotangent.)"""
    return (torch.maximum(logits, logits.new_zeros(())) - logits * labels
            + torch.log1p(torch.exp(-torch.abs(logits))))


@torch.no_grad()
def _ignore_mask(pred_boxes: torch.Tensor, y_true: torch.Tensor,
                 max_gt: int = 64) -> torch.Tensor:
    """Cells whose best IoU against the ground-truth boxes of their image is
    below 0.5: [N, H, W, 3, 1] float.

    pred_boxes [N, H, W, 3, 4] decoded (cx, cy, w, h) in input pixels;
    y_true [N, H, W, 3, 6+C]. The ground truth is the first `max_gt` cells
    of a stable descending sort of the {0, 1} objectness grid: occupied
    cells first, ties in index order, as JAX's `lax.top_k` returns them
    (`torch.topk` promises no order among ties, and with more than `max_gt`
    occupied cells the order decides which boxes count). Unoccupied slots
    get zero boxes, whose IoU is 0.
    """
    n = y_true.shape[0]
    obj = y_true[..., 4].reshape(n, -1)                 # [N, HWA]
    gt_boxes = y_true[..., 0:4].reshape(n, -1, 4)       # [N, HWA, 4]
    k = min(max_gt, obj.shape[1])
    top_obj, top_idx = torch.sort(obj, dim=1, descending=True, stable=True)
    top_obj, top_idx = top_obj[:, :k], top_idx[:, :k]
    top_boxes = gt_boxes.gather(1, top_idx[..., None].expand(n, k, 4))
    top_boxes = top_boxes * top_obj[..., None]
    iou = iou_xywh(pred_boxes, top_boxes[:, None, None, None])  # [N,H,W,3,k]
    best_iou = iou.amax(dim=-1)
    return (best_iou < 0.5).float()[..., None]


def loss_scale(feature_map: torch.Tensor, y_true: torch.Tensor,
               anchors: np.ndarray, num_classes: int,
               img_size: Tuple[int, int], *,
               use_label_smooth: bool = False, use_focal_loss: bool = False,
               max_gt: int = 64, box_loss: str = "reference"
               ) -> Tuple[torch.Tensor, ...]:
    """Loss of one scale: (xy, wh, conf, class) fp32 scalars, each already
    divided by the batch size.

    feature_map [N, Hg, Wg, 3*(5+C)] raw conv output; y_true
    [N, Hg, Wg, 3, 6+C]: channels 0:4 (cx, cy, w, h) in input pixels, 4
    objectness, 5:5+C one-hot class, the last the mixup weight. anchors
    [3, 2] of this scale; img_size (height, width). box_loss "reference"
    (grid-space xy and wh MSE) or "giou" (1 - GIoU on the decoded boxes,
    reported as xy, with wh 0).
    """
    img_h, img_w = img_size
    n = float(feature_map.shape[0])
    hg, wg = feature_map.shape[1], feature_map.shape[2]
    dev = feature_map.device
    anchors_t = device_anchors(anchors, dev)

    xy_offset, pred_boxes, conf_logits, prob_logits = decode_feature_map(
        feature_map, anchors, num_classes, img_size)

    y_true = y_true.float()
    object_mask = y_true[..., 4:5]
    ignore_mask = _ignore_mask(pred_boxes, y_true, max_gt=max_gt)

    # in-cell offsets, range 0..1
    wh_ratio = grid_ratio(img_size, hg, wg, dev)
    true_xy = y_true[..., 0:2] / wh_ratio - xy_offset
    pred_xy = pred_boxes[..., 0:2] / wh_ratio - xy_offset

    # log-space wh. The prediction is clip(t_wh, +-log 1e9) from the raw
    # logits: the same value as re-logging the exp-decoded size, without
    # exp's overflow, whose gradient would be 0 * inf = NaN
    true_tw_th = y_true[..., 2:4] / anchors_t
    true_tw_th = torch.where(true_tw_th == 0.0, 1.0, true_tw_th)
    true_tw_th = torch.log(torch.clamp(true_tw_th, 1e-9, 1e9))
    raw_wh = feature_map.reshape(*y_true.shape[:4],
                                 5 + num_classes)[..., 2:4].float()
    log_bound = math.log(1e9)
    pred_tw_th = torch.clamp(raw_wh, -log_bound, log_bound)

    # smaller boxes get a bigger weight
    box_loss_scale = 2.0 - (y_true[..., 2:3] / float(img_w)) * (
        y_true[..., 3:4] / float(img_h))
    mix_w = y_true[..., -1:]

    if box_loss == "giou":
        giou = giou_xywh(pred_boxes, y_true[..., 0:4])[..., None]
        xy_loss = torch.sum((1.0 - giou) * object_mask * box_loss_scale
                            * mix_w) / n
        wh_loss = feature_map.new_zeros((), dtype=torch.float32)
    else:
        xy_loss = torch.sum(torch.square(true_xy - pred_xy) * object_mask
                            * box_loss_scale * mix_w) / n
        wh_loss = torch.sum(torch.square(true_tw_th - pred_tw_th)
                            * object_mask * box_loss_scale * mix_w) / n

    conf_pos = object_mask * sigmoid_bce(conf_logits, object_mask)
    conf_neg = (1.0 - object_mask) * ignore_mask * sigmoid_bce(
        conf_logits, object_mask)
    conf_loss = conf_pos + conf_neg
    if use_focal_loss:
        alpha, gamma = 1.0, 2.0
        focal = alpha * torch.pow(
            torch.abs(object_mask - torch.sigmoid(conf_logits)), gamma)
        conf_loss = conf_loss * focal
    conf_loss = torch.sum(conf_loss * mix_w) / n

    if use_label_smooth:
        delta = 0.01
        label_target = (1 - delta) * y_true[..., 5:-1] + delta / num_classes
    else:
        label_target = y_true[..., 5:-1]
    class_loss = torch.sum(object_mask * sigmoid_bce(prob_logits, label_target)
                           * mix_w) / n
    return xy_loss, wh_loss, conf_loss, class_loss


def compute_loss(feature_maps: Sequence[torch.Tensor],
                 y_true: Sequence[torch.Tensor], anchors: np.ndarray,
                 num_classes: int, img_size: Tuple[int, int], *,
                 use_label_smooth: bool = False, use_focal_loss: bool = False,
                 max_gt: int = 64, box_loss: str = "reference"
                 ) -> Dict[str, torch.Tensor]:
    """Total loss over the 3 scales (strides 32, 16, 8 with anchors [6:9],
    [3:6], [0:3]). Returns {"total", "xy", "wh", "conf", "class"} fp32
    scalars."""
    anchors = np.asarray(anchors, np.float32)
    groups = [anchors[6:9], anchors[3:6], anchors[0:3]]
    terms = None
    for fmap, yt, group in zip(feature_maps, y_true, groups):
        out = loss_scale(fmap, yt, group, num_classes, img_size,
                         use_label_smooth=use_label_smooth,
                         use_focal_loss=use_focal_loss, max_gt=max_gt,
                         box_loss=box_loss)
        terms = out if terms is None else [t + o for t, o in zip(terms, out)]
    xy, wh, conf, cls = terms
    return {"total": xy + wh + conf + cls, "xy": xy, "wh": wh,
            "conf": conf, "class": cls}


def l2_regularization(params: Dict[str, dict], weight_decay: float
                      ) -> torch.Tensor:
    """weight_decay * 0.5 * sum ||w||^2 over every conv kernel ("w" leaf of
    every conv, the detection convs included); no bias and no BN
    parameter."""
    total = None
    for scope in params.values():
        for p in scope.values():
            sq = torch.sum(torch.square(p["w"]))
            total = sq if total is None else total + sq
    return weight_decay * 0.5 * total
