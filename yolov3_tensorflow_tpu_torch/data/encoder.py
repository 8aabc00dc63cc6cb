"""Ground-truth label encoding into dense fixed-shape y_true grids, copied
from the JAX package's `data/encoder.py` (a test holds the copy equal to its
original), with the padded ground truth of the device-encode mode
(`pad_ground_truth`).

Each GT box is assigned to its best-IoU anchor among all 9 (width/height-only IoU centered at
the origin), which selects both the scale (stride 32/16/8) and the anchor slot
within that scale; the box is written into the owning grid cell.

y_true[scale] shape: [H/stride, W/stride, 3, 6+C] with channels
  0:4  (cx, cy, w, h) in input pixels
  4    objectness
  5:5+C one-hot class
  -1   per-box mixup weight (grid default 1.0)

Cell indices are clipped to the grid, so a box center exactly on the
right/bottom edge cannot index out of range.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

# anchor index -> (scale index, stride); scale 0 = stride 32 (13x13 @ 416)
_ANCHOR_GROUPS = [[6, 7, 8], [3, 4, 5], [0, 1, 2]]
_STRIDES = [32, 16, 8]


def anchor_iou(box_wh: np.ndarray, anchors: np.ndarray) -> np.ndarray:
    """Width/height-only IoU of boxes vs anchors, both centered at origin.

    box_wh: [N, 2]; anchors: [9, 2] -> [N, 9].
    """
    wh = np.minimum(box_wh[:, None, :], anchors[None, :, :])
    inter = wh[..., 0] * wh[..., 1]
    union = (box_wh[:, None, 0] * box_wh[:, None, 1]
             + anchors[:, 0] * anchors[:, 1] - inter)
    return inter / (union + 1e-10)


def encode_labels(boxes: np.ndarray, labels: np.ndarray,
                  img_size: Tuple[int, int], num_classes: int,
                  anchors: np.ndarray) -> List[np.ndarray]:
    """Encode GT boxes into the 3 dense label grids.

    boxes: [N, 4] or [N, 5] xyxy (+ optional mixup weight column).
    labels: [N] int. img_size: (width, height).
    Returns [y_true_s32, y_true_s16, y_true_s8].
    """
    w_img, h_img = img_size
    anchors = np.asarray(anchors, np.float32)

    y_true = [
        np.zeros((h_img // s, w_img // s, 3, 6 + num_classes), np.float32)
        for s in _STRIDES
    ]
    for yt in y_true:
        yt[..., -1] = 1.0

    if boxes.shape[0] == 0:
        return y_true

    mix_w = boxes[:, 4] if boxes.shape[1] > 4 else np.ones(len(boxes), np.float32)
    centers = (boxes[:, 0:2] + boxes[:, 2:4]) / 2
    sizes = boxes[:, 2:4] - boxes[:, 0:2]

    best = np.argmax(anchor_iou(sizes, anchors), axis=1)

    for i, a_idx in enumerate(best):
        scale = 2 - a_idx // 3                 # 6,7,8 -> 0; 3,4,5 -> 1; 0,1,2 -> 2
        stride = _STRIDES[scale]
        grid = y_true[scale]
        x = min(int(centers[i, 0] // stride), grid.shape[1] - 1)
        y = min(int(centers[i, 1] // stride), grid.shape[0] - 1)
        k = _ANCHOR_GROUPS[scale].index(a_idx)
        c = int(labels[i])

        grid[y, x, k, 0:2] = centers[i]
        grid[y, x, k, 2:4] = sizes[i]
        grid[y, x, k, 4] = 1.0
        grid[y, x, k, 5 + c] = 1.0
        grid[y, x, k, -1] = mix_w[i]
    return y_true


def pad_ground_truth(boxes: np.ndarray, labels: np.ndarray, max_boxes: int
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pad ragged GT to fixed [max_boxes] arrays + validity mask (the
    device-encode mode needs static shapes). Extra boxes beyond max_boxes
    are dropped deterministically (largest-area first retained)."""
    n = boxes.shape[0]
    if n > max_boxes:
        areas = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
        keep = np.argsort(-areas, kind="stable")[:max_boxes]
        boxes, labels = boxes[keep], labels[keep]
        n = max_boxes
    out_boxes = np.zeros((max_boxes, boxes.shape[1]), np.float32)
    out_labels = np.zeros((max_boxes,), np.int32)
    mask = np.zeros((max_boxes,), bool)
    out_boxes[:n] = boxes
    out_labels[:n] = labels
    mask[:n] = True
    return out_boxes, out_labels, mask
