"""Quick batch-level recall/precision + running meters, copied from the JAX
package's `evaluation/metrics.py` (a test holds the copy equal to its
original). NMS results arrive as the fixed-shape output of
`ops.nms.batched_nms_auto`, converted to numpy; matching happens on the
host. The pairwise IoU prefers the host library (`utils/native.py`, built
at first use) where it builds and loads, and falls back to numpy, as the
JAX package routes it; the two give the same bits.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from yolov3_tensorflow_tpu_torch.utils import native


class AverageMeter:
    """Running mean."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0
        self.average = 0.0

    def update(self, val: float, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.average = self.sum / float(self.count)


def extract_gt_from_y_true(y_true: Sequence[np.ndarray], image_index: int
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """Recover (boxes xyxy, labels) of one image from its 3 dense label
    grids."""
    boxes_list, labels_list = [], []
    for grid in y_true:
        g = grid[image_index]
        probs = g[..., 5:-1]
        mask = probs.sum(axis=-1) > 0
        if not mask.any():
            continue
        boxes_list.append(g[..., 0:4][mask])
        labels_list.append(np.argmax(probs[mask], axis=-1))
    if not boxes_list:
        return np.zeros((0, 4), np.float32), np.zeros((0,), np.int64)
    centers_sizes = np.concatenate(boxes_list)
    labels = np.concatenate(labels_list)
    half = centers_sizes[:, 2:4] / 2.0
    boxes = np.concatenate(
        [centers_sizes[:, 0:2] - half, centers_sizes[:, 0:2] + half], axis=1)
    return boxes.astype(np.float32), labels


def iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise corner-format IoU [N, V] in float32: the host library's
    where it builds and loads here (at the in-train evaluation's shapes on
    the H100 host it takes a fifth of numpy's time), else `_iou_matrix`."""
    if native.available():
        return native.iou_matrix(a, b)
    return _iou_matrix(a, b)


def _iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise corner-format IoU [N, V] in float32, in numpy."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    tl = np.maximum(a[:, None, 0:2], b[None, :, 0:2])
    br = np.minimum(a[:, None, 2:4], b[None, :, 2:4])
    wh = np.clip(br - tl, 0.0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / (area_a[:, None] + area_b[None, :] - inter + 1e-10)


def match_detections(pred_boxes: np.ndarray, pred_scores: np.ndarray,
                     pred_labels: np.ndarray, true_boxes: np.ndarray,
                     true_labels: np.ndarray, iou_thresh: float = 0.5
                     ) -> int:
    """Count true positives with per-GT confidence dedup (a GT already
    matched is re-assigned only to a higher-confidence detection)."""
    if len(pred_boxes) == 0 or len(true_boxes) == 0:
        return 0
    iou = iou_matrix(pred_boxes, true_boxes)
    best_gt = np.argmax(iou, axis=1)

    matched: Dict[int, float] = {}  # gt index -> confidence
    for k in range(len(pred_boxes)):
        j = int(best_gt[k])
        if iou[k, j] > iou_thresh and int(true_labels[j]) == int(pred_labels[k]):
            if j not in matched or pred_scores[k] > matched[j]:
                matched[j] = float(pred_scores[k])
    return len(matched)


def evaluate_batch(dets: Dict[str, np.ndarray],
                   y_true: Optional[Sequence[np.ndarray]], num_classes: int,
                   iou_thresh: float = 0.5,
                   gt: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]
                   = None) -> Tuple[float, float]:
    """Batch recall/precision from fixed-shape NMS output (the in-training
    evaluation).

    dets: numpy-converted output of ops.nms.batched_nms_auto
          ({"boxes" [B,M,4], "scores", "labels", "valid"}).
    y_true: the 3 label grids, each [B, H, W, 3, 6+C], or None with
    gt=(boxes [B,M,5] xyxy, labels [B,M], mask [B,M]) in the loader's
    device-encode mode, where the padded ground truth is the ground truth
    and no grid occupancy scan is needed.
    """
    batch = (y_true[0] if y_true is not None else gt[0]).shape[0]
    tp_total, gt_total, pred_total = 0, 0, 0
    for i in range(batch):
        if y_true is None:
            m = gt[2][i].astype(bool)
            true_boxes = gt[0][i][m, 0:4].astype(np.float32)
            true_labels = gt[1][i][m]
        else:
            true_boxes, true_labels = extract_gt_from_y_true(y_true, i)
        gt_total += len(true_boxes)
        valid = dets["valid"][i].astype(bool)
        pred_total += int(valid.sum())
        tp_total += match_detections(
            dets["boxes"][i][valid], dets["scores"][i][valid],
            dets["labels"][i][valid], true_boxes, true_labels, iou_thresh)
    recall = tp_total / (gt_total + 1e-6)
    precision = tp_total / (pred_total + 1e-6)
    return recall, precision


def detections_to_pred_rows(dets: Dict[str, np.ndarray],
                            image_ids: np.ndarray) -> List[List[float]]:
    """Flatten a batch of NMS outputs into voc_eval prediction rows
    [img_id, x0, y0, x1, y1, score, label]."""
    rows: List[List[float]] = []
    for i, img_id in enumerate(np.asarray(image_ids).tolist()):
        valid = dets["valid"][i].astype(bool)
        boxes = dets["boxes"][i][valid]
        scores = dets["scores"][i][valid]
        labels = dets["labels"][i][valid]
        for b, s, l in zip(boxes, scores, labels):
            rows.append([img_id, float(b[0]), float(b[1]), float(b[2]),
                         float(b[3]), float(s), int(l)])
    return rows
