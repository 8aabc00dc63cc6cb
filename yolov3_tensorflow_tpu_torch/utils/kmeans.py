"""Anchor selection via IoU k-means over GT box sizes, copied from the JAX
package's `utils/kmeans.py` (host numpy only; a test holds the copy equal to
its original): 1-IoU distance on (w, h) pairs, median centroid update, Forgy
init, boxes optionally pre-scaled by the letterbox ratio to the target
training resolution, final anchors sorted by area. Vectorized and seeded.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


def wh_iou(boxes: np.ndarray, clusters: np.ndarray) -> np.ndarray:
    """IoU of origin-anchored (w, h) boxes vs clusters: [N, 2]x[K, 2]->[N, K]."""
    inter = (np.minimum(boxes[:, None, 0], clusters[None, :, 0])
             * np.minimum(boxes[:, None, 1], clusters[None, :, 1]))
    union = (boxes[:, 0] * boxes[:, 1])[:, None] \
        + (clusters[:, 0] * clusters[:, 1])[None, :] - inter
    return inter / (union + 1e-10)


def kmeans_anchors(boxes: np.ndarray, k: int = 9, seed: int = 0,
                   max_iters: int = 1000) -> Tuple[np.ndarray, float]:
    """Run IoU k-means; returns (anchors [k, 2] sorted by area, avg IoU)."""
    boxes = np.asarray(boxes, np.float64)
    if np.any(boxes <= 0):
        raise ValueError("all boxes must have positive width and height")
    rng = np.random.default_rng(seed)
    clusters = boxes[rng.choice(len(boxes), k, replace=False)]
    last = np.full(len(boxes), -1)

    for _ in range(max_iters):
        nearest = np.argmax(wh_iou(boxes, clusters), axis=1)
        if (nearest == last).all():
            break
        for c in range(k):
            members = boxes[nearest == c]
            if len(members):
                clusters[c] = np.median(members, axis=0)
        last = nearest

    avg_iou = float(np.mean(np.max(wh_iou(boxes, clusters), axis=1)))
    order = np.argsort(clusters[:, 0] * clusters[:, 1])
    return clusters[order], avg_iou


def parse_annotation_sizes(annotation_path: str,
                           target_size: Optional[Tuple[int, int]] = None
                           ) -> np.ndarray:
    """Collect GT (w, h) pairs, optionally letterbox-scaled to target_size
    (width, height)."""
    result: List[List[float]] = []
    with open(annotation_path) as f:
        for line in f:
            fields = line.strip().split(" ")
            if len(fields) < 9:
                continue
            img_w, img_h = int(fields[2]), int(fields[3])
            rest = fields[4:]
            ratio = (min(target_size[0] / img_w, target_size[1] / img_h)
                     if target_size else 1.0)
            for i in range(len(rest) // 5):
                x0, y0, x1, y1 = (float(v) for v in rest[i * 5 + 1:i * 5 + 5])
                w, h = (x1 - x0) * ratio, (y1 - y0) * ratio
                if w <= 0 or h <= 0:
                    raise ValueError(
                        f"degenerate box in {annotation_path}: {line[:60]!r}")
                result.append([w, h])
    return np.asarray(result)


def anchors_to_string(anchors: np.ndarray) -> str:
    """'w,h, w,h, ...' format of an anchors file (assets/yolo_anchors.txt)."""
    return ", ".join(f"{int(w)},{int(h)}" for w, h in anchors)
