"""Deterministic synthetic detection dataset, copied from the JAX package's
`data/synthetic.py` (a test holds the copy byte-equal to its original).

Drawn shapes on a smooth background, with their boxes and labels in the
flat annotation format: the data of the training tests, of `chip_smoke.py`'s
training phase and of the overfit gate, none of which has a real dataset or
pretrained weights to use.

Shapes are sized 40-170 px at 416x416 so all three anchor scales receive
assignments, and per-image placements reject heavy overlap so the eval-side
greedy matcher is unambiguous.
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence, Tuple

import cv2
import numpy as np

SYNTH_CLASS_NAMES: Tuple[str, ...] = ("circle", "box", "triangle")

# base BGR color per class; jittered per shape so color alone is a cue but
# not a constant
_BASE_COLORS = np.asarray([
    (60, 60, 220),    # circle: red
    (80, 200, 80),    # box: green
    (220, 140, 40),   # triangle: blue
], np.float32)


def _background(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """Smooth gray gradient + mild noise (keeps shapes salient)."""
    base = rng.uniform(90, 165)
    gx = rng.uniform(-40, 40)
    gy = rng.uniform(-40, 40)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = base + gx * (xx / w - 0.5) + gy * (yy / h - 0.5)
    img = img[..., None] + rng.normal(0, 6, (h, w, 3)).astype(np.float32)
    return np.clip(img, 0, 255).astype(np.uint8)


def _iou_1v1(a: Sequence[float], b: Sequence[float]) -> float:
    ix = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
    iy = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = ix * iy
    ua = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
    return inter / max(ua, 1e-9)


def draw_example(rng: np.random.Generator,
                 img_size: Tuple[int, int] = (416, 416),
                 max_shapes: int = 3,
                 num_classes: int = 3
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One synthetic image.

    Returns (image BGR uint8 [H, W, 3], boxes float32 [N, 4] xyxy pixels,
    labels int64 [N]).
    """
    w, h = img_size
    img = _background(rng, h, w)
    n = int(rng.integers(1, max_shapes + 1))
    boxes: List[List[float]] = []
    labels: List[int] = []
    # shape sizes relative to the image so all anchor scales see assignments
    # at 416 (50-175 px) and small test sizes still fit (96 -> 12-40 px)
    m = min(w, h)
    size_lo, size_hi = max(12.0, 0.12 * m), max(24.0, 0.42 * m)
    for _ in range(n):
        for _attempt in range(40):
            label = int(rng.integers(0, num_classes))
            size = float(rng.uniform(size_lo, size_hi))
            cx = float(rng.uniform(size / 2 + 8, w - size / 2 - 8))
            cy = float(rng.uniform(size / 2 + 8, h - size / 2 - 8))
            box = [cx - size / 2, cy - size / 2, cx + size / 2, cy + size / 2]
            if any(_iou_1v1(box, b) > 0.1 for b in boxes):
                continue
            color = np.clip(
                _BASE_COLORS[label % len(_BASE_COLORS)]
                + rng.normal(0, 18, 3), 30, 255)
            color_t = tuple(int(c) for c in color)
            if label % 3 == 0:          # circle
                cv2.circle(img, (int(cx), int(cy)), int(size / 2), color_t, -1)
            elif label % 3 == 1:        # box
                cv2.rectangle(img, (int(box[0]), int(box[1])),
                              (int(box[2]), int(box[3])), color_t, -1)
            else:                       # triangle (tight to its bbox)
                pts = np.asarray([
                    (int(cx), int(box[1])),
                    (int(box[0]), int(box[3])),
                    (int(box[2]), int(box[3]))], np.int32)
                cv2.fillPoly(img, [pts], color_t)
            boxes.append(box)
            labels.append(label)
            break
    return img, np.asarray(boxes, np.float32), np.asarray(labels, np.int64)


def generate_dataset(out_dir: str, num_images: int = 50, seed: int = 0,
                     img_size: Tuple[int, int] = (416, 416),
                     max_shapes: int = 3, num_classes: int = 3,
                     prefix: str = "train") -> Dict[str, str]:
    """Write `num_images` jpgs + a flat annotation file + a names file.

    Deterministic in (seed, num_images, img_size). Returns paths:
    {"annotation_file", "names_file", "image_dir"}.
    """
    os.makedirs(out_dir, exist_ok=True)
    lines = []
    for i in range(num_images):
        rng = np.random.default_rng((seed, i))
        img, boxes, labels = draw_example(rng, img_size, max_shapes,
                                          num_classes)
        path = os.path.join(out_dir, f"{prefix}_{i:04d}.jpg")
        cv2.imwrite(path, img, [cv2.IMWRITE_JPEG_QUALITY, 95])
        fields = [str(i), path, str(img_size[0]), str(img_size[1])]
        for b, l in zip(boxes, labels):
            fields += [str(int(l))] + [f"{v:.1f}" for v in b]
        lines.append(" ".join(fields))
    ann_file = os.path.join(out_dir, f"{prefix}.txt")
    with open(ann_file, "w") as f:
        f.write("\n".join(lines) + "\n")
    names_file = os.path.join(out_dir, "synth.names")
    with open(names_file, "w") as f:
        f.write("\n".join(SYNTH_CLASS_NAMES[:num_classes]) + "\n")
    return {"annotation_file": ann_file, "names_file": names_file,
            "image_dir": out_dir}
