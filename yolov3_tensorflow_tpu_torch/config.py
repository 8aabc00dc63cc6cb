"""Model constants shared with the JAX package (which keeps them in its own
`config.py`; a test holds the two equal)."""

from __future__ import annotations

from typing import Tuple

# Canonical COCO YOLOv3 anchors (w, h) at 416x416, from the YOLOv3 paper.
DEFAULT_ANCHORS: Tuple[Tuple[float, float], ...] = (
    (10, 13), (16, 30), (33, 23),
    (30, 61), (62, 45), (59, 119),
    (116, 90), (156, 198), (373, 326),
)
