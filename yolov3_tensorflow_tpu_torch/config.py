"""Model constants and the anchor and class-name file readers, copied from
the JAX package's `config.py` (importing it would pull in the JAX package;
a test holds each copy equal to its original)."""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

# Canonical COCO YOLOv3 anchors (w, h) at 416x416, from the YOLOv3 paper.
DEFAULT_ANCHORS: Tuple[Tuple[float, float], ...] = (
    (10, 13), (16, 30), (33, 23),
    (30, 61), (62, 45), (59, 119),
    (116, 90), (156, 198), (373, 326),
)


def parse_anchors(anchor_path: str) -> np.ndarray:
    """Parse a comma-separated anchor file into a float32 [N, 2] array."""
    with open(anchor_path) as f:
        vals = [float(v) for v in f.read().replace("\n", " ").split(",")
                if v.strip()]
    return np.asarray(vals, np.float32).reshape(-1, 2)


def read_class_names(class_name_path: str) -> Dict[int, str]:
    """Read a one-class-per-line names file into {id: name}."""
    names: Dict[int, str] = {}
    with open(class_name_path) as f:
        for idx, line in enumerate(f):
            names[idx] = line.strip("\n")
    return names
