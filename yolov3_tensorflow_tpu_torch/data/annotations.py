"""Flat-text annotation format parsing, copied from the JAX package's
`data/annotations.py` (a test holds the copy equal to its original).

Line format:
    index img_path img_width img_height [label x_min y_min x_max y_max]*
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np


@dataclass
class Annotation:
    index: int
    path: str
    width: int
    height: int
    boxes: np.ndarray   # [N, 4] float32 xyxy in original pixels
    labels: np.ndarray  # [N] int64


def parse_line(line: str) -> Annotation:
    """Parse one annotation line.

    Requires at least one box per image: images without objects should be
    filtered upstream.
    """
    if isinstance(line, bytes):
        line = line.decode()
    fields = line.strip().split(" ")
    if len(fields) < 9:
        raise ValueError(
            "annotation error: every line needs at least one target object "
            f"(got {len(fields)} fields): {line[:80]!r}")
    index = int(fields[0])
    path = fields[1]
    width, height = int(fields[2]), int(fields[3])
    rest = fields[4:]
    if len(rest) % 5 != 0:
        raise ValueError(
            f"annotation error: box fields not a multiple of 5: {line[:80]!r}")
    n = len(rest) // 5
    boxes = np.empty((n, 4), np.float32)
    labels = np.empty((n,), np.int64)
    for i in range(n):
        labels[i] = int(rest[i * 5])
        boxes[i] = [float(v) for v in rest[i * 5 + 1:i * 5 + 5]]
    return Annotation(index, path, width, height, boxes, labels)


def read_annotation_file(path: str) -> List[str]:
    """Read all non-empty annotation lines (the loader shuffles them in
    memory with an explicit PRNG)."""
    with open(path) as f:
        return [ln for ln in (l.strip() for l in f) if ln]
