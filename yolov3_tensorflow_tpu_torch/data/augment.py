"""The host letterbox resize, copied from the JAX package's
`data/augment.py` (a test holds the copy byte-equal). The rest of that
module belongs to training and is not ported yet."""

from __future__ import annotations

from typing import Tuple

import cv2
import numpy as np


def letterbox_params(ow: int, oh: int, new_width: int, new_height: int
                     ) -> Tuple[float, int, int, int, int]:
    """Letterbox geometry for an (ow, oh) image into (new_width, new_height):
    returns (ratio, rw, rh, dw, dh) — the content rectangle is
    [dw, dw+rw) x [dh, dh+rh)."""
    ratio = min(new_width / ow, new_height / oh)
    rw, rh = int(ratio * ow), int(ratio * oh)
    dw = (new_width - rw) // 2
    dh = (new_height - rh) // 2
    return ratio, rw, rh, dw, dh


def letterbox_resize(img: np.ndarray, new_width: int, new_height: int,
                     interp: int = 0
                     ) -> Tuple[np.ndarray, float, int, int]:
    """Aspect-preserving resize onto a gray-128 canvas.

    Returns (padded image, resize_ratio, dw, dh): the inverse transform of
    a box is (box - (dw, dh)) / ratio.
    """
    oh, ow = img.shape[:2]
    ratio, rw, rh, dw, dh = letterbox_params(ow, oh, new_width, new_height)
    resized = cv2.resize(img, (rw, rh), interpolation=interp)
    canvas = np.full((new_height, new_width, 3), 128, np.uint8)
    canvas[dh:dh + rh, dw:dw + rw] = resized
    return canvas, ratio, dw, dh
