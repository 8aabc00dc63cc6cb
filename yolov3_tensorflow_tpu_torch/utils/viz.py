"""Detection drawing, host cv2 code copied from the JAX package's
`utils/viz.py` (a test holds the copies pixel-equal): a deterministic
golden-angle HSV palette, luminance-aware label text, and label tags that
stay inside the frame."""

from __future__ import annotations

import colorsys
from typing import Dict, List, Optional, Sequence

import cv2
import numpy as np


def get_color_table(class_num: int, seed: int = 2) -> Dict[int, List[int]]:
    """Deterministic, well-separated BGR color per class.

    Hues advance by the golden angle so neighbouring class ids get visually
    distant colors; saturation/value alternate over small cycles to separate
    ids further once the hue wheel wraps. `seed` rotates the wheel.
    """
    table: Dict[int, List[int]] = {}
    golden = 0.6180339887498949
    for i in range(class_num):
        h = (seed * 0.137 + i * golden) % 1.0
        s = 0.65 + 0.35 * ((i // 2) % 2)
        v = 0.75 + 0.25 * (i % 2)
        r, g, b = colorsys.hsv_to_rgb(h, s, v)
        table[i] = [int(b * 255), int(g * 255), int(r * 255)]
    return table


def _text_color(bgr: Sequence[int]) -> List[int]:
    """Black on light tags, white on dark ones (ITU-R 601 luma)."""
    luma = 0.114 * bgr[0] + 0.587 * bgr[1] + 0.299 * bgr[2]
    return [0, 0, 0] if luma > 140 else [255, 255, 255]


def plot_one_box(img: np.ndarray, coord: Sequence[float],
                 label: Optional[str] = None,
                 color: Optional[Sequence[int]] = None,
                 line_thickness: Optional[int] = None) -> None:
    """Draw one xyxy box (+ optional label tag) in place. The tag is
    clamped into the frame instead of being clipped when the box touches
    the top edge."""
    h, w = img.shape[:2]
    thick = line_thickness or max(round((h + w) / 1000), 1)
    if color is None:
        color = [80, 200, 80]
    x0, y0 = int(round(coord[0])), int(round(coord[1]))
    x1, y1 = int(round(coord[2])), int(round(coord[3]))
    cv2.rectangle(img, (x0, y0), (x1, y1), list(color), thickness=thick)
    if not label:
        return
    font_scale = max(thick / 3.0, 0.4)
    font_thick = max(thick - 1, 1)
    (tw, th), baseline = cv2.getTextSize(
        label, cv2.FONT_HERSHEY_SIMPLEX, font_scale, font_thick)
    tag_h = th + baseline + 2
    # tag above the box when it fits, inside the box otherwise
    ty0 = y0 - tag_h if y0 - tag_h >= 0 else y0
    cv2.rectangle(img, (x0, ty0), (min(x0 + tw + 2, w - 1), ty0 + tag_h),
                  list(color), -1)
    cv2.putText(img, label, (x0 + 1, ty0 + th + 1),
                cv2.FONT_HERSHEY_SIMPLEX, font_scale, _text_color(color),
                thickness=font_thick, lineType=cv2.LINE_AA)


def draw_detections(img: np.ndarray, boxes: np.ndarray, scores: np.ndarray,
                    labels: np.ndarray, class_names: Dict[int, str],
                    color_table: Optional[Dict[int, List[int]]] = None
                    ) -> np.ndarray:
    """Draw a whole detection set in place and return the image."""
    if color_table is None:
        color_table = get_color_table(max(len(class_names), 1))
    for box, score, label in zip(boxes, scores, labels):
        name = class_names.get(int(label), str(int(label)))
        plot_one_box(img, box, label=f"{name}: {float(score) * 100:.0f}%",
                     color=color_table.get(int(label)))
    return img
