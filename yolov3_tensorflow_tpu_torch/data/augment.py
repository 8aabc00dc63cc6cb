"""Image + box augmentation ops (numpy/cv2, host side), copied from the JAX
package's `data/augment.py` (tests hold the copy byte-equal to its original
on seeded inputs): mixup, SSD-style constrained random crop, photometric
jitter, letterbox/plain resize, flips, random expansion. Every stochastic op
takes an explicit `np.random.Generator`, so the loader's threads draw from
their own streams.

Boxes are [N, 4+] float arrays: xyxy in pixels; columns beyond 4 (e.g. the
mixup weight) ride along untouched by geometric transforms.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import cv2
import numpy as np


# ---------------------------------------------------------------------------
# mixup
# ---------------------------------------------------------------------------

def sample_mixup_lam(rng: np.random.Generator) -> float:
    """Blend factor ~ Beta(1.5, 1.5), clipped to [0, 1]."""
    return float(np.clip(rng.beta(1.5, 1.5), 0.0, 1.0))


def mixup_boxes(boxes1: np.ndarray, boxes2: np.ndarray, lam: float
                ) -> np.ndarray:
    """Union the two box sets with the per-box mixup weight appended."""

    def with_weight(b: np.ndarray, wt: float) -> np.ndarray:
        col = np.full((b.shape[0], 1), wt, b.dtype)
        return np.concatenate([b, col], axis=-1)

    return np.concatenate(
        [with_weight(boxes1, lam), with_weight(boxes2, 1 - lam)], axis=0)


def mix_up(img1: np.ndarray, img2: np.ndarray, boxes1: np.ndarray,
           boxes2: np.ndarray, rng: np.random.Generator
           ) -> Tuple[np.ndarray, np.ndarray]:
    """Pixel-blend two images on a max-size canvas; boxes gain a weight col.

    Blend factor ~ Beta(1.5, 1.5). Returns (uint8 image, [N1+N2, 5] boxes with per-box mixup weight appended).
    """
    h = max(img1.shape[0], img2.shape[0])
    w = max(img1.shape[1], img2.shape[1])
    lam = sample_mixup_lam(rng)

    canvas = np.zeros((h, w, 3), np.float32)
    canvas[:img1.shape[0], :img1.shape[1]] = img1.astype(np.float32) * lam
    canvas[:img2.shape[0], :img2.shape[1]] += img2.astype(np.float32) * (1 - lam)
    return canvas.astype(np.uint8), mixup_boxes(boxes1, boxes2, lam)


# ---------------------------------------------------------------------------
# cropping
# ---------------------------------------------------------------------------

def crop_boxes(boxes: np.ndarray, crop: Tuple[int, int, int, int],
               require_center_inside: bool = True,
               return_mask: bool = False):
    """Clip boxes to a crop window (x, y, w, h) and translate to its origin.

    Drops boxes whose center falls outside (when required) or that collapse
    to zero area. return_mask=True also returns the keep mask so per-box
    side arrays (labels) can be filtered in sync.
    """
    x0, y0, cw, ch = crop
    out = boxes.copy()
    window = np.array([x0, y0, x0 + cw, y0 + ch], np.float64)

    if require_center_inside:
        centers = (out[:, 0:2] + out[:, 2:4]) / 2
        keep = np.logical_and(window[0:2] <= centers,
                              centers < window[2:4]).all(axis=1)
    else:
        keep = np.ones(out.shape[0], bool)

    out[:, 0:2] = np.maximum(out[:, 0:2], window[0:2])
    out[:, 2:4] = np.minimum(out[:, 2:4], window[2:4])
    out[:, 0:2] -= window[0:2]
    out[:, 2:4] -= window[0:2]
    keep &= (out[:, 0:2] < out[:, 2:4]).all(axis=1)
    if return_mask:
        return out[keep], keep
    return out[keep]


def random_crop_with_constraints(
        boxes: np.ndarray, size: Tuple[int, int], rng: np.random.Generator,
        min_scale: float = 0.3, max_scale: float = 1.0,
        max_aspect_ratio: float = 2.0,
        constraints: Optional[Sequence[Tuple[Optional[float], Optional[float]]]] = None,
        max_trial: int = 50, labels: Optional[np.ndarray] = None):
    """SSD-paper min/max-IoU constrained random crop sampler.

    For each IoU constraint, try up to `max_trial` windows and keep the first satisfying
    one as a candidate; then pick candidates at random until one retains at
    least one box. Returns (cropped boxes, (x, y, w, h)) — or with `labels`
    given, (cropped boxes, surviving labels, (x, y, w, h)): the labels are
    filtered with the same keep mask (see `crop_boxes`). The PRNG stream is
    identical with or without `labels`.

    The trial loop is vectorized: all `max_trial` windows of a constraint
    are drawn in four batched PRNG calls and scored with one [T, N] IoU,
    then the FIRST satisfying trial is selected: the distribution of a
    sequential trial loop (trials are iid and acceptance is first-hit) at
    ~1/max_trial the Python cost.
    """
    if constraints is None:
        constraints = ((0.1, None), (0.3, None), (0.5, None), (0.7, None),
                       (0.9, None), (None, 1.0))
    w, h = size
    candidates = [(0, 0, w, h)]

    # all K*T trial windows in four batched PRNG calls + one [K*T, N] IoU
    k = len(constraints)
    n_tr = k * max_trial
    scales = rng.uniform(min_scale, max_scale, n_tr)
    ars = rng.uniform(np.maximum(1 / max_aspect_ratio, scales * scales),
                      np.minimum(max_aspect_ratio, 1 / (scales * scales)))
    chs = (h * scales / np.sqrt(ars)).astype(np.int64)
    cws = (w * scales * np.sqrt(ars)).astype(np.int64)
    cys = rng.integers(0, np.maximum(h - chs, 1))
    cxs = rng.integers(0, np.maximum(w - cws, 1))

    if len(boxes) == 0:
        # with no boxes the first trial window of the first constraint is
        # returned unconditionally
        cx, cy, cw, ch = int(cxs[0]), int(cys[0]), int(cws[0]), int(chs[0])
        if labels is not None:
            return boxes, labels, (cx, cy, cw, ch)
        return boxes, (cx, cy, cw, ch)

    tl = np.maximum(boxes[None, :, 0:2],
                    np.stack([cxs, cys], 1)[:, None, :])
    br = np.minimum(boxes[None, :, 2:4],
                    np.stack([cxs + cws, cys + chs], 1)[:, None, :])
    wh_i = np.clip(br - tl, 0, None)
    inter = wh_i[..., 0] * wh_i[..., 1]                   # [K*T, N]
    area_b = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    area_w = (cws * chs).astype(np.float64)
    iou = inter / (area_b[None, :] + area_w[:, None] - inter)
    iou_min = iou.min(axis=1).reshape(k, max_trial)
    iou_max = iou.max(axis=1).reshape(k, max_trial)

    for ci, (lo, hi) in enumerate(constraints):
        lo = -np.inf if lo is None else lo
        hi = np.inf if hi is None else hi
        ok = (lo <= iou_min[ci]) & (iou_max[ci] <= hi)
        if ok.any():
            t = ci * max_trial + int(np.argmax(ok))       # first hit
            candidates.append((int(cxs[t]), int(cys[t]),
                               int(cws[t]), int(chs[t])))

    order = list(range(len(candidates)))
    while order:
        pick = order.pop(int(rng.integers(0, len(order))))
        crop = candidates[pick]
        new_boxes, keep = crop_boxes(boxes, crop, require_center_inside=True,
                                     return_mask=True)
        if new_boxes.size:
            if labels is not None:
                return new_boxes, labels[keep], crop
            return new_boxes, crop
    if labels is not None:
        return boxes, labels, (0, 0, w, h)
    return boxes, (0, 0, w, h)


# ---------------------------------------------------------------------------
# photometric
# ---------------------------------------------------------------------------

@dataclass
class ColorDistortParams:
    """Effective photometric jitter parameters (identity when delta=0,
    hue_delta=0, sat_mult=1, val_mult=1). The three HSV jitters act on
    disjoint channels, so storing them order-free is exact."""
    delta: float = 0.0
    hue_delta: float = 0.0
    sat_mult: float = 1.0
    val_mult: float = 1.0


def sample_color_distort(rng: np.random.Generator,
                         brightness_delta: int = 32, hue_vari: int = 18,
                         sat_vari: float = 0.5, val_vari: float = 0.5
                         ) -> ColorDistortParams:
    """Draw the photometric jitter parameters.

    Consumes the PRNG stream in a fixed order (brightness gate, brightness
    value, H/S/V-order pick, then per-jitter gate+value in application
    order).
    """
    p = ColorDistortParams()
    if rng.uniform() > 0.5:
        p.delta = float(int(rng.uniform(-brightness_delta, brightness_delta)))
    order = int(rng.integers(0, 2))
    seq = ("val", "sat", "hue") if order else ("sat", "hue", "val")
    for name in seq:
        if name == "hue":
            if rng.uniform() > 0.5:
                p.hue_delta = float(rng.integers(-hue_vari, hue_vari))
        elif name == "sat":
            if rng.uniform() > 0.5:
                p.sat_mult = 1.0 + float(rng.uniform(-sat_vari, sat_vari))
        else:
            if rng.uniform() > 0.5:
                p.val_mult = 1.0 + float(rng.uniform(-val_vari, val_vari))
    return p


def apply_color_distort(img: np.ndarray, p: ColorDistortParams) -> np.ndarray:
    """Apply sampled photometric jitter (host/cv2 path): brightness in BGR,
    then H/S/V jitter through cv2's uint8 HSV space."""
    if p.delta != 0.0:
        img = np.clip(img.astype(np.float32) + p.delta, 0, 255)
    img = img.astype(np.uint8)
    hsv = cv2.cvtColor(img, cv2.COLOR_BGR2HSV).astype(np.float32)
    if p.hue_delta != 0.0:
        hsv[:, :, 0] = (hsv[:, :, 0] + p.hue_delta) % 180
    if p.sat_mult != 1.0:
        hsv[:, :, 1] *= p.sat_mult
    if p.val_mult != 1.0:
        hsv[:, :, 2] *= p.val_mult
    hsv = np.clip(hsv, 0, 255)
    return cv2.cvtColor(hsv.astype(np.uint8), cv2.COLOR_HSV2BGR)


def random_color_distort(img: np.ndarray, rng: np.random.Generator,
                         brightness_delta: int = 32, hue_vari: int = 18,
                         sat_vari: float = 0.5, val_vari: float = 0.5
                         ) -> np.ndarray:
    """Brightness + HSV jitter, each applied with probability 0.5.

    Brightness in BGR space first, then hue/saturation/value in HSV, with the H/S/V application order itself
    randomized between two permutations (the order only affects PRNG
    consumption — the jitters touch disjoint HSV channels).
    """
    return apply_color_distort(
        img, sample_color_distort(rng, brightness_delta, hue_vari,
                                  sat_vari, val_vari))


# ---------------------------------------------------------------------------
# resizing
# ---------------------------------------------------------------------------

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


def remap_boxes_resize(boxes: np.ndarray, ow: int, oh: int, new_width: int,
                       new_height: int, letterbox: bool) -> np.ndarray:
    """Box-coordinate part of `resize_with_boxes`."""
    boxes = boxes.copy()
    if letterbox:
        ratio, _, _, dw, dh = letterbox_params(ow, oh, new_width, new_height)
        boxes[:, [0, 2]] = boxes[:, [0, 2]] * ratio + dw
        boxes[:, [1, 3]] = boxes[:, [1, 3]] * ratio + dh
    else:
        boxes[:, [0, 2]] *= new_width / ow
        boxes[:, [1, 3]] *= new_height / oh
    return boxes


def resize_with_boxes(img: np.ndarray, boxes: np.ndarray, new_width: int,
                      new_height: int, interp: int = 0,
                      letterbox: bool = False
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Resize image and remap boxes."""
    oh, ow = img.shape[:2]
    new_boxes = remap_boxes_resize(boxes, ow, oh, new_width, new_height,
                                   letterbox)
    if letterbox:
        out, _, _, _ = letterbox_resize(img, new_width, new_height, interp)
    else:
        out = cv2.resize(img, (new_width, new_height), interpolation=interp)
    return out, new_boxes


# ---------------------------------------------------------------------------
# geometric
# ---------------------------------------------------------------------------

def sample_flip(rng: np.random.Generator, px: float = 0.0, py: float = 0.0
                ) -> Tuple[bool, bool]:
    """Draw the (horizontal, vertical) flip decisions — two uniforms, always,
    matching the fused `random_flip` stream."""
    fx = bool(rng.uniform() < px)
    fy = bool(rng.uniform() < py)
    return fx, fy


def flip_boxes(boxes: np.ndarray, h: int, w: int, fx: bool, fy: bool
               ) -> np.ndarray:
    boxes = boxes.copy()
    if fx:
        boxes[:, [0, 2]] = w - boxes[:, [2, 0]]
    if fy:
        boxes[:, [1, 3]] = h - boxes[:, [3, 1]]
    return boxes


def random_flip(img: np.ndarray, boxes: np.ndarray, rng: np.random.Generator,
                px: float = 0.0, py: float = 0.0
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Horizontal/vertical flips with given probabilities."""
    h, w = img.shape[:2]
    fx, fy = sample_flip(rng, px, py)
    if fx:
        img = cv2.flip(img, 1)
    if fy:
        img = cv2.flip(img, 0)
    return img, flip_boxes(boxes, h, w, fx, fy)


def sample_expand(rng: np.random.Generator, h: int, w: int,
                  max_ratio: float = 4.0, keep_ratio: bool = True
                  ) -> Tuple[int, int, int, int]:
    """Draw the expansion canvas size and placement: (oh, ow, oy, ox).
    Stream-order matches the fused `random_expand` (rx, [ry], oy, ox)."""
    rx = rng.uniform(1, max_ratio)
    ry = rx if keep_ratio else rng.uniform(1, max_ratio)
    oh, ow = int(h * ry), int(w * rx)
    oy = int(rng.integers(0, max(oh - h, 1)))
    ox = int(rng.integers(0, max(ow - w, 1)))
    return oh, ow, oy, ox


def apply_expand(img: np.ndarray, boxes: np.ndarray, oh: int, ow: int,
                 oy: int, ox: int, fill: int = 0
                 ) -> Tuple[np.ndarray, np.ndarray]:
    boxes = boxes.copy()
    canvas = np.full((oh, ow, img.shape[2]), fill, img.dtype)
    canvas[oy:oy + img.shape[0], ox:ox + img.shape[1]] = img
    boxes[:, 0:4] += np.array([ox, oy, ox, oy], boxes.dtype)
    return canvas, boxes


def random_expand(img: np.ndarray, boxes: np.ndarray,
                  rng: np.random.Generator, max_ratio: float = 4.0,
                  fill: int = 0, keep_ratio: bool = True
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Place the image at a random offset on a larger canvas."""
    h, w = img.shape[:2]
    oh, ow, oy, ox = sample_expand(rng, h, w, max_ratio, keep_ratio)
    return apply_expand(img, boxes, oh, ow, oy, ox, fill)
