"""Training augmentation on the device (counterpart of
`yolov3_tensorflow_tpu/data/device_augment.py`): the host decodes the
JPEGs and draws every random number, the device does the pixels.

- host (`loader.plan_example`): image decode, all random draws (the same
  sampler functions as the host path, so a fixed (seed, epoch, step, slot)
  key gives the same transform in both modes), all box geometry, and the
  zero-padded staging of the decoded uint8 BGR pixels into a static
  [S, S, 3] tile. `ExamplePlan`, `stage_image` and `pack_plans` are copies
  of the JAX package's (a test holds them equal).
- device (`augment_batch`): mixup blend, colour distortion (cv2's uint8 HSV
  arithmetic in fp32), and the whole geometric chain (expand -> crop ->
  resize or letterbox -> flip) as one separable resampling: two batched
  matrix products per batch, `out = Wy @ src @ Wx^T` per image.

Every cv2 interpolation the host path draws (nearest, linear, cubic, area,
lanczos4) is separable, so resize(crop) is
  out[y, x] = sum_v Wy[y, v] * sum_u Wx[x, u] * src[v, u]
with [out, S] weight matrices built from the crop window and cv2's sampling
conventions (nearest without a centre offset, taps clamped at the crop
border). Out-of-crop samples (the random_expand canvas) contribute zeros;
the letterbox pad is set to 128 afterwards.

Neither the batch nor the interpolation codes are looped over in Python,
and both axes are built in one pass over their rows: each example carries
its own interpolation code, so every kernel's weights (nearest, linear,
cubic, area's two-tap form, lanczos4) are computed at the eight tap offsets
-3..4 of lanczos4, zero off the kernel's support, for the whole batch, and
each example's are selected by its code; area's box filter (both axes
downscaling) is a dense overlap matrix selected the same way. The number
of operations the host dispatches is thus fixed, whatever the batch holds
(a test holds `augment_batch` below 450). The taps are added into the
weight matrix one offset at a time, in the JAX package's order (a zero tap
adds nothing), so the sums are deterministic. The sampling phases and the cubic polynomial round where
XLA's fused multiply-adds round them (`_fma`), so the weights equal the JAX
package's.

The two products run in float64: TF32, which a process may switch on for
float32 matrix products, never touches them, and the results are rounded to
integers, where TF32's 10-bit mantissa would move pixels across .5. (On an
H100 the float64 tensor-core rate equals the float32 CUDA-core rate.)
Against the JAX package's float32 products this moves a pixel only where
the exact sum lies within float32 rounding of .5 (the tests hold the
pixels to 1/255, and equal on at least 99.5% of them).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Host side: plan + staging (copied)
# ---------------------------------------------------------------------------


@dataclass
class ExamplePlan:
    """Everything the device needs to reproduce one example's augmentation."""
    staged: np.ndarray            # [S, S, 3] uint8 BGR, zero-padded
    staged2: Optional[np.ndarray]  # mixup partner tile (None when unpaired)
    lam: float                    # mixup blend factor (1.0 = no blend)
    color: Tuple[float, float, float, float]  # delta, hue, sat, val
    crop_x0: int                  # crop origin in source-image coords
    crop_y0: int                  # (can be negative / exceed the image when
    crop_w: int                   # the window covers random_expand canvas)
    crop_h: int
    rw: int                       # letterbox content rect (plain resize:
    rh: int                       # rw=W, rh=H, dw=dh=0)
    dw: int
    dh: int
    interp: int                   # cv2 interpolation code 0..4
    flip: bool                    # horizontal flip of the final image


def stage_image(img: np.ndarray, staged_size: int,
                boxes: Optional[np.ndarray] = None
                ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Zero-pad a decoded uint8 image into the static [S, S, 3] tile.

    Images with a side larger than S are first shrunk with one aspect-
    preserving cv2 resize (INTER_AREA) and their boxes rescaled — a
    documented deviation from the host path for oversized inputs; size S to
    the dataset to avoid it.
    """
    import cv2
    h, w = img.shape[:2]
    if max(h, w) > staged_size:
        r = staged_size / max(h, w)
        nw, nh = max(int(w * r), 1), max(int(h * r), 1)
        img = cv2.resize(img, (nw, nh), interpolation=cv2.INTER_AREA)
        if boxes is not None and boxes.size:
            boxes = boxes.copy()
            boxes[:, [0, 2]] *= nw / w
            boxes[:, [1, 3]] *= nh / h
        h, w = nh, nw
    tile = np.zeros((staged_size, staged_size, 3), np.uint8)
    tile[:h, :w] = img
    return tile, boxes


def pack_plans(plans) -> Dict[str, np.ndarray]:
    """Stack per-example plans into the loader batch's parameter arrays."""
    f32 = np.float32
    i32 = np.int32
    return {
        "lam": np.asarray([p.lam for p in plans], f32),
        "color": np.asarray([p.color for p in plans], f32),     # [B, 4]
        "crop": np.asarray([[p.crop_x0, p.crop_y0, p.crop_w, p.crop_h]
                            for p in plans], i32),              # [B, 4]
        "rect": np.asarray([[p.dw, p.dh, p.rw, p.rh]
                            for p in plans], i32),              # [B, 4]
        "interp": np.asarray([p.interp for p in plans], i32),
        "flip": np.asarray([1 if p.flip else 0 for p in plans], i32),
    }


# ---------------------------------------------------------------------------
# Device side: photometric ops (cv2 uint8-HSV arithmetic in fp32)
# ---------------------------------------------------------------------------


def _first_match(conds, values, default):
    """`jnp.select`: the value of the first condition that holds."""
    out = default
    for cond, value in zip(reversed(conds), reversed(values)):
        out = torch.where(cond, value, out)
    return out


def _bgr_to_hsv(x: torch.Tensor) -> torch.Tensor:
    """cv2 uint8 BGR->HSV semantics in fp32: H in [0,180), S,V in [0,255]."""
    b, g, r = x[..., 0], x[..., 1], x[..., 2]
    v = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    diff = v - mn
    safe = torch.where(diff > 0, diff, torch.ones_like(diff))
    s = torch.where(v > 0, torch.round(
        diff * 255.0 / torch.where(v > 0, v, torch.ones_like(v))),
        torch.zeros_like(v))
    h = torch.where(
        v == r, 60.0 * (g - b) / safe,
        torch.where(v == g, 120.0 + 60.0 * (b - r) / safe,
                    240.0 + 60.0 * (r - g) / safe))
    h = torch.where(diff > 0, h, torch.zeros_like(h))
    h = torch.where(h < 0, h + 360.0, h)
    return torch.stack([torch.round(h * 0.5), s, v], dim=-1)


def _hsv_to_bgr(x: torch.Tensor) -> torch.Tensor:
    """cv2 uint8 HSV->BGR semantics in fp32."""
    h, s, v = x[..., 0], x[..., 1], x[..., 2]
    # divisors as device tensors (filled there, not copied from the host):
    # CUDA turns a division by a Python number into a product with its
    # float32 reciprocal, which moves q and t across the .5 ties that the
    # CPU's true division rounds the other way
    h60 = h * 2.0 / h.new_full((), 60.0)
    i = torch.floor(h60)
    f = h60 - i
    i = torch.remainder(i.to(torch.int32), 6)
    sn = s / s.new_full((), 255.0)
    p = v * (1.0 - sn)
    q = v * (1.0 - sn * f)
    t = v * (1.0 - sn * (1.0 - f))
    conds = [i == 0, i == 1, i == 2, i == 3, i == 4]
    r = _first_match(conds, [v, q, p, p, t], v)
    g = _first_match(conds, [t, v, v, q, p], p)
    b = _first_match(conds, [p, p, t, v, v], q)
    return torch.round(torch.stack([b, g, r], dim=-1))


def _color_distort_device(x: torch.Tensor, color: torch.Tensor
                          ) -> torch.Tensor:
    """Per-image photometric jitter on [B,S,S,3] fp32 BGR in [0,255].

    color [B, 4] = (delta, hue_delta, sat_mult, val_mult); mirrors
    augment.apply_color_distort including its uint8 rounding points."""
    delta, hue, sat, val = (color[:, i].view(-1, 1, 1) for i in range(4))
    x = torch.floor(torch.clamp(x + delta[..., None], 0.0, 255.0))
    hsv = _bgr_to_hsv(x)
    h = torch.remainder(hsv[..., 0] + hue, 180.0)     # jnp.mod
    s = hsv[..., 1] * sat
    v = hsv[..., 2] * val
    hsv = torch.clamp(torch.stack([h, s, v], dim=-1), 0.0, 255.0)
    return _hsv_to_bgr(torch.floor(hsv))


# ---------------------------------------------------------------------------
# Device side: separable resampling weights (cv2 conventions)
# ---------------------------------------------------------------------------


def _fma(a, b, c) -> torch.Tensor:
    """a * b + c rounded once to float32, as the fused multiply-add that
    XLA compiles the JAX package's `a * b + c` into: the float64 product
    of two float32 values is exact (cv2 computes these phases in float64
    too)."""
    f64 = torch.float64
    a = a.to(f64) if isinstance(a, torch.Tensor) else a
    b = b.to(f64) if isinstance(b, torch.Tensor) else b
    return (a * b + c).to(torch.float32)


def _cubic(x: torch.Tensor) -> torch.Tensor:
    """cv2's bicubic kernel (A = -0.75) at distance x, zero from |x| = 2."""
    a = -0.75
    ax = torch.abs(x)
    near = _fma(_fma(a + 2.0, ax, -(a + 3.0)) * ax, ax, 1.0)
    far = _fma(_fma(_fma(a, ax, -5.0 * a), ax, 8.0 * a), ax, -4.0 * a)
    return torch.where(ax <= 1.0, near, torch.where(
        ax < 2.0, far, torch.zeros_like(ax)))


def _lanczos4(x: torch.Tensor) -> torch.Tensor:
    """cv2's Lanczos-4 weights at distances x [B, T, O] of the taps
    -3..4 (dim 1), normalized to sum 1 in tap order."""
    pix = math.pi * x
    out = torch.where(torch.abs(x) < 1e-7, torch.ones_like(x),
                      torch.sin(pix) * torch.sin(pix / 4.0)
                      / torch.clamp(pix * pix / 4.0, min=1e-30))
    out = torch.where(torch.abs(x) < 4.0, out, torch.zeros_like(x))
    tot = out[:, 0]
    for k in range(1, out.shape[1]):
        tot = tot + out[:, k]
    return out / tot[:, None]


def _tap_weights(frac: torch.Tensor, frac_area: torch.Tensor,
                 taps: torch.Tensor, code: torch.Tensor) -> torch.Tensor:
    """Each example's tap weights [B, T, O] at the tap offsets `taps`
    [T, 1] (-3..4, relative to floor(centre)), by its cv2 code [B, 1, 1];
    cv2 conventions, zero off each kernel's support:
      0 nearest  tap {0}
      1 linear   taps {0,1} at phase frac [B, 1, O]
      2 cubic    A=-0.75, taps {-1..2}
      3 area     (its 2-tap form) taps {0,1} at phase frac_area [B, 1, O]
      4 lanczos4 taps {-3..4}, weights normalized to sum 1
    """
    def two_tap(f):
        return torch.where(taps == 0, 1.0 - f,
                           torch.where(taps == 1, f, torch.zeros_like(f)))
    return _first_match(
        [code == 0, code == 1, code == 2, code == 3],
        [(taps == 0).to(frac.dtype), two_tap(frac), _cubic(frac - taps),
         two_tap(frac_area)], _lanczos4(frac - taps))


def _axis_weights(out_lens: Tuple[int, ...], s_len: int,
                  crop0: torch.Tensor, csz: torch.Tensor, rsz: torch.Tensor,
                  dpad: torch.Tensor, interp: torch.Tensor,
                  area_decimate: torch.Tensor
                  ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """The [B, out_len, s_len] resampling weight matrices of each axis, in
    one pass over the rows of all of them.

    crop0/csz [B, A]: per axis, the crop window origin (source coords, may
    be negative) and size; rsz/dpad [B, A]: resized content length and
    letterbox pad offset; out_lens: the A output lengths; interp [B]: cv2
    code; area_decimate [B]: INTER_AREA's box filter (both axes
    downscale). Rows outside the content rect are all-zero (masked to the
    letterbox fill later). Out-of-crop taps are edge-clamped (cv2 resize
    sees only the cropped array); clamped taps landing outside [0, s_len)
    carry zero weight (those samples are random_expand canvas zeros).
    Returns each axis's (weights, valid-row mask [B, out_len]).
    """
    dev = crop0.device
    f32, i64 = torch.float32, torch.int64

    def rows(p):         # [B, A] -> [B, O]: each axis's value on its rows
        return torch.cat([p[:, a:a + 1].expand(-1, n)
                          for a, n in enumerate(out_lens)], 1)

    crop0, csz = rows(crop0.to(i64)), rows(csz.to(i64))
    rszf, cszf = rows(rsz.to(f32)), csz.to(f32)
    d = torch.cat([torch.arange(n, dtype=f32, device=dev)
                   for n in out_lens]) - rows(dpad.to(f32))
    valid_row = (d >= 0) & (d < rszf)                          # [B, O]
    scale = cszf / torch.clamp(rszf, min=1.0)
    code = interp.to(i64).clamp(0, 4)[:, None, None]           # [B, 1, 1]

    # each example's first tap and phase: linear, cubic and lanczos4 at
    # (d + 0.5) * scale - 0.5; nearest at d * scale (no centre offset);
    # cv2 INTER_AREA when any axis upscales takes its generic path with
    # 2-tap "area" coefficients: s0 = floor(d*scale),
    # f = (d+1) - (s0+1)/scale, clipped to 0 when <= 0
    f = _fma(d + 0.5, scale, -0.5)
    s0 = torch.floor(f)
    s0_near = torch.floor(d * scale)
    inv_scale = rszf / torch.clamp(cszf, min=1.0)
    fa = _fma(-(s0_near + 1.0), inv_scale, d + 1.0)
    fa = torch.where(fa <= 0.0, torch.zeros_like(fa), fa - torch.floor(fa))
    taps = torch.arange(-3, 5, device=dev)[:, None]            # [T, 1]
    weight = _tap_weights((f - s0)[:, None], fa[:, None], taps.to(f32), code)
    s0 = torch.where((code[:, 0] == 0) | (code[:, 0] == 3), s0_near, s0)
    s = torch.minimum(torch.clamp(s0.to(i64)[:, None] + taps, min=0),
                      csz[:, None] - 1) + crop0[:, None]       # [B, T, O]
    weight = torch.where((s >= 0) & (s < s_len), weight,
                         torch.zeros_like(weight))
    index = s.clamp(0, s_len - 1)
    # one tap at a time, in the JAX package's order: no two writes of one
    # call meet, so the sums are deterministic
    w = d.new_zeros(d.shape + (s_len,))
    for t in range(taps.shape[0]):
        w.scatter_add_(2, index[:, t, :, None], weight[:, t, :, None])

    # cv2 INTER_AREA when both axes downscale: true area decimation, the
    # box-filter overlap of the dst footprint [d*scale, (d+1)*scale) with
    # each source cell
    a = (d * scale)[..., None]
    b = a + scale[..., None]
    sj = (torch.arange(s_len, device=dev) - crop0[..., None]).to(f32)
    ov = torch.clamp(torch.minimum(b, sj + 1.0) - torch.maximum(a, sj),
                     min=0.0)                                  # [B, O, S]
    w_down = ov / torch.clamp(scale, min=1e-30)[..., None]
    inside = (sj >= 0) & (sj < cszf[..., None])
    w_down = torch.where(inside, w_down, torch.zeros_like(w_down))
    decim = (code == 3) & area_decimate[:, None, None]
    w = torch.where(decim, w_down, w)
    w = torch.where(valid_row[..., None], w, torch.zeros_like(w))
    return list(zip(torch.split(w, list(out_lens), 1),
                    torch.split(valid_row, list(out_lens), 1)))


# ---------------------------------------------------------------------------
# Device side: full per-batch augmentation
# ---------------------------------------------------------------------------


def augment_batch(staged: torch.Tensor, staged2: torch.Tensor,
                  params: Dict[str, torch.Tensor], out_size: Tuple[int, int],
                  *, mixup: bool, distort: bool, pad_value: float = 128.0
                  ) -> torch.Tensor:
    """Batched augmentation on the tensors' device: blend -> distort ->
    warp -> letterbox pad -> flip.

    staged/staged2: [B, S, S, 3] uint8 BGR (staged2 ignored when
    mixup=False: pass staged); params: `pack_plans` arrays as tensors on
    the same device; out_size: (width, height), as the loader's img_size.
    Returns [B, H, W, 3] fp32 RGB in [0, 1].
    """
    out_w, out_h = int(out_size[0]), int(out_size[1])
    bsz, s_len = staged.shape[0], staged.shape[1]
    x = staged.to(torch.float32)
    if mixup:
        lam = params["lam"].to(torch.float32).view(-1, 1, 1, 1)
        x = torch.floor(lam * x + (1.0 - lam) * staged2.to(torch.float32))
    if distort:
        x = _color_distort_device(x, params["color"].to(torch.float32))

    crop, rect = params["crop"], params["rect"]
    # cv2 INTER_AREA picks true decimation only when BOTH axes downscale
    sx = crop[:, 2].to(torch.float32) / torch.clamp(
        rect[:, 2].to(torch.float32), min=1.0)
    sy = crop[:, 3].to(torch.float32) / torch.clamp(
        rect[:, 3].to(torch.float32), min=1.0)
    decim = (sx >= 1.0) & (sy >= 1.0)
    (wx, vx), (wy, vy) = _axis_weights(
        (out_w, out_h), s_len, crop[:, 0:2], crop[:, 2:4], rect[:, 2:4],
        rect[:, 0:2], params["interp"], decim)
    f64 = torch.float64
    t = torch.bmm(wy.to(f64), x.to(f64).reshape(bsz, s_len, s_len * 3))
    t = t.view(bsz, out_h, s_len, 3).transpose(1, 2).reshape(
        bsz, s_len, out_h * 3)                                  # rows
    out = torch.bmm(wx.to(f64), t).view(bsz, out_w, out_h, 3)  # cols
    out = torch.clamp(torch.round(out), 0.0, 255.0).to(torch.float32)
    out = out.transpose(1, 2)                                  # [B, H, W, 3]

    inside = vy[:, :, None] & vx[:, None, :]
    out = torch.where(inside[..., None], out, out.new_full((), pad_value))
    flip = (params["flip"] > 0).view(-1, 1, 1, 1)
    out = torch.where(flip, out.flip(2), out)
    return out.flip(-1) / 255.0                        # BGR -> RGB, [0, 1]
