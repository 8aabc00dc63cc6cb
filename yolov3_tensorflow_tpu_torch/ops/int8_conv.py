"""The int8 convolution of the quantized forwards: int8 x int8 -> int32.

The JAX package runs its int8 convs as `lax.conv_general_dilated` on int8
operands with int32 accumulation (`ops/quantize.py` there). Here a conv is
an integer GEMM over patches:

- the activation is an int8 NCHW tensor in channels_last memory, so its
  NHWC view is contiguous;
- a k x k conv pads it symmetrically by (k-1)//2 at every stride (JAX's
  padding), takes the k*k strided windows and concatenates them along the
  channels in (dy, dx, cin) order: patches [M, k*k*cin], M = N*Ho*Wo (a
  1x1 conv at stride 1 needs no copy: its patches are the NHWC view);
- the weight is the GEMM operand `wt` [cout, K], K-major: JAX's HWIO
  kernel flattened to [k*k*cin, cout] and transposed, with K padded by
  zero columns to a multiple of 8 (conv_0's 27 becomes 32), which leaves
  every sum unchanged;
- `torch._int_mm(patches, wt.t())` gives the int32 accumulators [M, cout]
  (cuBLASLt's integer GEMM on the card; an exact integer product on the
  CPU, so the CPU tests run this same route).

`_int_mm` on the card needs more than 16 rows and K and cout multiples of
8: K is padded as above, rows are padded with zeros up to 17 where a tiny
input has fewer, and anything else raises. There is no float fallback.

`conv_int8_reference` is the plain version: `F.conv2d` in float64, rounded
to int32, exact because |acc| <= 127^2 * 9 * 1024 < 2^53. The tests and
chip_smoke.py hold the GEMM route to it bit for bit; no forward calls it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_ALIGN = 8          # _int_mm on the card: K and cout multiples of 8
_MIN_ROWS = 17      # and more than 16 rows


def quantize(x: torch.Tensor, inv: float) -> torch.Tensor:
    """round(x * inv) clipped to [-127, 127], as int8, in float32 (round
    half to even, as jnp.round). `inv` is a Python float holding a float32
    value, so the product is the JAX package's on every device."""
    return torch.round(x.float() * inv).clamp_(-127, 127).to(torch.int8)


def gemm_weight(w8: torch.Tensor) -> torch.Tensor:
    """int8 OHWI kernel [cout, k, k, cin] -> the GEMM operand [cout, K],
    K = k*k*cin rounded up to a multiple of 8 with zero columns. A view of
    `w8` (contiguous) when K needs no padding."""
    cout = w8.shape[0]
    wt = w8.reshape(cout, -1)
    pad = -wt.shape[1] % _ALIGN
    return F.pad(wt, (0, pad)) if pad else wt


def im2col(x8: torch.Tensor, k: int, stride: int, kpad: int
           ) -> torch.Tensor:
    """int8 NCHW (channels_last) -> patches [N, Ho, Wo, kpad] in (dy, dx,
    cin) order, zero columns after the k*k*cin real ones, with
    Ho = (H + 2p - k) // stride + 1 and p = (k-1)//2. A 1x1 conv at stride
    1 gets the NHWC view itself."""
    n, c, h, w = x8.shape
    x = x8.permute(0, 2, 3, 1)                           # NHWC view
    if k == 1 and stride == 1 and kpad == c:
        return x
    p = (k - 1) // 2
    ho = (h + 2 * p - k) // stride + 1
    wo = (w + 2 * p - k) // stride + 1
    if p:
        xp = x.new_zeros((n, h + 2 * p, w + 2 * p, c))
        xp[:, p:p + h, p:p + w] = x
    else:
        xp = x
    parts = [xp[:, dy:dy + stride * (ho - 1) + 1:stride,
                dx:dx + stride * (wo - 1) + 1:stride]
             for dy in range(k) for dx in range(k)]
    if kpad > k * k * c:
        parts.append(x.new_zeros((n, ho, wo, kpad - k * k * c)))
    return torch.cat(parts, dim=-1)


def int8_gemm(a: torch.Tensor, wt: torch.Tensor) -> torch.Tensor:
    """a [M, K] int8 @ wt[cout, K]^T -> int32 [M, cout] through
    `torch._int_mm`; each call adds one to `int8_gemm.calls`. Fewer than 17
    rows are padded with zero rows (exact); a K or cout that is no multiple
    of 8 raises."""
    m, kdim = a.shape
    if kdim != wt.shape[1] or kdim % _ALIGN or wt.shape[0] % _ALIGN:
        raise ValueError(f"int8_gemm: patches {tuple(a.shape)} and weight "
                         f"{tuple(wt.shape)} need equal K, and K and cout "
                         f"multiples of {_ALIGN}")
    if m < _MIN_ROWS:
        a = F.pad(a, (0, 0, 0, _MIN_ROWS - m))
    int8_gemm.calls += 1
    return torch._int_mm(a, wt.t())[:m]


int8_gemm.calls = 0


def conv_int8(x8: torch.Tensor, wt: torch.Tensor, k: int, stride: int
              ) -> torch.Tensor:
    """int8 conv, the GEMM route: x8 int8 NCHW (channels_last), wt from
    `gemm_weight` -> int32 accumulators as NHWC [N, Ho, Wo, cout]."""
    a = im2col(x8, k, stride, wt.shape[1])
    n, ho, wo, kpad = a.shape
    return int8_gemm(a.reshape(-1, kpad), wt).view(n, ho, wo, wt.shape[0])


def conv_int8_reference(x8: torch.Tensor, w8: torch.Tensor, stride: int
                        ) -> torch.Tensor:
    """The plain version of `conv_int8`: the same conv in float64 by
    F.conv2d, rounded to int32 (exact). x8 int8 NCHW, w8 int8 OHWI ->
    int32 NHWC [N, Ho, Wo, cout]."""
    k = w8.shape[1]
    y = F.conv2d(x8.double(), w8.permute(0, 3, 1, 2).double(),
                 stride=stride, padding=(k - 1) // 2)
    return torch.round(y).to(torch.int32).permute(0, 2, 3, 1)
