"""Conv / activation / upsample building blocks of the folded inference net.

Counterpart of `yolov3_tensorflow_tpu/models/layers.py`, inference subset.
Tensors here are logical NCHW, held in channels_last memory (the layout
cuDNN runs fastest); conv weights are OIHW. The public forwards in
`models.yolov3` and `ops.fast_postprocess` convert from and to the JAX
package's NHWC at their boundary, which costs no copy because a contiguous
NHWC tensor permuted to NCHW already is channels_last.

Rounding follows the JAX package: each conv emits `compute_dtype`, and the
bias add and LeakyReLU run in that dtype (bf16 on the GPU), with the
LeakyReLU slope rounded to that dtype as JAX rounds it.
"""

from __future__ import annotations

import functools
from typing import Dict

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


def conv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
           compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """2-D convolution, NCHW x OIHW -> NCHW in `compute_dtype`.

    Symmetric (k-1)//2 padding at every stride, as the JAX `conv2d` pads.
    """
    pad = (w.shape[-1] - 1) // 2
    return F.conv2d(x.to(compute_dtype), w.to(compute_dtype), stride=stride,
                    padding=pad)


def leaky_relu(x: torch.Tensor, alpha: float = 0.1) -> torch.Tensor:
    """LeakyReLU(0.1), in one pass. The JAX package computes
    `where(x >= 0, x, alpha * x)`, where the weakly typed `alpha` takes x's
    dtype: in bf16 the slope is bf16(0.1) = 0.10009765625. `F.leaky_relu`
    multiplies in float by the slope it is given and rounds once to x's
    dtype, so it is given the slope rounded to x's dtype; the product of
    two bf16 values is exact in float, and the result is JAX's, bit for
    bit."""
    return F.leaky_relu(x, _slope(alpha, x.dtype))


@functools.lru_cache(maxsize=None)
def _slope(alpha: float, dtype: torch.dtype) -> float:
    """`alpha` rounded to `dtype`, once per pair: a tensor made per call
    would cost host time on every activation."""
    return float(torch.tensor(alpha, dtype=dtype))


def _channel(v: torch.Tensor) -> torch.Tensor:
    """[C] -> [1, C, 1, 1], broadcastable over NCHW."""
    return v.view(1, -1, 1, 1)


def conv_folded(x: torch.Tensor, p: Params, *, stride: int = 1,
                compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Conv with BN folded into (w, b), then leaky (JAX `conv_folded`)."""
    y = conv2d(x, p["w"], stride=stride, compute_dtype=compute_dtype)
    y = y + _channel(p["b"].to(y.dtype))
    return leaky_relu(y).to(compute_dtype)


def conv_bias(x: torch.Tensor, p: Params, *,
              compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Plain conv + bias, output in fp32: the 3 detection convs of the
    unpacked folded forward (JAX `conv_bias`)."""
    y = conv2d(x, p["w"], compute_dtype=compute_dtype)
    return y.float() + _channel(p["b"].float())


def neck_split_folded(inter: torch.Tensor, route: torch.Tensor, p_lat: Params,
                      p_first: Params, *,
                      compute_dtype: torch.dtype = torch.bfloat16
                      ) -> torch.Tensor:
    """FPN junction without materializing the upsample or the concat.

    The reference junction is `conv_first(concat(up2x(conv_lat(inter)),
    route))` with conv_first 1x1. A 1x1 conv over a channel concat is the
    sum of 1x1 convs over the parts, and a 1x1 conv commutes with
    nearest-neighbour upsampling, so the lateral half is convolved at low
    resolution and only its output is upsampled. The parts are summed in
    fp32, as in the JAX `neck_split_folded`.
    """
    a = conv_folded(inter, p_lat, compute_dtype=compute_dtype)
    ca = a.shape[1]
    w = p_first["w"].to(compute_dtype)
    ya = conv2d(a, w[:, :ca], compute_dtype=compute_dtype)
    yb = conv2d(route, w[:, ca:], compute_dtype=compute_dtype)
    y = (upsample_nearest_2x(ya).float() + yb.float()
         + _channel(p_first["b"].float()))
    return leaky_relu(y).to(compute_dtype)


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample of an NCHW tensor; keeps channels_last."""
    return F.interpolate(x, scale_factor=2, mode="nearest")
