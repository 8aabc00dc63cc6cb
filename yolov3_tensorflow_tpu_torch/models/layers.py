"""Conv / batch-norm / activation / upsample building blocks.

Counterpart of `yolov3_tensorflow_tpu/models/layers.py`: the folded
inference layers and the live batch-norm layers of the training forward.
Tensors here are logical NCHW, held in channels_last memory (the layout
cuDNN runs fastest); conv weights are OIHW. The public forwards in
`models.yolov3` and `ops.fast_postprocess` convert from and to the JAX
package's NHWC at their boundary, which costs no copy because a contiguous
NHWC tensor permuted to NCHW already is channels_last.

Rounding follows the JAX package: each conv emits `compute_dtype`, and the
bias add, the batch-norm scale and shift and the LeakyReLU run in that
dtype (bf16 on the GPU), with the LeakyReLU slope rounded to that dtype as
JAX rounds it. The folded layers' epilogues (bias, LeakyReLU, the residual
add, the junction's sum) go through `ops.conv_epilogue`: one kernel pass
over the conv's output on the card, the same chain on the CPU.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from yolov3_tensorflow_tpu_torch.ops.conv_epilogue import conv_epilogue, slope
from yolov3_tensorflow_tpu_torch.parallel.multihost import all_reduce_sum

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
    return F.leaky_relu(x, slope(alpha, x.dtype))


def _channel(v: torch.Tensor) -> torch.Tensor:
    """[C] -> [1, C, 1, 1], broadcastable over NCHW."""
    return v.view(1, -1, 1, 1)


def conv_folded(x: torch.Tensor, p: Params, *, stride: int = 1,
                compute_dtype: torch.dtype = torch.bfloat16,
                shortcut: Optional[torch.Tensor] = None,
                mish: bool = False) -> torch.Tensor:
    """Conv with BN folded into (w, b), then leaky (JAX `conv_folded`), or
    Mish with mish=True; with a `shortcut`, the residual block's
    `+ shortcut` after it. The epilogue is `ops.conv_epilogue`'s, in place
    on the card."""
    y = conv2d(x, p["w"], stride=stride, compute_dtype=compute_dtype)
    return conv_epilogue(y, p["b"], shortcut=shortcut, mish=mish)


def conv_folded_asym(x: torch.Tensor, p: Params, *,
                     padding: Tuple[Tuple[int, int], Tuple[int, int]],
                     compute_dtype: torch.dtype = torch.bfloat16
                     ) -> torch.Tensor:
    """conv_folded with explicit, possibly asymmetric padding
    ((top, bottom), (left, right)) and stride 1 (JAX `conv_folded_asym`):
    the space-to-depth stem's 2x2 conv_1 pads top and left only
    (models.yolov3.space_to_depth_stem).

    `F.conv2d` pads symmetrically, so the conv pads every side by the
    largest of the four and the output window the asymmetric padding
    gives is cut out of it: for ((1, 0), (1, 0)) one extra output row and
    column, dropped, where padding first (`F.pad`) would copy the whole
    input. The window is a strided view; the epilogue writes it out
    dense."""
    (top, bottom), (left, right) = padding
    pad = max(top, bottom, left, right)
    k_h, k_w = p["w"].shape[-2:]
    y = F.conv2d(x.to(compute_dtype), p["w"].to(compute_dtype), padding=pad)
    h = x.shape[2] + top + bottom - k_h + 1
    w = x.shape[3] + left + right - k_w + 1
    y = y[:, :, pad - top:pad - top + h, pad - left:pad - left + w]
    return conv_epilogue(y, p["b"])


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
    fp32, as in the JAX `neck_split_folded`; on the card the epilogue
    reads the lateral half at low resolution by index, so the upsampled
    tensor is never made (`ops.conv_epilogue`).
    """
    a = conv_folded(inter, p_lat, compute_dtype=compute_dtype)
    ca = a.shape[1]
    w = p_first["w"].to(compute_dtype)
    ya = conv2d(a, w[:, :ca], compute_dtype=compute_dtype)
    yb = conv2d(route, w[:, ca:], compute_dtype=compute_dtype)
    return conv_epilogue(yb, p_first["b"], low=ya)


def space_to_depth_2x(x: torch.Tensor,
                      dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """[N, H, W, C] -> [N, H/2, W/2, 4C] (NHWC, contiguous), the channel
    block of pixel phase (py, px) within each 2x2 cell at (py*2 + px)*C
    (JAX `space_to_depth_2x`). `dtype` casts in the same copy: one pass
    over the images where a cast and a relayout would take two (a cast is
    elementwise, so the values are those of casting first)."""
    n, h, w, c = x.shape
    out = torch.empty((n, h // 2, w // 2, 4 * c), dtype=dtype or x.dtype,
                      device=x.device)
    out.view(n, h // 2, w // 2, 2, 2, c).copy_(
        x.reshape(n, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5))
    return out


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample of an NCHW tensor; keeps channels_last.

    int8 (the int8-chained forward's activations), which F.interpolate
    does not take, goes through as its uint8 view: a nearest upsample only
    copies, so every value is the input's bit for bit (the JAX package
    broadcasts and reshapes)."""
    if x.dtype == torch.int8:
        return upsample_nearest_2x(x.view(torch.uint8)).view(torch.int8)
    return F.interpolate(x, scale_factor=2, mode="nearest")


# ---------------------------------------------------------------------------
# Live batch norm (the training forward)
# ---------------------------------------------------------------------------

def leaky_relu_train(x: torch.Tensor, alpha: float = 0.1) -> torch.Tensor:
    """LeakyReLU(0.1) with JAX's gradient: `where(x >= 0, x, slope * x)`.

    The forward equals `leaky_relu`'s bit for bit. The gradient at x == 0
    is 1, as JAX's `where` gives it; `F.leaky_relu`'s is the slope there,
    and a bf16 `y * a + b` lands on exactly 0 often enough over a training
    step's activations to matter. The slope is rounded to x's dtype."""
    return torch.where(x >= 0, x, x * slope(alpha, x.dtype))


def batch_norm(y: torch.Tensor, p: Params, s: Params, *, train: bool,
               momentum: float = 0.99, eps: float = 1e-5, group=None
               ) -> Tuple[torch.Tensor, Params]:
    """Batch normalization of an NCHW tensor, as the JAX package computes it.

    In training the moments are taken in fp32 over the conv's output as
    `mean` and `mean_sq`, `var = max(mean_sq - mean^2, 0)` (biased), and
    the moving statistics move as `momentum * old + (1 - momentum) * new`
    (`momentum` is JAX's decay, 0.99; PyTorch's BatchNorm would take 0.01,
    update with the unbiased variance and take the moments another way).
    Out of training the moving statistics normalize. Either way the output
    is `y * a + b` in y's dtype, with `a = gamma / sqrt(var + eps)` and
    `b = beta - mean * a` folded in fp32.

    With a process `group` (JAX's `axis_name`) training is sync batch
    norm: `mean` and `mean_sq` are the group's averages of the ranks' own,
    summed by a differentiable all-reduce and divided by the group's size
    (a group of one gives the single-device bits), so equal shards see the
    global batch's moments. (`nn.SyncBatchNorm` keeps an unbiased running
    variance and PyTorch's momentum.)

    Returns (normalized activations, new moving statistics); the new
    statistics carry no gradient."""
    if train:
        yf = y.float()
        mean = yf.mean(dim=(0, 2, 3))
        mean_sq = yf.square().mean(dim=(0, 2, 3))
        if group is not None:
            both = all_reduce_sum(torch.stack([mean, mean_sq]), group)
            mean, mean_sq = (both / dist.get_world_size(group)).unbind()
        var = torch.clamp(mean_sq - mean.square(), min=0.0)
        new_s = {"mean": momentum * s["mean"] + (1.0 - momentum) * mean.detach(),
                 "var": momentum * s["var"] + (1.0 - momentum) * var.detach()}
    else:
        mean, var = s["mean"], s["var"]
        new_s = s
    inv = torch.rsqrt(var + eps) * p["gamma"]
    a = inv.to(y.dtype)
    b = (p["beta"] - mean * inv).to(y.dtype)
    return y * _channel(a) + _channel(b), new_s


def conv_bn_leaky(x: torch.Tensor, p: Params, s: Params, *, stride: int = 1,
                  train: bool = False, momentum: float = 0.99,
                  eps: float = 1e-5,
                  compute_dtype: torch.dtype = torch.bfloat16, group=None
                  ) -> Tuple[torch.Tensor, Params]:
    """The darknet conv: conv (no bias) -> live BN (synced over `group`) ->
    LeakyReLU(0.1), in `compute_dtype`. Returns (activations, new BN
    statistics)."""
    y = conv2d(x, p["w"], stride=stride, compute_dtype=compute_dtype)
    y, new_s = batch_norm(y, p, s, train=train, momentum=momentum, eps=eps,
                          group=group)
    return leaky_relu_train(y).to(compute_dtype), new_s


def neck_split_bn_leaky(inter: torch.Tensor, route: torch.Tensor,
                        p_lat: Params, s_lat: Params, p_first: Params,
                        s_first: Params, *, train: bool,
                        momentum: float = 0.99, eps: float = 1e-5,
                        compute_dtype: torch.dtype = torch.bfloat16,
                        group=None
                        ) -> Tuple[torch.Tensor, Params, Params]:
    """The FPN junction of `neck_split_folded` with live batch norm.

    conv_first's kernel is split over the concat's two channel halves and
    the lateral half is convolved before the nearest-neighbour upsample, so
    the pre-BN tensor is the literal junction's (up to the order of the
    sums) while the upsampled tensor and the concat never exist, in the
    forward or the backward. The two halves are added in `compute_dtype`,
    as the JAX layer adds them (the serving junction adds in fp32).

    Both batch norms sync over `group`. Returns (activations, new lateral
    stats, new conv_first stats)."""
    lat, new_s_lat = conv_bn_leaky(inter, p_lat, s_lat, train=train,
                                   momentum=momentum, eps=eps,
                                   compute_dtype=compute_dtype, group=group)
    ca = lat.shape[1]
    w = p_first["w"].to(compute_dtype)
    ya = conv2d(lat, w[:, :ca], compute_dtype=compute_dtype)
    yb = conv2d(route, w[:, ca:], compute_dtype=compute_dtype)
    y = upsample_nearest_2x(ya) + yb
    y, new_s_first = batch_norm(y, p_first, s_first, train=train,
                                momentum=momentum, eps=eps, group=group)
    return leaky_relu_train(y).to(compute_dtype), new_s_lat, new_s_first
