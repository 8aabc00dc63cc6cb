"""The folded conv's epilogue: its CUDA kernel's wrapper and plain version.

Every folded conv of the serving forward is followed by the same short
chain over its output: the bias add, LeakyReLU(0.1) (Mish in YOLOv4's
backbone), and at the end of a residual block the add of the shortcut;
each FPN junction adds its upsampled lateral half to its route half and
the bias in fp32 before its LeakyReLU (`models/layers.py`).
`conv_epilogue` runs that chain in one pass over the conv's output
(`csrc/conv_epilogue.cu`), in place where the output is dense, and gives
the chain's values bit for bit.

CUDA tensors go to the kernel, CPU tensors to `conv_epilogue_reference`,
the chain itself; anything else raises. There is no fallback from one to
the other. Nothing is built at import: the kernel is compiled at its first
launch, together with K1 (`nms_cuda.SERVING_KERNELS`).

Mish in bf16 takes the kernel's table route (the library says which
route each dtype takes): the first such call on a device builds there,
once, the table of the chain's 65,536 bf16 outputs that the kernel then
reads (`_mish_table`).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

ALPHA = 0.1                  # the LeakyReLU's slope, before rounding
BIAS, LEAKY, RESIDUAL, JUNCTION, MISH, MISH_RESIDUAL = range(6)  # modes
MODE_NAMES = ("bias", "leaky", "residual", "junction", "mish",
              "mish_residual")
MISH_ROUTES = ("table", "chain")
_TYPES = (torch.float32, torch.bfloat16)        # y's, and the bias's


@functools.lru_cache(maxsize=None)
def slope(alpha: float, dtype: torch.dtype) -> float:
    """`alpha` rounded to `dtype`, once per pair: a tensor made per call
    would cost host time on every activation."""
    return float(torch.tensor(alpha, dtype=dtype))


def mish_activation(x: torch.Tensor) -> torch.Tensor:
    """x * tanh(softplus(x)) (arXiv:1908.08681) in fp32, softplus(x) = x
    above 20 (PyTorch's and darknet's threshold), rounded once to x's
    dtype."""
    f = x.float()
    return (f * torch.tanh(F.softplus(f))).to(x.dtype)


def _mode(leaky: bool, shortcut, low, mish: bool = False) -> int:
    if mish:
        if low is not None:
            raise ValueError("the junction epilogue takes the LeakyReLU, "
                             "not Mish")
        return MISH if shortcut is None else MISH_RESIDUAL
    if low is not None:
        if shortcut is not None or not leaky:
            raise ValueError("the junction epilogue takes the LeakyReLU and "
                             "no shortcut")
        return JUNCTION
    if shortcut is not None:
        if not leaky:
            raise ValueError("a shortcut is added after the LeakyReLU: "
                             "leaky=False takes none")
        return RESIDUAL
    return LEAKY if leaky else BIAS


def conv_epilogue_reference(y: torch.Tensor, bias: torch.Tensor, *,
                            leaky: bool = True,
                            shortcut: Optional[torch.Tensor] = None,
                            low: Optional[torch.Tensor] = None,
                            mish: bool = False) -> torch.Tensor:
    """The plain PyTorch chain that `conv_epilogue` computes, on any
    device; a new tensor. y [N, C, H, W] is a conv's output in the compute
    dtype, bias [C].

    Without `low`: `y + bias` with the bias rounded to y's dtype, then
    (leaky) the LeakyReLU with its slope rounded to y's dtype, then (a
    shortcut) `+ shortcut`, each rounded to y's dtype. With `low` (the FPN
    junction; `low` [N, C, H/2, W/2] the lateral half): `up2x(low) + y +
    bias` in fp32, the LeakyReLU on that fp32 sum, rounded once to y's
    dtype. mish=True takes `mish_activation` in the LeakyReLU's place
    (and ignores `leaky`): `y + bias` rounded, Mish in fp32 rounded, then
    the shortcut's add rounded."""
    mode = _mode(leaky, shortcut, low, mish)
    if mode == JUNCTION:
        s = (F.interpolate(low, scale_factor=2, mode="nearest").float()
             + y.float() + bias.float().view(1, -1, 1, 1))
        return F.leaky_relu(s, slope(ALPHA, s.dtype)).to(y.dtype)
    out = y + bias.to(y.dtype).view(1, -1, 1, 1)
    if mode in (MISH, MISH_RESIDUAL):
        out = mish_activation(out)
    elif mode != BIAS:
        out = F.leaky_relu(out, slope(ALPHA, out.dtype))
    return out if shortcut is None else out + shortcut


def _check_operand(t: torch.Tensor, y: torch.Tensor, shape, what: str):
    if t.device != y.device or t.dtype != y.dtype:
        raise ValueError(f"{what} is {t.dtype} on {t.device}, y {y.dtype} on "
                         f"{y.device}: need both alike")
    if tuple(t.shape) != shape:
        raise ValueError(f"{what} has shape {tuple(t.shape)}, need {shape}")
    _check_layout(t, what)


def _check_layout(t: torch.Tensor, what: str) -> None:
    s = t.stride()
    if s[1] != 1 or t.data_ptr() % 16 or any(
            s[d] % 8 for d in (0, 2, 3) if t.shape[d] > 1):
        raise ValueError(f"the epilogue kernel reads {what} 16 bytes at a "
                         f"time along C: need channels_last memory (channel "
                         f"stride 1, the strides of the other dimensions "
                         f"longer than 1 multiples of 8, 16-byte aligned), "
                         f"got strides {s}")


def _dense(t: Optional[torch.Tensor]) -> bool:
    return t is None or t.is_contiguous(memory_format=torch.channels_last)


def conv_epilogue(y: torch.Tensor, bias: torch.Tensor, *,
                  leaky: bool = True,
                  shortcut: Optional[torch.Tensor] = None,
                  low: Optional[torch.Tensor] = None,
                  mish: bool = False) -> torch.Tensor:
    """The chain of `conv_epilogue_reference`, in one pass: bias add,
    LeakyReLU (leaky=True) or Mish (mish=True), shortcut add (a shortcut
    given), or the junction's fp32 sum and LeakyReLU (`low` given).

    CUDA tensors go to the hand-written kernel: y bf16 or fp32 in
    channels_last memory with C % 8 == 0, the bias fp32 or bf16, the
    shortcut and `low` of y's dtype and layout. The result is written over
    y where y is dense (the conv's own output), else (a strided window of
    it) into a new dense tensor, and returned; it carries no gradient.
    CPU tensors go to `conv_epilogue_reference`. Each kernel launch adds
    one to `conv_epilogue.launches` and one to its mode's count in
    `conv_epilogue.launches_by_mode` (keyed by MODE_NAMES); a Mish launch
    also adds one to its route's in `conv_epilogue.mish_launches_by_route`
    (keyed by MISH_ROUTES, as the library reports the route of y's
    dtype)."""
    if y.device.type == "cpu":
        return conv_epilogue_reference(y, bias, leaky=leaky,
                                       shortcut=shortcut, low=low, mish=mish)
    mode = _mode(leaky, shortcut, low, mish)
    if y.device.type != "cuda":
        raise ValueError(f"y on {y.device}: the epilogue runs on a CUDA "
                         f"device (or on the CPU)")
    if y.dtype not in _TYPES or bias.dtype not in _TYPES:
        raise TypeError(f"the epilogue kernel takes bf16 or fp32, got y "
                        f"{y.dtype} and bias {bias.dtype}")
    if y.requires_grad and torch.is_grad_enabled():
        raise ValueError("the epilogue kernel has no backward: call it "
                         "under torch.no_grad() or inference_mode()")
    if y.dim() != 4 or y.shape[1] % 8:
        raise ValueError(f"the epilogue kernel takes y [N, C, H, W] with "
                         f"C % 8 == 0, got {tuple(y.shape)}")
    n, c, h, w = y.shape
    if bias.device != y.device or tuple(bias.shape) != (c,) \
            or bias.stride(0) != 1:
        raise ValueError(f"need a contiguous bias [{c}] on {y.device}, got "
                         f"{tuple(bias.shape)} on {bias.device}")
    _check_layout(y, "y")
    extra = shortcut if low is None else low
    if extra is not None:
        shape = (n, c, h, w) if low is None else (n, c, h // 2, w // 2)
        if low is not None and (h % 2 or w % 2):
            raise ValueError(f"the junction upsamples 2x: y's H and W must "
                             f"be even, got {h} x {w}")
        _check_operand(extra, y, shape, "shortcut" if low is None else "low")
    if y.numel() == 0:
        return y
    dense_y = _dense(y)
    out = y if dense_y else torch.empty_like(
        y, memory_format=torch.channels_last)
    stream = torch.cuda.current_stream(y.device).cuda_stream
    bf16 = int(y.dtype == torch.bfloat16)
    bias_bf16 = int(bias.dtype == torch.bfloat16)
    slope_ = slope(ALPHA, torch.float32 if mode == JUNCTION else y.dtype)
    e_ptr = None if extra is None else extra.data_ptr()
    lib = _launchers()
    route = lib.mish_route[bf16] if mode in (MISH, MISH_RESIDUAL) else None
    table = _mish_table(y.device).data_ptr() if route == "table" else None
    if mode != JUNCTION and dense_y and _dense(extra):
        err = lib.dense(out.data_ptr(), y.data_ptr(), e_ptr,
                        bias.data_ptr(), table, bf16, bias_bf16, mode,
                        n * h * w, c, slope_, stream)
    else:
        se = (0, 0, 0) if extra is None else (
            extra.stride(0), extra.stride(2), extra.stride(3))
        err = lib.strided(out.data_ptr(), y.data_ptr(), e_ptr,
                          bias.data_ptr(), table, bf16, bias_bf16, mode, n,
                          h, w, c, out.stride(0), out.stride(2),
                          out.stride(3), y.stride(0), y.stride(2),
                          y.stride(3), *se, slope_, stream)
    if err != 0:
        raise RuntimeError(f"conv_epilogue kernel launch failed: CUDA error "
                           f"{err}")
    conv_epilogue.launches += 1
    conv_epilogue.launches_by_mode[MODE_NAMES[mode]] += 1
    if route is not None:
        conv_epilogue.mish_launches_by_route[route] += 1
    return out


conv_epilogue.launches = 0
conv_epilogue.launches_by_mode = dict.fromkeys(MODE_NAMES, 0)
conv_epilogue.mish_launches_by_route = dict.fromkeys(MISH_ROUTES, 0)


@functools.lru_cache(maxsize=None)
def _mish_table(device: torch.device) -> torch.Tensor:
    """The table route's table on `device`: 65,536 bf16 codes, entry k
    rnd(mish(x)) for the x whose code is k, filled by the kernel's own
    mish() on the device (the CPU's log1p and tanh differ from CUDA's in
    the last ulp). Built at the first bf16 Mish call on the device, and
    waited for, so that a call on another stream finds it whole."""
    table = torch.empty(1 << 16, dtype=torch.int16, device=device)
    stream = torch.cuda.current_stream(device)
    with torch.cuda.device(device):
        err = _launchers().mish_table(table.data_ptr(), stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv_epilogue's Mish table failed to build: "
                           f"CUDA error {err}")
    stream.synchronize()
    return table


class _Library(NamedTuple):
    """conv_epilogue.cu's C entry points, bound, and what it reports."""
    dense: Callable[..., int]
    strided: Callable[..., int]
    mish_table: Callable[..., int]
    mish_route: Tuple[str, str]     # the Mish route of fp32 and of bf16


@functools.lru_cache(maxsize=None)
def _launchers() -> _Library:
    """Build (at first use, with K1) and bind conv_epilogue.cu's C entry
    points once, with their argument types, and ask it once which route
    (MISH_ROUTES) the Mish instances of each dtype take. Pointers and the
    stream are c_void_p so ctypes does not cut them to 32 bits."""
    from yolov3_tensorflow_tpu_torch.ops.nms_cuda import SERVING_KERNELS
    from yolov3_tensorflow_tpu_torch.utils.kernels import load_kernel
    lib = load_kernel("conv_epilogue", SERVING_KERNELS)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    dense = lib.conv_epilogue_dense
    dense.argtypes = [p, p, p, p, p, i, i, i, ll, i, ctypes.c_float, p]
    dense.restype = i
    strided = lib.conv_epilogue_strided
    strided.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i] + [ll] * 9 + [
        ctypes.c_float, p]
    strided.restype = i
    mish_table = lib.conv_epilogue_mish_table
    mish_table.argtypes = [p, p]
    mish_table.restype = i
    reads_table = lib.conv_epilogue_mish_reads_table
    reads_table.argtypes = [i]
    reads_table.restype = i
    route = tuple(MISH_ROUTES[0 if reads_table(bf16) else 1]
                  for bf16 in (0, 1))
    return _Library(dense, strided, mish_table, route)
