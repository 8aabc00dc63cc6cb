"""Tensor-core rate and patch-build probes at the stem's matmul shapes.

Counterpart of `scripts/exp_mxu_shapes.py` (JAX, TPU). Two hand-written
CUDA kernels, each with its plain PyTorch version beside it:

- `mma_chain` (`csrc/mma_rate.cu`, replaces `_rate_kernel`): a chain of
  `reps` dependent bf16 products `a [M, k] x b [k, n]` with fp32
  accumulation, both operands held on chip for the whole chain, so the
  reading is the rate the tensor cores reach at that contraction width,
  not HBM bandwidth. The shapes (`SHAPES`) are the stem convs written as
  matmuls under a space-to-depth(2) or im2col formulation:
    c0'  [M,108]x[108,128]    conv_0 as s2d (12ch x 9 taps -> 4x32 out)
    c1'  [M,512]x[512,64]     conv_1 as 2x2 cells over s2d(conv_0 out)
    c3'  [M,512]x[512,256]    conv_3 3x3 as 2x2 cells in s2d-104 domain
    c4'  [M,1024]x[1024,128]  conv_4 3x3 s2 as 2x2 cells (s2d-104 -> native)
    c5   [M,128]x[128,64]     conv_5 1x1 native 104^2
    c6   [M,576]x[576,128]    conv_6 3x3 via 9-tap im2col patches
  plus padded and wider controls.
- `concat_patches` (`csrc/patch_build.cu`, replaces `_concat_kernel`): the
  im2col patch build, 9 row-shifted slices of each 1024-row block
  concatenated along channels: the non-matmul cost of a 3x3 conv written
  as one matmul.

Each wrapper launches its kernel for CUDA tensors and runs its plain
version (`*_reference`) for CPU tensors; anything else raises, and a build
or launch failure raises too. Each launch adds one to the wrapper's
`launches` count.

`main()` runs the 10 shapes at M = 16 x 1024 and the 3 widths at
M = 64 x 1024 on one GPU (`run`), CUDA events after warm-up. It prints
TF/s as a share of a bf16 matmul peak measured in the same run
(`torch.matmul` at 8192^3, a yardstick only), the time ratio of a 2 x reps
chain to a reps chain at each shape (2.0 for an honest chain), and GB/s of
patch bytes written.

Usage (on a machine with an NVIDIA GPU):

    python -m yolov3_tensorflow_tpu_torch.scripts.exp_mxu_shapes
"""

from __future__ import annotations

import argparse
import ctypes
import functools
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from yolov3_tensorflow_tpu_torch.utils.profiling import cuda_ms

REPS = 64                # dependent products per chain
MT = 1024                # rows per block of the TPU kernels
M_TOTAL = 16 * MT        # rows of the rate probe
PATCH_M = 64 * MT        # rows of the patch-build probe
SHAPES = (
    ("c0'  s2d conv_0 ", 108, 128),
    ("c0'  padK=128   ", 128, 128),
    ("c1'  s2d conv_1 ", 512, 64),
    ("c1'  N=128 ctrl ", 512, 128),
    ("c2'  s2d conv_2 ", 256, 128),
    ("c3'  s2d conv_3 ", 512, 256),
    ("c4'  s2d conv_4 ", 1024, 128),
    ("c5   1x1 native ", 128, 64),
    ("c6   im2col 3x3 ", 576, 128),
    ("ctrl 512x512    ", 512, 512),
)
WIDTHS = (32, 64, 128)
TAPS = 9
PEAK_SIZE = 8192         # M = N = K of the matmul peak

TILE_M = 128             # csrc/mma_rate.cu kBM: two warpgroups of 64 rows
TILE_N = 64              # csrc/mma_rate.cu kBN: one 128-byte row of B
TILE_K = 64              # K elements in one 128-byte swizzled row of A
SPLITS_K = (1, 2, 4)     # CTAs of a cluster that split K
SMEM_LIMIT = 232448      # bytes of shared memory one CTA may opt in to
REG_LIMIT = 255          # registers a thread may hold
THREADS = 256            # two warpgroups


class MmaTile(NamedTuple):
    splits: int          # CTAs of a cluster that split K (1: no split)
    kc: int              # K elements each CTA stages, a multiple of TILE_K
    smem: int            # dynamic shared memory bytes, alignment included
    regs: int            # accumulator registers a thread: pass + total


def mma_tile(k: int, n: int) -> MmaTile:
    """K3's CTA tile for a [*, k] x [k, n] chain: 128 x 64 outputs (n must
    be a multiple of 64), with the fewest K splits whose strips, A [128, kc]
    and B [kc, 64] bf16 (kc = k / splits rounded up to TILE_K), fit
    SMEM_LIMIT with 1024 bytes of alignment slack. With a split, the leader
    reads the others' totals from their shared memory, so the strips' space
    also holds a thread's 32 totals. The pass and the total take 64 of a
    thread's REG_LIMIT registers. Raises on what no tile fits."""
    regs = 2 * (TILE_M // 2 * TILE_N // 128)
    if n % TILE_N == 0 and regs < REG_LIMIT:
        for splits in SPLITS_K:
            kc = -(-k // (TILE_K * splits)) * TILE_K
            if (splits - 1) * kc >= k:           # a CTA would get no K
                break
            strips = (TILE_M + TILE_N) * kc * 2
            if splits > 1:
                strips = max(strips, regs // 2 * THREADS * 4)
            if strips + 1024 <= SMEM_LIMIT:
                return MmaTile(splits, kc, strips + 1024, regs)
    raise ValueError(f"mma_chain takes n a multiple of 64 and k <= 2304, got "
                     f"k={k}, n={n}")


def mma_chain_reference(a: torch.Tensor, b: torch.Tensor, reps: int,
                        mt: int = MT) -> torch.Tensor:
    """Plain PyTorch chain. a [m, k], b [k, n] bf16 -> o [m, n] fp32.

    As `_rate_kernel` writes it, per block of `mt` rows:
    acc <- acc + a . (b * s_r) for r < reps, in fp32 products of the bf16
    values, with s_r = bf16(1 + acc[0, 0] * 1e-30) from the block's first
    accumulator (1.0 for any acc below 1e27, so o = reps * a . b).
    """
    m, k = a.shape
    n = b.shape[1]
    if m % mt:
        raise ValueError(f"need m a multiple of mt={mt}, got m={m}")
    af = a.float().view(m // mt, mt, k)
    acc = torch.zeros((m // mt, mt, n), dtype=torch.float32, device=a.device)
    for _ in range(reps):
        s = (1.0 + acc[:, 0, 0] * 1e-30).to(torch.bfloat16)
        acc += torch.matmul(af, (b.unsqueeze(0) * s.view(-1, 1, 1)).float())
    return acc.view(m, n)


def mma_chain(a: torch.Tensor, b: torch.Tensor, reps: int) -> torch.Tensor:
    """o [m, n] fp32 = sum over r < reps of a [m, k] . b [k, n], bf16 inputs.

    CUDA tensors go to the hand-written kernel (m a multiple of 128, n of
    64, k <= 2304, contiguous 16-byte aligned inputs); CPU tensors to
    `mma_chain_reference` (m a multiple of MT). Each kernel launch adds one
    to `mma_chain.launches`.
    """
    if a.device.type == "cpu" and b.device.type == "cpu":
        return mma_chain_reference(a, b, reps)
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"a on {a.device} and b on {b.device}: need both on "
                         f"one CUDA device (or both on the CPU)")
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16:
        raise TypeError(f"mma_chain takes bfloat16, got {a.dtype} / "
                        f"{b.dtype}")
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"need a [m, k] and b [k, n], got {tuple(a.shape)} "
                         f"and {tuple(b.shape)}")
    m, k = a.shape
    n = b.shape[1]
    if m % TILE_M or reps < 0:
        raise ValueError(f"mma_chain takes m a multiple of {TILE_M} and "
                         f"reps >= 0, got m={m}, reps={reps}")
    tile = mma_tile(k, n)
    if not (a.is_contiguous() and b.is_contiguous()) \
            or a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError("mma_chain takes contiguous, 16-byte aligned a and b")
    o = torch.empty((m, n), dtype=torch.float32, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = _mma_launcher()(a.data_ptr(), b.data_ptr(), o.data_ptr(), m, k, n,
                          int(reps), tile.splits, stream)
    if err != 0:
        raise RuntimeError(f"mma_rate kernel launch failed: CUDA error {err}")
    mma_chain.launches += 1
    return o


mma_chain.launches = 0


@functools.lru_cache(maxsize=None)
def _mma_launcher():
    """Build (at first use) and bind the C entry point of mma_rate.cu."""
    from yolov3_tensorflow_tpu_torch.utils.kernels import load_kernel
    fn = load_kernel("mma_rate").mma_chain_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


# ---------------------------------------------------------------------------
# K4: the patch build
# ---------------------------------------------------------------------------

def _check_patch_args(m: int, taps: int, mt: int) -> None:
    if mt < 17 or m % mt or not 1 <= taps <= 17:
        raise ValueError(f"need mt >= 17, m a multiple of mt and "
                         f"1 <= taps <= 17, got m={m}, mt={mt}, taps={taps}")


def concat_patches_reference(x: torch.Tensor, taps: int = TAPS,
                             mt: int = MT) -> torch.Tensor:
    """Plain PyTorch patch build. x [m, c] -> [m / mt * (mt - 16), taps * c]:
    per block of mt rows, `torch.cat` of the taps slices
    x[i : i + mt - 16] along channels, as `_concat_kernel` builds it."""
    m, c = x.shape
    _check_patch_args(m, taps, mt)
    xb = x.view(m // mt, mt, c)
    return torch.cat([xb[:, i:i + mt - 16] for i in range(taps)],
                     dim=2).reshape(-1, taps * c)


def concat_patches(x: torch.Tensor, taps: int = TAPS, mt: int = MT
                   ) -> torch.Tensor:
    """im2col patch build, x [m, c] bf16 -> [m / mt * (mt - 16), taps * c].

    CUDA tensors go to the hand-written kernel (bf16, c a multiple of 8,
    contiguous and 16-byte aligned); CPU tensors to
    `concat_patches_reference`. Each kernel launch adds one to
    `concat_patches.launches`.
    """
    if x.device.type == "cpu":
        return concat_patches_reference(x, taps, mt)
    if x.device.type != "cuda":
        raise ValueError(f"x on {x.device}: need a CUDA device (or the CPU)")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"concat_patches takes bfloat16, got {x.dtype}")
    if x.ndim != 2 or x.shape[1] % 8:
        raise ValueError(f"need x [m, c] with c a multiple of 8, got "
                         f"{tuple(x.shape)}")
    m, c = x.shape
    _check_patch_args(m, taps, mt)
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("concat_patches takes a contiguous, 16-byte aligned x")
    out = torch.empty((m // mt * (mt - 16), taps * c), dtype=x.dtype,
                      device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _patch_launcher()(x.data_ptr(), out.data_ptr(), m, c, taps, mt,
                            stream)
    if err != 0:
        raise RuntimeError(f"patch_build kernel launch failed: CUDA error "
                           f"{err}")
    concat_patches.launches += 1
    return out


concat_patches.launches = 0


@functools.lru_cache(maxsize=None)
def _patch_launcher():
    """Build (at first use) and bind the C entry point of patch_build.cu."""
    from yolov3_tensorflow_tpu_torch.utils.kernels import load_kernel
    fn = load_kernel("patch_build").patch_build_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


# ---------------------------------------------------------------------------
# Measurements (GPU only)
# ---------------------------------------------------------------------------

def _gpu(device: Optional[torch.device]) -> torch.device:
    device = torch.device("cuda") if device is None else torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"the probes time a GPU; got device {device} "
                           f"(CUDA available: {torch.cuda.is_available()})")
    return device


def mma_operands(m_total: int, k: int, n: int, device: torch.device
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """a [m_total, k], b [k, n] bf16, standard normal from numpy seed 0,
    drawn as the JAX probe draws them."""
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((m_total, k)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32))
    return (a.to(device=device, dtype=torch.bfloat16),
            b.to(device=device, dtype=torch.bfloat16))


def patch_operand(m_total: int, c: int, device: torch.device) -> torch.Tensor:
    """x [m_total, c] bf16, standard normal from numpy seed 0."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((m_total, c)).astype(np.float32))
    return x.to(device=device, dtype=torch.bfloat16)


def matmul_peak(device: Optional[torch.device] = None) -> float:
    """TF/s of `torch.matmul` on bf16 [PEAK_SIZE, PEAK_SIZE] operands, TF32
    off: the yardstick the probes' rates are shared against."""
    device = _gpu(device)
    size = PEAK_SIZE
    gen = torch.Generator(device=device).manual_seed(0)
    a = torch.randn((size, size), generator=gen, device=device,
                    dtype=torch.bfloat16)
    b = torch.randn((size, size), generator=gen, device=device,
                    dtype=torch.bfloat16)
    c = torch.empty_like(a)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        ms = cuda_ms(lambda: torch.matmul(a, b, out=c), iters=20)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return 2.0 * size ** 3 / (ms * 1e-3) / 1e12


def _chain_ms(a: torch.Tensor, b: torch.Tensor, reps: int) -> float:
    return cuda_ms(lambda: mma_chain(a, b, reps), iters=30)


def library_out_dtype(device: torch.device) -> torch.dtype:
    """float32 where this torch's `torch.mm` takes bf16 operands with
    `out_dtype=torch.float32` (K3's own output type), else bfloat16."""
    x = torch.zeros((16, 16), dtype=torch.bfloat16, device=device)
    try:
        return torch.mm(x, x, out_dtype=torch.float32).dtype
    except (TypeError, RuntimeError):
        return torch.bfloat16


def library_ms(a: torch.Tensor, b: torch.Tensor, reps: int,
               out_dtype: torch.dtype) -> float:
    """Device ms of `reps` back-to-back `torch.mm(a, b)` in `out_dtype`:
    K3's products as library calls, on K3's operands, warm in L2 as K3
    finds them. A yardstick beside K3 only; nothing of the port calls
    it."""
    if out_dtype == torch.float32:
        def chain():
            for _ in range(reps):
                torch.mm(a, b, out_dtype=torch.float32)
    else:
        o = torch.empty((a.shape[0], b.shape[1]), dtype=a.dtype,
                        device=a.device)

        def chain():
            for _ in range(reps):
                torch.mm(a, b, out=o)
    return cuda_ms(chain, iters=10)


def mma_rate(m_total: int, k: int, n: int, reps: int = REPS,
             device: Optional[torch.device] = None) -> Tuple[float, float]:
    """Seconds per K3 chain and its TF/s, counting 2 * m * k * n * reps
    FLOPs at the true k."""
    device = _gpu(device)
    a, b = mma_operands(m_total, k, n, device)
    ms = _chain_ms(a, b, reps)
    return ms * 1e-3, 2.0 * m_total * k * n * reps / (ms * 1e-3) / 1e12


def concat_rate(m_total: int, c: int, taps: int = TAPS,
                device: Optional[torch.device] = None) -> Tuple[float, float]:
    """Seconds per K4 patch build and its GB/s of patch bytes written."""
    device = _gpu(device)
    x = patch_operand(m_total, c, device)
    ms = cuda_ms(lambda: concat_patches(x, taps), iters=50)
    written = m_total // MT * (MT - 16) * taps * c * 2
    return ms * 1e-3, written / (ms * 1e-3) / 1e9


def run(device: Optional[torch.device] = None) -> Dict:
    """Every probe once: each shape's chain at REPS and 2 * REPS, timed in
    turns (REPS, 2x, 2x, REPS, each reading the mean of its two runs) so
    that a drift of the card's clock between them cancels; each width;
    then the matmul peak, last, so that its power draw (the card's limit)
    does not slow the first shape. Returns {"peak_tflops", "mma": [...],
    "patch": [...]}."""
    device = _gpu(device)
    mma = []
    for name, k, n in SHAPES:
        a, b = mma_operands(M_TOTAL, k, n, device)
        t1, t2, t3, t4 = (_chain_ms(a, b, r)
                          for r in (REPS, 2 * REPS, 2 * REPS, REPS))
        ms, ms_2x = (t1 + t4) / 2, (t2 + t3) / 2
        mma.append({"name": name.strip(), "k": k, "n": n, "ms": ms,
                    "tflops": 2.0 * M_TOTAL * k * n * REPS / (ms * 1e-3)
                    / 1e12, "ms_2x": ms_2x, "ratio": ms_2x / ms})
    patch = []
    for c in WIDTHS:
        t, gbs = concat_rate(PATCH_M, c, TAPS, device)
        patch.append({"c": c, "ms": t * 1e3, "gbs": gbs})
    peak = matmul_peak(device)
    for r in mma:
        r["share"] = r["tflops"] / peak
    return {"peak_tflops": peak, "mma": mma, "patch": patch}


def report(result: Dict) -> list:
    """The lines `main` prints for a `run` result."""
    lines = [f"bf16 matmul peak (torch.matmul 8192^3, TF32 off): "
             f"{result['peak_tflops']:.1f} TF/s"]
    for r in result["mma"]:
        lines.append(f"{r['name']:<16s} K={r['k']:4d} N={r['n']:3d}: "
                     f"{r['tflops']:6.1f} TF/s ({r['share'] * 100:5.1f}% of "
                     f"the measured peak), {r['ms']:.4f} ms; 2x reps "
                     f"{r['ms_2x']:.4f} ms (ratio {r['ratio']:.3f})")
    for r in result["patch"]:
        lines.append(f"im2col concat {TAPS}x[M,{r['c']:3d}]: {r['gbs']:7.0f} "
                     f"GB/s of patches, {r['ms']:.4f} ms")
    return lines


def main(argv=None) -> Dict:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]) \
        .parse_args(argv)
    device = _gpu(None)
    print(f"device: {torch.cuda.get_device_name(device)}")
    result = run(device)
    for line in report(result):
        print(line)
    return result


if __name__ == "__main__":
    main()
