"""The folded conv's epilogue (`ops/conv_epilogue.py`, `csrc/conv_epilogue.cu`).

On the CPU: the plain version of each of the kernel's four modes is the
chain the folded layers ran before it, bit for bit, in bf16 and fp32, over
values that include negatives, +-0, subnormals, large magnitudes and NaN;
a numpy model of the kernel's arithmetic (float sums and products, rounded
to the dtype where the chain stores) gives the same bits; a model of the
bf16 Mish table route (a table of the chain's outputs at every bf16 code,
read at the code of rnd(y + rnd(b))) gives the chain's bits at every code,
and a YOLOv4 forward's 72 Mish calls take the table in bf16 and the chain
in fp32; the folded and
packed forwards, which now add each residual block's shortcut in its last
conv's epilogue, equal the walk that adds it after the block; the module
imports and runs on the CPU without nvcc; the kernel is built beside K1.

The `cuda` tests hold the kernel to the plain version on the card: at every
epilogue of the 416^2 forward (the space-to-depth stem's strided window
included), on the special values, over a whole packed forward, with its
launch count, and the device's Mish table against `mish_activation` on the
card at every code, with the launches by route. This file imports no JAX,
so the card runs it as it is
(`python -m pytest --noconftest -m cuda tests/test_torch_conv_epilogue.py`).
"""

import functools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from yolov3_tensorflow_tpu_torch.models import layers
from yolov3_tensorflow_tpu_torch.models.convert import (from_jax_variables,
                                                        spread_head)
from yolov3_tensorflow_tpu_torch.models.yolov3 import (_backbone_forward,
                                                       _head_forward,
                                                       fold_batch_norm,
                                                       nhwc,
                                                       space_to_depth_stem,
                                                       yolov3_forward_folded)
from yolov3_tensorflow_tpu_torch.ops import conv_epilogue as ce
from yolov3_tensorflow_tpu_torch.ops import fast_postprocess as fp
from yolov3_tensorflow_tpu_torch.ops import nms_cuda
from yolov3_tensorflow_tpu_torch.testing import (CPU_TEST_THREADS,
                                                 numpy_variables)
from yolov3_tensorflow_tpu_torch.utils import kernels

torch.set_num_threads(CPU_TEST_THREADS)

ROOT = Path(__file__).resolve().parents[1]
DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}
MODES = ("bias", "leaky", "residual", "junction")
SPECIAL = np.array([0.0, -0.0, 1.0, -1.0, 0.5, -0.5, 1e-40, -1e-40, 3e-39,
                    -3e-39, 1.2e-38, -1.2e-38, 3e38, -3e38, 1.7e38, -1.7e38,
                    np.nan, -np.nan, 65504.0, -65504.0, 1e-5, -1e-5, 7.0,
                    -7.0], np.float32)


def _values(rng: np.random.Generator, shape) -> np.ndarray:
    """float32 values of `shape`, a quarter from SPECIAL, the rest
    normal at mixed scales (negatives half the time)."""
    n = int(np.prod(shape))
    out = rng.normal(0.0, 1.0, n) * 10.0 ** rng.integers(-6, 6, n)
    pick = rng.random(n) < 0.25
    out[pick] = rng.choice(SPECIAL, int(pick.sum()))
    return out.astype(np.float32).reshape(shape)


def _operands(dtype: torch.dtype, mode: str, seed: int = 0,
              shape=(2, 16, 4, 6)):
    """(y, bias, shortcut, low) for one mode, NCHW in channels_last memory,
    y, shortcut and low in `dtype`, the bias fp32 and +-0 on a quarter of
    the channels each (so subnormal sums survive)."""
    rng = np.random.default_rng(seed)
    n, c, h, w = shape

    def act(s):
        t = torch.from_numpy(_values(rng, s)).to(dtype)
        return t.contiguous(memory_format=torch.channels_last)
    y = act(shape)
    bias = _values(rng, (c,))
    bias[0::4], bias[1::4] = 0.0, -0.0
    bias = torch.from_numpy(bias)
    shortcut = act(shape) if mode == "residual" else None
    low = act((n, c, h // 2, w // 2)) if mode == "junction" else None
    if low is not None:
        low[:, :, 0, 0] = 0.0       # y's own subnormals survive the sum
    return y, bias, shortcut, low


def _kwargs(mode, shortcut, low):
    return dict(leaky=mode != "bias", shortcut=shortcut, low=low)


def _old_chain(mode, y, bias, shortcut, low):
    """The folded layers' epilogues as they were written before the
    kernel: conv_folded's, the residual add after the block, the packed
    output conv's and neck_split_folded's."""
    def slope(dtype):
        return float(torch.tensor(0.1, dtype=dtype))
    if mode == "junction":
        s = (layers.upsample_nearest_2x(low).float() + y.float()
             + bias.float().view(1, -1, 1, 1))
        return F.leaky_relu(s, slope(s.dtype)).to(y.dtype)
    out = y + bias.to(y.dtype).view(1, -1, 1, 1)
    if mode == "bias":
        return out.to(y.dtype)
    out = F.leaky_relu(out, slope(out.dtype)).to(y.dtype)
    return out if shortcut is None else out + shortcut


def _round(x: np.ndarray, dtype: torch.dtype) -> np.ndarray:
    """float32 -> the nearest `dtype` value (ties to even), as float32."""
    if dtype == torch.float32:
        return x
    u = x.view(np.uint32).astype(np.uint64)
    r = (((u + 0x7FFF + ((u >> 16) & 1)) >> 16) << 16).astype(np.uint32)
    out = r.view(np.float32).copy()
    out[np.isnan(x)] = np.nan
    return out


def _kernel_model(mode, y, bias, shortcut, low):
    """The kernel's arithmetic (csrc/conv_epilogue.cu) in numpy float32."""
    dt = y.dtype
    f = lambda t: t.float().permute(0, 2, 3, 1).numpy()  # noqa: E731
    x, b = f(y), bias.numpy()
    with np.errstate(all="ignore"):
        if mode == "junction":
            e = np.repeat(np.repeat(f(low), 2, axis=1), 2, axis=2)
            r = (e + x) + b
            return _round(np.where(r > 0, r, r * np.float32(0.1)), dt)
        r = _round(x + _round(b, dt), dt)
        if mode == "bias":
            return r
        r = _round(np.where(r > 0, r, r * np.float32(ce.slope(0.1, dt))), dt)
        if mode == "residual":
            r = _round(r + f(shortcut), dt)
        return r


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int16 if t.dtype == torch.bfloat16
                               else torch.int32)


def _same_bits(got: torch.Tensor, want: torch.Tensor) -> bool:
    return got.dtype == want.dtype and got.shape == want.shape and \
        torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_reference_is_the_old_chain(dtype, mode):
    y, bias, shortcut, low = _operands(DTYPES[dtype], mode)
    got = ce.conv_epilogue_reference(y, bias, **_kwargs(mode, shortcut, low))
    want = _old_chain(mode, y, bias, shortcut, low)
    assert _same_bits(got, want)
    assert torch.isnan(got.float()).any()
    # on the CPU the wrapper is the plain version
    assert _same_bits(ce.conv_epilogue(y, bias, **_kwargs(mode, shortcut,
                                                          low)), want)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_kernel_arithmetic_model_matches_the_chain(dtype, mode):
    """Sums and products in float, rounded to the dtype after the bias
    add, after the LeakyReLU and after the residual add (once, at the end,
    at the junction): the chain's bits, subnormals included (NaN compared
    as NaN: the CPU and numpy differ in its payload)."""
    y, bias, shortcut, low = _operands(DTYPES[dtype], mode, seed=1)
    want = _old_chain(mode, y, bias, shortcut, low).float()
    want = want.permute(0, 2, 3, 1).numpy()
    got = _kernel_model(mode, y, bias, shortcut, low)
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got[~nan].view(np.uint32),
                                  want[~nan].view(np.uint32))
    tiny = np.abs(want[~nan])
    assert ((tiny > 0) & (tiny < 1.17549435e-38)).any()   # subnormals


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_every_bf16_value_through_the_leaky_epilogue(dtype):
    """conv_folded's epilogue over every finite bf16 value of both signs,
    at a bias of -0 (x + -0 is x, for x = -0 too): the LeakyReLU alone, as
    layers.leaky_relu gives it."""
    bits = np.arange(0x10000, dtype=np.uint32) << 16
    vals = bits.view(np.float32)
    vals = vals[np.isfinite(vals)]
    vals = np.concatenate([vals, vals[:(-len(vals)) % 8]])
    y = torch.from_numpy(vals.reshape(1, -1, 8)).to(DTYPES[dtype])
    y = y.permute(0, 2, 1)[..., None]                       # [1, 8, n, 1]
    got = ce.conv_epilogue(y, torch.full((8,), -0.0))
    assert _same_bits(got, layers.leaky_relu(y))


@functools.lru_cache(maxsize=None)
def _variables(num_classes: int = 80):
    return spread_head(from_jax_variables(numpy_variables(num_classes),
                                          device=torch.device("cpu")))


def _unfused_body(tree, images, out_fn, dtype):
    """The folded forward with each residual add after its block, as
    folded_body walked it before the epilogue took the shortcut."""
    def bn_conv(scope, i, x, stride=1):
        return layers.conv_folded(x, tree[scope][f"conv_{i}"], stride=stride,
                                  compute_dtype=dtype)

    def neck(li, fi, inter, route):
        return layers.neck_split_folded(inter, route,
                                        tree["head"][f"conv_{li}"],
                                        tree["head"][f"conv_{fi}"],
                                        compute_dtype=dtype)
    x = images.to(dtype).permute(0, 3, 1, 2)
    routes = _backbone_forward(lambda i, x, s: bn_conv("backbone", i, x, s),
                               x)
    fmaps = _head_forward(lambda i, x: bn_conv("head", i, x), out_fn, routes,
                          neck)
    return [nhwc(f) for f in fmaps]


@pytest.mark.parametrize("forward", ["packed", "folded"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_fused_residual_equals_the_unfused_walk(dtype, forward):
    dt = DTYPES[dtype]
    folded = fold_batch_norm(_variables(), dtype=dt)
    images = torch.rand((2, 64, 64, 3), generator=torch.Generator()
                        .manual_seed(3))
    with torch.inference_mode():
        if forward == "packed":
            tree = fp.pack_serving_head(folded, 80, out_dtype=dt)
            got = fp.yolov3_forward_packed(tree, images, compute_dtype=dt,
                                           out_dtype=dt)
            want = _unfused_body(tree, images, lambda i, x:
                                 fp.apply_packed_output_conv(
                                     tree["head"][f"conv_{i}"], x,
                                     compute_dtype=dt, out_dtype=dt), dt)
        else:
            got = yolov3_forward_folded(folded, images, compute_dtype=dt)
            want = _unfused_body(folded, images, lambda i, x:
                                 layers.conv_bias(x, folded["head"]
                                                  [f"conv_{i}"],
                                                  compute_dtype=dt), dt)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_module_imports_and_runs_on_the_cpu_without_nvcc(tmp_path):
    """A PATH with no nvcc and no CUDA_HOME: the module imports, the
    folded layers run the plain version, and nothing is built."""
    code = (
        "import torch\n"
        "from yolov3_tensorflow_tpu_torch.ops import conv_epilogue as ce\n"
        "from yolov3_tensorflow_tpu_torch.models import layers\n"
        "from yolov3_tensorflow_tpu_torch.utils import kernels\n"
        "x = torch.rand(1, 8, 4, 4).to(memory_format=torch.channels_last)\n"
        "p = {'w': torch.rand(16, 8, 3, 3), 'b': torch.rand(16)}\n"
        "y = layers.conv_folded(x, p, compute_dtype=torch.float32)\n"
        "assert y.shape == (1, 16, 4, 4) and ce.conv_epilogue.launches == 0\n"
        "assert kernels.load_kernel.cache_info().currsize == 0\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "CUDA_HOME"}
    env["PATH"] = str(tmp_path)
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == "ok"


def test_the_epilogue_is_built_beside_k1(monkeypatch):
    """The first load of either serving kernel builds both in one
    build_kernels call (one nvcc each, started together)."""
    calls = []

    def build(*names, defines=()):
        calls.append(names)
        return {n: Path(f"/nonexistent/lib{n}.so") for n in names}
    monkeypatch.setattr(kernels, "build_kernels", build)
    monkeypatch.setattr(kernels.ctypes, "CDLL", lambda path: path)
    kernels.load_kernel.cache_clear()
    group = nms_cuda.SERVING_KERNELS
    try:
        assert kernels.load_kernel("conv_epilogue", group).endswith(
            "libconv_epilogue.so")
        assert kernels.load_kernel("nms_shared", group).endswith(
            "libnms_shared.so")
        assert kernels.load_kernel("mma_rate").endswith("libmma_rate.so")
    finally:
        kernels.load_kernel.cache_clear()
    assert calls == [("nms_shared", "conv_epilogue")] * 2 + [("mma_rate",)]


def test_wrapper_refuses_what_it_does_not_take():
    y, bias, shortcut, low = _operands(torch.bfloat16, "residual")
    with pytest.raises(ValueError):      # the junction takes no shortcut
        ce.conv_epilogue(y, bias, shortcut=shortcut,
                         low=y[:, :, :2, :3])
    with pytest.raises(ValueError):      # a shortcut comes after the leaky
        ce.conv_epilogue(y, bias, leaky=False, shortcut=shortcut)
    with pytest.raises(ValueError):      # neither the CPU nor CUDA
        ce.conv_epilogue(y.to("meta"), bias.to("meta"))


def test_slope_is_rounded_to_the_dtype():
    assert ce.slope(0.1, torch.bfloat16) == 0.10009765625
    assert ce.slope(0.1, torch.float32) == float(np.float32(0.1))


# ---------------------------------------------------------------------------
# The bf16 Mish table route, modelled on the CPU
# ---------------------------------------------------------------------------

MISH_MODES = ("mish", "mish_residual")


def _every_bf16_code(device=None) -> torch.Tensor:
    """The 65,536 bf16 values, the one with code k at k."""
    return torch.arange(1 << 16, dtype=torch.int32, device=device).to(
        torch.int16).view(torch.bfloat16)


def _table_model(y, bias, shortcut):
    """The kernel's bf16 Mish table route (csrc/conv_epilogue.cu:
    mish_by_table): the table holds rnd(mish(x)) at each bf16 code (here
    from mish_activation; on the card the kernel fills it with its own
    mish()); r = rnd(y + rnd(b)) in float, its 16 bits the index; the
    shortcut's add after, rounded."""
    table = ce.mish_activation(_every_bf16_code()).view(torch.int16)
    r = (y.float() + bias.to(torch.bfloat16).float().view(1, -1, 1, 1)).to(
        torch.bfloat16)
    code = r.view(torch.int16).long() & 0xffff
    out = table[code].view(torch.bfloat16)
    if shortcut is not None:
        out = (out.float() + shortcut.float()).to(torch.bfloat16)
    return out, code


@pytest.mark.parametrize("window", [False, True])
@pytest.mark.parametrize("mode", MISH_MODES)
def test_table_route_model_is_the_chain_at_every_code(mode, window):
    """y holds each of the 65,536 bf16 codes once: with a bias of -0
    (x + -0 is x, for -0 too) every code reaches the table as itself,
    +-0, subnormals, +-inf, the NaNs and the values around softplus's
    threshold of 20 among them; then under a seeded bias (rounded sums).
    The model gives the chain's bits, dense and on a strided window (NaN
    compared as NaN: the CPU's NaN payloads are its own)."""
    shape = (2, 32, 32, 32)
    y = _every_bf16_code().view(2, 32, 32, 32).permute(0, 3, 1, 2)
    if window:
        big = torch.zeros((2, 33, 34, 32), dtype=torch.bfloat16)
        big[:, 1:, 2:] = y.permute(0, 2, 3, 1)
        y = big.permute(0, 3, 1, 2)[:, :, 1:, 2:]
        assert not y.is_contiguous(memory_format=torch.channels_last)
    assert y.shape == (2, 32, 32, 32) and y.stride(1) == 1
    rng = np.random.default_rng(6)
    shortcut = None if mode == "mish" else torch.from_numpy(
        _values(rng, shape)).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
    seeded = torch.from_numpy(_values(rng, (32,)))
    for i, bias in enumerate((torch.full((32,), -0.0), seeded,
                              seeded.to(torch.bfloat16))):
        got, code = _table_model(y, bias, shortcut)
        want = ce.conv_epilogue_reference(y, bias, shortcut=shortcut,
                                          mish=True)
        nan = torch.isnan(want)
        assert torch.equal(torch.isnan(got), nan)
        assert torch.equal(_bits(got)[~nan], _bits(want)[~nan])
        if i > 0:
            continue
        # every code went through the table as itself (a NaN as a NaN)
        y_nan = torch.isnan(y)
        assert torch.equal(code[~y_nan], (y.view(torch.int16).long()
                                          & 0xffff)[~y_nan])
        x = code.to(torch.int16).view(torch.bfloat16).float()
        assert torch.isnan(x[y_nan]).all()
        for hit in (x == 0, torch.signbit(x) & (x == 0),
                    (x != 0) & (x.abs() < 1.17549435e-38), x == float("inf"),
                    x == -float("inf"), torch.isnan(x), x == 20.0,
                    (x > 19.5) & (x < 20.5)):
            assert hit.any()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_yolov4_mish_calls_take_the_route_of_their_dtype(dtype,
                                                         monkeypatch):
    """A YOLOv4 packed forward (32^2, on the CPU) makes 72 Mish epilogue
    calls, each with y of the compute dtype, whose route the library
    reports (on the card: bf16 the table, fp32 the chain,
    test_cuda_yolov4_mish_launches_by_route). The CPU runs the plain chain
    and counts no launch on either route."""
    from yolov3_tensorflow_tpu_torch.models import yolov4
    dt = DTYPES[dtype]
    dtypes = []

    def spy(y, bias, *, mish=False, **kw):
        if mish:
            dtypes.append(y.dtype)
        return ce.conv_epilogue(y, bias, mish=mish, **kw)
    monkeypatch.setattr(layers, "conv_epilogue", spy)
    gen = torch.Generator().manual_seed(2)
    tree = fp.pack_serving_head(fold_batch_norm(yolov4.init_yolov4(
        gen, 80, device=torch.device("cpu")), dtype=dt), 80, out_dtype=dt,
        names=yolov4.DETECTION_CONVS)
    before = dict(ce.conv_epilogue.mish_launches_by_route)
    with torch.inference_mode():
        yolov4.yolov4_forward_packed(tree, torch.rand((1, 32, 32, 3),
                                                      generator=gen),
                                     compute_dtype=dt, out_dtype=dt)
    assert dtypes == [dt] * 72
    assert ce.conv_epilogue.mish_launches_by_route == before
    assert set(before) == set(ce.MISH_ROUTES)


@pytest.mark.parametrize("reads", [(0, 1), (0, 0), (1, 1)])
def test_mish_route_is_what_the_library_reports(reads, monkeypatch):
    """The wrapper takes each dtype's Mish route (and so the route it
    counts a launch on) from the library's conv_epilogue_mish_reads_table,
    asked once, and not from a rule of its own: here a stand-in library
    (the shipped one reads (0, 1): fp32 the chain, bf16 the table)."""
    class Library:
        def __getattr__(self, name):
            def entry(*args):
                if name == "conv_epilogue_mish_reads_table":
                    asked.append(args)
                    return reads[args[0]]
                return 0
            return entry
    asked = []
    monkeypatch.setattr(kernels, "load_kernel", lambda *a, **kw: Library())
    lib = ce._launchers.__wrapped__()
    assert lib.mish_route == tuple(ce.MISH_ROUTES[0 if r else 1]
                                   for r in reads)
    assert sorted(asked) == [(0,), (1,)]


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _record_and_compare(monkeypatch, seen: list):
    """Patch the folded layers' epilogue so each call runs the kernel and
    the plain version on copies of its operands and compares their bits;
    `seen` gets (mode, y's shape, y dense) per call."""
    def checked(y, bias, *, leaky=True, shortcut=None, low=None,
                mish=False):
        kw = dict(leaky=leaky, shortcut=shortcut, low=low, mish=mish)
        want = ce.conv_epilogue_reference(y, bias, **kw)
        got = ce.conv_epilogue(y.clone() if y.is_contiguous(
            memory_format=torch.channels_last) else y, bias, **kw)
        mode = ce._mode(leaky, shortcut, low, mish)
        dense = y.is_contiguous(memory_format=torch.channels_last)
        assert _same_bits(got, want), (mode, tuple(y.shape))
        seen.append((mode, tuple(y.shape), dense))
        return got
    monkeypatch.setattr(layers, "conv_epilogue", checked)
    monkeypatch.setattr(fp, "conv_epilogue", checked)


@pytest.mark.cuda
@pytest.mark.parametrize("stem_s2d", [False, True])
def test_cuda_kernel_bit_equal_at_every_epilogue_of_the_forward(
        card, monkeypatch, stem_s2d):
    """Every epilogue of the packed 416^2 forward at batch 2 (with the
    space-to-depth stem: conv_1's strided window too), kernel against
    plain version on the same operands."""
    folded = fold_batch_norm(spread_head(from_jax_variables(
        numpy_variables(80), device=card)), dtype=torch.bfloat16)
    if stem_s2d:
        folded = space_to_depth_stem(folded)
    tree = fp.pack_serving_head(folded, 80)
    images = torch.rand((2, 416, 416, 3), device=card,
                        generator=torch.Generator(card).manual_seed(5))
    seen = []
    _record_and_compare(monkeypatch, seen)
    with torch.inference_mode():
        fp.yolov3_forward_packed(tree, images, stem_s2d=stem_s2d)
    torch.cuda.synchronize()
    modes = [m for m, _, _ in seen]
    assert len(seen) == 75
    assert modes.count(ce.RESIDUAL) == 23 and modes.count(ce.JUNCTION) == 2
    assert modes.count(ce.BIAS) == 3
    assert (not stem_s2d) == all(d for _, _, d in seen)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cuda_kernel_bit_equal_on_special_values(card, dtype, mode):
    """Negatives, +-0, subnormals, large magnitudes and NaN (NaN's bits
    included), dense and as a strided window, a bf16 bias too."""
    for seed, shape in enumerate(((2, 16, 4, 6), (3, 264, 6, 10),
                                  (1, 1024, 2, 2))):
        y, bias, shortcut, low = (None if t is None else t.to(card) for t in
                                  _operands(DTYPES[dtype], mode, seed, shape))
        kw = _kwargs(mode, shortcut, low)
        for b in (bias, bias.to(torch.bfloat16)):
            want = ce.conv_epilogue_reference(y, b, **kw)
            got = ce.conv_epilogue(y.clone(), b, **kw)
            assert _same_bits(got, want), (shape, b.dtype)
        if mode != "junction":
            # a window cut out of a larger tensor, written out dense
            big = torch.zeros((shape[0], shape[2] + 1, shape[3] + 2,
                               shape[1]), dtype=y.dtype,
                              device=card).permute(0, 3, 1, 2)
            big[:, :, 1:, 2:] = y
            win = big[:, :, 1:, 2:]
            got = ce.conv_epilogue(win, bias, **kw)
            assert got.data_ptr() != win.data_ptr()
            assert _same_bits(got, ce.conv_epilogue_reference(y, bias, **kw))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_packed_forward_equals_the_plain_chain(card, monkeypatch):
    """A whole packed forward at batch 8, kernel against the plain
    chain, and the kernel's 75 launches a forward."""
    tree = fp.pack_serving_head(fold_batch_norm(spread_head(
        from_jax_variables(numpy_variables(80), device=card))), 80)
    images = torch.rand((8, 416, 416, 3), device=card,
                        generator=torch.Generator(card).manual_seed(7))
    with torch.inference_mode():
        before = ce.conv_epilogue.launches
        got = fp.yolov3_forward_packed(tree, images)
        torch.cuda.synchronize()
        assert ce.conv_epilogue.launches == before + 75
        fp.yolov3_forward_packed(tree, images)
        assert ce.conv_epilogue.launches == before + 150
        monkeypatch.setattr(layers, "conv_epilogue",
                            ce.conv_epilogue_reference)
        monkeypatch.setattr(fp, "conv_epilogue", ce.conv_epilogue_reference)
        want = fp.yolov3_forward_packed(tree, images)
    assert ce.conv_epilogue.launches == before + 150
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_cuda_wrapper_raises_on_what_the_kernel_does_not_take(card):
    y = torch.rand((2, 16, 4, 4), device=card).to(
        memory_format=torch.channels_last)
    with pytest.raises(TypeError):
        ce.conv_epilogue(y.half(), torch.zeros(16, device=card))
    with pytest.raises(ValueError):
        ce.conv_epilogue(y[:, :12].contiguous(
            memory_format=torch.channels_last), torch.zeros(12, device=card))
    with pytest.raises(ValueError):      # NCHW memory: channel stride != 1
        ce.conv_epilogue(y.contiguous(), torch.zeros(16, device=card))
    before = ce.conv_epilogue.launches
    ce.conv_epilogue(y, torch.zeros(16, device=card))
    assert ce.conv_epilogue.launches == before + 1


# ---------------------------------------------------------------------------
# The Mish modes (YOLOv4's backbone) on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("mode", MISH_MODES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cuda_mish_bit_equal_on_special_values(card, dtype, mode):
    """Each Mish mode against its plain chain on the card (PyTorch's own
    softplus and tanh kernels): dense and as a strided window, a bf16 bias
    too, over the special values and values around softplus's threshold
    of 20."""
    for seed, shape in enumerate(((2, 16, 4, 6), (3, 264, 6, 10),
                                  (1, 1024, 2, 2))):
        y, bias, shortcut, _ = (None if t is None else t.to(card) for t in
                                _operands(DTYPES[dtype], "residual", seed,
                                          shape))
        y[:, :8] = torch.linspace(-30, 30, y[:, :8].numel(),
                                  device=card).view_as(y[:, :8]).to(y.dtype)
        kw = dict(mish=True, shortcut=shortcut if mode == "mish_residual"
                  else None)
        for b in (bias, bias.to(torch.bfloat16)):
            want = ce.conv_epilogue_reference(y, b, **kw)
            got = ce.conv_epilogue(y.clone(), b, **kw)
            assert _same_bits(got, want), (shape, b.dtype)
        big = torch.zeros((shape[0], shape[2] + 1, shape[3] + 2, shape[1]),
                          dtype=y.dtype, device=card).permute(0, 3, 1, 2)
        big[:, :, 1:, 2:] = y
        win = big[:, :, 1:, 2:]
        got = ce.conv_epilogue(win, bias, **kw)
        assert got.data_ptr() != win.data_ptr()
        assert _same_bits(got, ce.conv_epilogue_reference(y, bias, **kw))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_yolov4_forward_every_mish_epilogue_bit_equal(card,
                                                           monkeypatch):
    """Every epilogue of YOLOv4's packed forward at batch 64 and 608^2,
    kernel against plain chain on the same operands: its 72 Mish calls (23
    of them adding a shortcut), 35 LeakyReLU and 3 bias; then the kernel's
    own launches a forward, counted by mode."""
    from yolov3_tensorflow_tpu_torch.models import yolov4
    gen = torch.Generator(card).manual_seed(9)
    tree = fp.pack_serving_head(fold_batch_norm(yolov4.init_yolov4(
        gen, 80, device=card)), 80, names=yolov4.DETECTION_CONVS)
    images = torch.rand((64, 608, 608, 3), device=card, generator=gen)
    seen = []
    _record_and_compare(monkeypatch, seen)
    with torch.inference_mode():
        yolov4.yolov4_forward_packed(tree, images)
    torch.cuda.synchronize()
    modes = [m for m, _, _ in seen]
    assert len(seen) == 110 and all(d for _, _, d in seen)
    assert (modes.count(ce.MISH), modes.count(ce.MISH_RESIDUAL),
            modes.count(ce.LEAKY), modes.count(ce.BIAS)) == (49, 23, 35, 3)
    monkeypatch.undo()
    before = dict(ce.conv_epilogue.launches_by_mode)
    with torch.inference_mode():
        yolov4.yolov4_forward_packed(tree, images[:8])
    after = ce.conv_epilogue.launches_by_mode
    assert {k: after[k] - before[k] for k in after} == {
        "bias": 3, "leaky": 35, "residual": 0, "junction": 0, "mish": 49,
        "mish_residual": 23}


@pytest.mark.cuda
def test_cuda_mish_table_is_mish_activation_at_every_code(card):
    """The table the kernel built on the card, against mish_activation
    (PyTorch's softplus and tanh kernels) on the card, bit for bit at all
    65,536 codes."""
    codes = _every_bf16_code(card)
    want = ce.mish_activation(codes).view(torch.int16)
    assert torch.equal(ce._mish_table(codes.device), want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cuda_yolov4_mish_launches_by_route(card, dtype):
    """A YOLOv4 packed forward's 72 Mish launches: all on the table route
    in bf16, all on the chain in fp32."""
    from yolov3_tensorflow_tpu_torch.models import yolov4
    dt = DTYPES[dtype]
    gen = torch.Generator(card).manual_seed(10)
    tree = fp.pack_serving_head(fold_batch_norm(yolov4.init_yolov4(
        gen, 80, device=card), dtype=dt), 80, out_dtype=dt,
        names=yolov4.DETECTION_CONVS)
    images = torch.rand((2, 128, 128, 3), device=card, generator=gen)
    before = dict(ce.conv_epilogue.mish_launches_by_route)
    with torch.inference_mode():
        yolov4.yolov4_forward_packed(tree, images, compute_dtype=dt,
                                     out_dtype=dt)
    after = ce.conv_epilogue.mish_launches_by_route
    assert {k: after[k] - before[k] for k in after} == (
        {"table": 72, "chain": 0} if dt == torch.bfloat16
        else {"table": 0, "chain": 72})
