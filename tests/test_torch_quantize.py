"""The port's int8 quantization (ops/quantize.py, ops/int8_conv.py) against
the JAX package's ops/quantize.py, on the CPU.

Full-width YOLOv3, 3 classes, 64^2: the same numpy-seeded variables
(`testing.numpy_variables`) and images go through both packages. What is
held, and how tightly:

- calibration in fp32: every abs-max within 1e-5 relative (the convs sum
  in another order); in bf16 within 2e-2 relative: one bf16 rounding of a
  conv output moves the next layers' maxima by a few bf16 steps (2^-8);
- `quantize_model` / `quantize_model_chained` from the same act_scales:
  w8, w_scale, eff_scale, in_scale and b bit-equal (the port takes the
  fold's square root in float64, so its fp32 fold is JAX's bit for bit;
  no w8 entry moves);
- one int8 conv at k=1, k=3 stride 1, k=3 stride 2 and cin=3: the int32
  accumulators equal JAX's `lax.conv_general_dilated` and the port's
  float64 reference; the bf16 outputs of `_conv_int8`,
  `_conv_int8_chained` (residual add, int8 and bf16 out) and
  `_concat_split_conv` bit-equal;
- the int8 `upsample_nearest_2x`, `stem_int8_safe_boundaries`;
- the whole forwards (`yolov3_forward_int8`, `_int8_packed`,
  `_int8_split`, `_int8_chained` with both heads, `_stem_int8_packed` at
  upto 9 and 12) and the number of int8 GEMMs each runs (72, 72, 72, 74,
  74, 9, 12). In the int8 forwards every int8 conv is bit-equal; only the
  bf16 detection convs sum in another order, so each output (the split
  head's boxconf and class logits alike) is within one bf16 step of JAX's
  and equal on >= 99.9% of them (one packed value of 3072 differed by
  one step here). The stem8 forward's bf16 remainder (60+ bf16 convs)
  drifts more: each output within two bf16 steps of the larger of the two
  values and 0.5 (at most 2^-7 apart at logits of magnitude 1..2 here),
  and equal on >= 90% (95% here).

JAX's forwards are called unjitted (plain functions).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov3_tensorflow_tpu.models.layers import \
    upsample_nearest_2x as jax_upsample
from yolov3_tensorflow_tpu.ops import fast_postprocess as jfp
from yolov3_tensorflow_tpu.ops import quantize as jq
from yolov3_tensorflow_tpu_torch.models.convert import from_jax_variables
from yolov3_tensorflow_tpu_torch.models.layers import upsample_nearest_2x
from yolov3_tensorflow_tpu_torch.ops import fast_postprocess as tfp
from yolov3_tensorflow_tpu_torch.ops import int8_conv as I8
from yolov3_tensorflow_tpu_torch.ops import quantize as tq
from yolov3_tensorflow_tpu_torch.testing import (CPU_TEST_THREADS,
                                                 numpy_variables)

torch.set_num_threads(CPU_TEST_THREADS)

CPU = torch.device("cpu")
C = 3
SIZE = 64


@pytest.fixture(scope="module")
def setup():
    jvars = numpy_variables(C, seed=0)
    tvars = from_jax_variables(jvars, device=CPU)
    images = np.random.default_rng(0).uniform(
        0, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    scales = jq.calibrate_activation_scales(jvars, jnp.asarray(images))
    return jvars, tvars, images, scales


def _nchw(x: np.ndarray) -> torch.Tensor:
    """NHWC numpy -> NCHW channels_last tensor."""
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _bits(x, nchw: bool = True) -> np.ndarray:
    """bf16/int8/fp32 values of either package as numpy, NHWC (a 4-D port
    tensor is NCHW unless nchw=False)."""
    if isinstance(x, torch.Tensor):
        if x.dim() == 4 and nchw:
            x = x.permute(0, 2, 3, 1)
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype == jnp.bfloat16 else x


def _bf16_ulp(a: np.ndarray) -> np.ndarray:
    """The spacing of bf16 values at magnitude |a| (8 significant bits)."""
    _, e = np.frexp(np.maximum(np.abs(a), np.finfo(np.float32).tiny))
    return np.ldexp(1.0, e - 8).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_calibration_matches_jax(dtype, setup):
    jvars, tvars, images, scales = setup
    got = tq.calibrate_activation_scales(tvars, images,
                                         compute_dtype=getattr(torch, dtype))
    want = scales if dtype == "bfloat16" else jq.calibrate_activation_scales(
        jvars, jnp.asarray(images), compute_dtype=jnp.float32)
    assert {s: sorted(v) for s, v in got.items()} == \
        {s: sorted(v) for s, v in want.items()}
    assert len(got["backbone"]) == 52 and len(got["head"]) == 23
    rtol = 1e-5 if dtype == "float32" else 2e-2
    for scope in want:
        for name, v in want[scope].items():
            assert isinstance(got[scope][name], float)
            np.testing.assert_allclose(got[scope][name], v, rtol=rtol,
                                       err_msg=f"{scope}/{name}")


@pytest.mark.parametrize("chained", [False, True])
def test_quantize_model_matches_jax(chained, setup):
    jvars, tvars, _, scales = setup
    fn = "quantize_model_chained" if chained else "quantize_model"
    want = getattr(jq, fn)(jvars, scales)
    got = getattr(tq, fn)(tvars, scales)
    keys = ("w_scale", "b") if chained else ("eff_scale", "b")
    n_int8 = 0
    for scope in ("backbone", "head"):
        assert sorted(got[scope]) == sorted(want[scope])
        for name, w in want[scope].items():
            g = got[scope][name]
            if "w8" not in w:                       # the bf16 output convs
                np.testing.assert_array_equal(
                    g["w"].permute(2, 3, 1, 0).float().numpy(),
                    np.asarray(w["w"], np.float32))
                np.testing.assert_array_equal(g["b"].numpy(), w["b"])
                continue
            n_int8 += 1
            assert g["w8"].dtype == torch.int8
            np.testing.assert_array_equal(g["w8"].permute(1, 2, 3, 0).numpy(),
                                          np.asarray(w["w8"]))
            flat = g["w8"].reshape(g["w8"].shape[0], -1).numpy()
            np.testing.assert_array_equal(g["wt"].numpy()[:, :flat.shape[1]],
                                          flat)
            assert not g["wt"].numpy()[:, flat.shape[1]:].any()
            for key in keys:
                np.testing.assert_array_equal(g[key].numpy(),
                                              np.asarray(w[key]))
            if not chained:
                assert np.float32(g["in_scale"]) == np.asarray(w["in_scale"])
                assert np.float32(g["inv_scale"]) == \
                    np.float32(1.0) / np.asarray(w["in_scale"])
    assert n_int8 == 72
    if chained:
        assert got["act"] == want["act"]


# (cin, cout, k, stride, spatial)
CONV_CASES = {"k1": (64, 32, 1, 1, 8), "k3_s1": (32, 64, 3, 1, 8),
              "k3_s2": (32, 64, 3, 2, 9), "cin3": (3, 32, 3, 1, 10)}


def _conv_case(name: str):
    cin, cout, k, stride, hw = CONV_CASES[name]
    rng = np.random.default_rng(sorted(CONV_CASES).index(name))
    x8 = rng.integers(-127, 128, (2, hw, hw, cin), dtype=np.int8)
    w8 = rng.integers(-127, 128, (k, k, cin, cout), dtype=np.int8)
    w_scale = rng.uniform(1e-3, 2e-2, cout).astype(np.float32)
    b = rng.normal(0, 0.5, cout).astype(np.float32)
    return x8, w8, w_scale, b, stride


def _port_entry(w8, **extra):
    t8 = torch.from_numpy(np.ascontiguousarray(w8.transpose(3, 0, 1, 2)))
    return {"w8": t8, "wt": I8.gemm_weight(t8),
            **{k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
               for k, v in extra.items()}}


@pytest.mark.parametrize("name", sorted(CONV_CASES))
def test_conv_int8_matches_jax(name):
    x8, w8, w_scale, b, stride = _conv_case(name)
    k = w8.shape[0]
    pad = (k - 1) // 2
    want = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x8), jnp.asarray(w8), (stride, stride),
        ((pad, pad), (pad, pad)), dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32))
    qp = _port_entry(w8)
    if name == "cin3":
        assert qp["wt"].shape == (32, 32)           # K = 27 padded to 32
    before = I8.int8_gemm.calls
    got = I8.conv_int8(_nchw(x8), qp["wt"], k, stride)
    assert I8.int8_gemm.calls == before + 1
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        I8.conv_int8_reference(_nchw(x8), qp["w8"], stride).numpy(), want)

    # _conv_int8: bf16 input quantized at in_scale, dequant epilogue
    rng = np.random.default_rng(7)
    x = rng.normal(0, 2, x8.shape).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    in_scale = float(np.abs(np.asarray(xb, np.float32)).max()) / 127.0
    jqp = {"w8": jnp.asarray(w8), "b": jnp.asarray(b),
           "eff_scale": jnp.asarray(w_scale * in_scale, jnp.float32),
           "in_scale": jnp.float32(in_scale)}
    s32 = np.float32(in_scale)
    tqp = _port_entry(w8, b=b, eff_scale=w_scale * in_scale,
                      in_scale=float(s32),
                      inv_scale=float(np.float32(1.0) / s32))
    want_y = jq._conv_int8(xb, jqp, stride)
    got_y = tq._conv_int8(_nchw(x).to(torch.bfloat16), tqp, stride)
    assert got_y.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(got_y), _bits(want_y))

    # _conv_int8_chained on JAX's own int8 input: int8 out with a residual
    # (same shape only), and bf16 out
    jqc = {"w8": jnp.asarray(w8), "b": jnp.asarray(b),
           "w_scale": jnp.asarray(w_scale)}
    tqc = _port_entry(w8, b=b, w_scale=w_scale)
    s_in, s_out = 0.0123, 0.0456
    ho = want.shape[1]
    short = (rng.integers(-127, 128, want.shape, dtype=np.int8), 0.037) \
        if ho == x8.shape[1] else None
    for out in (s_out, None):
        wy = jq._conv_int8_chained(
            jnp.asarray(x8), s_in, jqc, stride, s_out=out,
            shortcut=None if short is None else (jnp.asarray(short[0]),
                                                 short[1]))
        gy = tq._conv_int8_chained(
            _nchw(x8), s_in, tqc, stride, s_out=out,
            shortcut=None if short is None else (_nchw(short[0]), short[1]))
        assert gy.dtype == (torch.int8 if out else torch.bfloat16)
        np.testing.assert_array_equal(_bits(gy), _bits(wy))


def test_concat_split_conv_matches_jax():
    rng = np.random.default_rng(3)
    a8 = rng.integers(-127, 128, (2, 8, 8, 32), dtype=np.int8)
    b8 = rng.integers(-127, 128, (2, 8, 8, 64), dtype=np.int8)
    w8 = rng.integers(-127, 128, (1, 1, 96, 48), dtype=np.int8)
    w_scale = rng.uniform(1e-3, 2e-2, 48).astype(np.float32)
    b = rng.normal(0, 0.5, 48).astype(np.float32)
    want = jq._concat_split_conv(
        {"w8": jnp.asarray(w8), "w_scale": jnp.asarray(w_scale),
         "b": jnp.asarray(b)}, jnp.asarray(a8), 0.021, jnp.asarray(b8), 0.013,
        s_out=0.05)
    before = I8.int8_gemm.calls
    got = tq._concat_split_conv(_port_entry(w8, w_scale=w_scale, b=b),
                                _nchw(a8), 0.021, _nchw(b8), 0.013,
                                s_out=0.05)
    assert I8.int8_gemm.calls == before + 2
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_upsample_int8_matches_jax():
    x = np.random.default_rng(4).integers(-127, 128, (2, 3, 5, 16),
                                          dtype=np.int8)
    got = upsample_nearest_2x(_nchw(x))
    assert got.dtype == torch.int8
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(_bits(got),
                                  np.asarray(jax_upsample(jnp.asarray(x))))


def test_stem_boundaries_match_jax(setup):
    _, tvars, _, scales = setup
    assert tq.stem_int8_safe_boundaries() == jq.stem_int8_safe_boundaries()
    assert {9, 12} <= set(tq.stem_int8_safe_boundaries())
    with pytest.raises(ValueError, match="splits a residual block"):
        tq.build_stem_int8_packed(tvars, scales, C, upto=10)


# name -> (quantizer or stem upto, forward, head rewrite, int8 GEMMs)
def _forwards():
    return {
        "int8": ("quantize_model", "yolov3_forward_int8", None, 72),
        "int8_packed": ("quantize_model", "yolov3_forward_int8_packed",
                        "pack_serving_head", 72),
        "int8_split": ("quantize_model", "yolov3_forward_int8_split",
                       "split_serving_head", 72),
        "chained_packed": ("quantize_model_chained",
                           "yolov3_forward_int8_chained",
                           "pack_serving_head", 74),
        "chained_plain": ("quantize_model_chained",
                          "yolov3_forward_int8_chained", None, 74),
        "stem8_9": (9, "yolov3_forward_stem_int8_packed", None, 9),
        "stem8_12": (12, "yolov3_forward_stem_int8_packed", None, 12),
    }


@pytest.mark.parametrize("name", sorted(_forwards()))
def test_forward_matches_jax(name, setup):
    jvars, tvars, images, scales = setup
    build, fwd, head, gemms = _forwards()[name]
    if isinstance(build, int):
        jp = jq.build_stem_int8_packed(jvars, scales, C, upto=build)
        tp = tq.build_stem_int8_packed(tvars, scales, C, upto=build)
    else:
        jp, tp = getattr(jq, build)(jvars, scales), \
            getattr(tq, build)(tvars, scales)
        if head is not None:
            jp, tp = getattr(jfp, head)(jp, C), getattr(tfp, head)(tp, C)
    kw = {"head": "plain" if head is None else "packed"} \
        if name.startswith("chained") else {}
    want = getattr(jq, fwd)(jp, jnp.asarray(images), **kw)
    before = I8.int8_gemm.calls
    got = getattr(tq, fwd)(tp, torch.from_numpy(images), **kw)
    assert I8.int8_gemm.calls - before == gemms
    assert len(got) == len(want) == 3
    if name == "int8_split":          # (boxconf fp32, cls bf16) pairs
        assert [(b.dtype, c.dtype) for b, c in got] == \
            [(torch.float32, torch.bfloat16)] * 3
        # the equal share over all six outputs: a boxconf map at 2x2
        # holds only 120 values
        got = [np.concatenate([_bits(t, nchw=False).ravel()
                               for pair in got for t in pair])]
        want = [np.concatenate([_bits(t).ravel()
                                for pair in want for t in pair])]
    for g, w in zip(got, want):
        g, w = _bits(g, nchw=False), _bits(w)
        assert g.shape == w.shape
        assert np.isfinite(g).all()
        d = np.abs(g - w)
        mag = np.maximum(np.abs(g), np.abs(w))
        if name.startswith("stem8"):
            assert (d <= 2 * _bf16_ulp(np.maximum(mag, 0.5))).all(), d.max()
            assert (d == 0).mean() >= 0.9, (d == 0).mean()
        else:
            assert (d <= _bf16_ulp(mag)).all(), d.max()
            assert (d == 0).mean() >= 0.999, (d == 0).mean()
