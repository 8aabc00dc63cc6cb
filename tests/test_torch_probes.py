"""The probe kernels of the PyTorch port (K3, K4) against the JAX ones.

On the CPU, each JAX kernel body of `scripts/exp_mxu_shapes.py`
(`_rate_kernel`, `_concat_kernel`; the script is imported by path and not
changed) runs through its own `pl.pallas_call(..., interpret=True)` with a
64-row block, no memory-space annotation and 2 grid steps, on the same
seeded bf16 inputs as the port's plain versions:

- `mma_chain_reference` against `_rate_kernel` at (k, n) in {(108, 128),
  (512, 64), (128, 64)}, reps 8: max|diff| / max|ref| <= 1e-5 (both sum
  the same exact bf16 products in fp32, in different orders);
- `concat_patches_reference` against `_concat_kernel` at c in {32, 64},
  mt 64: bit for bit (a copy).

The `cuda` tests hold the CUDA kernels to their plain versions on the card
(`python -m pytest --noconftest -m cuda tests/test_torch_probes.py`; JAX
is imported inside a fixture, and the GPU machine has none).
"""

import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from yolov3_tensorflow_tpu_torch.scripts import exp_mxu_shapes as probes

ROOT = Path(__file__).resolve().parents[1]
BLOCK = 64                      # rows per grid step, 2 steps


@pytest.fixture(scope="module")
def jprobe():
    pytest.importorskip("jax")
    spec = importlib.util.spec_from_file_location(
        "jax_exp_mxu_shapes", ROOT / "scripts" / "exp_mxu_shapes.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bf16(rng: np.random.Generator, shape) -> np.ndarray:
    """Standard normal values rounded to bf16, held as float32."""
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return x.to(torch.bfloat16).float().numpy()


def _jax_rate(jprobe, a: np.ndarray, b: np.ndarray, reps: int) -> np.ndarray:
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    m, k = a.shape
    n = b.shape[1]
    f = pl.pallas_call(
        functools.partial(jprobe._rate_kernel, reps=reps),
        grid=(m // BLOCK,),
        in_specs=[pl.BlockSpec((BLOCK, k), lambda i: (i, 0)),
                  pl.BlockSpec((k, n), lambda i: (0, 0))],
        out_specs=pl.BlockSpec((BLOCK, n), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((m, n), jnp.float32),
        interpret=True)
    return np.asarray(f(jnp.asarray(a, jnp.bfloat16),
                        jnp.asarray(b, jnp.bfloat16)))


def _jax_concat(jprobe, x: np.ndarray, taps: int) -> np.ndarray:
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    m, c = x.shape
    mo = BLOCK - 16
    f = pl.pallas_call(
        functools.partial(jprobe._concat_kernel, taps=taps, mt=BLOCK),
        grid=(m // BLOCK,),
        in_specs=[pl.BlockSpec((BLOCK, c), lambda i: (i, 0))],
        out_specs=pl.BlockSpec((mo, taps * c), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((m // BLOCK * mo, taps * c),
                                       jnp.bfloat16),
        interpret=True)
    return np.asarray(f(jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))


@pytest.mark.parametrize("k,n", [(108, 128), (512, 64), (128, 64)])
def test_mma_chain_reference_matches_jax_kernel(k, n, jprobe):
    rng = np.random.default_rng(k + n)
    a, b = _bf16(rng, (2 * BLOCK, k)), _bf16(rng, (k, n))
    want = _jax_rate(jprobe, a, b, reps=8)
    got = probes.mma_chain_reference(
        torch.from_numpy(a).to(torch.bfloat16),
        torch.from_numpy(b).to(torch.bfloat16), 8, mt=BLOCK).numpy()
    assert got.dtype == np.float32 and got.shape == (2 * BLOCK, n)
    assert np.abs(got - want).max() / np.abs(want).max() <= 1e-5


@pytest.mark.parametrize("c", [32, 64])
def test_concat_patches_reference_matches_jax_kernel(c, jprobe):
    x = _bf16(np.random.default_rng(c), (2 * BLOCK, c))
    want = _jax_concat(jprobe, x, taps=9)
    got = probes.concat_patches_reference(
        torch.from_numpy(x).to(torch.bfloat16), taps=9, mt=BLOCK)
    assert got.dtype == torch.bfloat16
    assert got.shape == (2 * (BLOCK - 16), 9 * c)
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_mma_chain_reference_is_reps_times_the_product():
    rng = np.random.default_rng(3)
    a = torch.from_numpy(_bf16(rng, (2 * BLOCK, 48))).to(torch.bfloat16)
    b = torch.from_numpy(_bf16(rng, (48, 32))).to(torch.bfloat16)
    once = probes.mma_chain_reference(a, b, 1, mt=BLOCK)
    torch.testing.assert_close(once, a.float() @ b.float(), rtol=0, atol=0)
    five = probes.mma_chain_reference(a, b, 5, mt=BLOCK)
    torch.testing.assert_close(five, 5 * once, rtol=1e-6, atol=1e-4)
    assert not probes.mma_chain_reference(a, b, 0, mt=BLOCK).any()


def test_cpu_tensors_take_the_plain_versions():
    rng = np.random.default_rng(4)
    a = torch.from_numpy(_bf16(rng, (probes.MT, 40))).to(torch.bfloat16)
    b = torch.from_numpy(_bf16(rng, (40, 32))).to(torch.bfloat16)
    x = torch.from_numpy(_bf16(rng, (2 * probes.MT, 16))).to(torch.bfloat16)
    before = (probes.mma_chain.launches, probes.concat_patches.launches)
    assert torch.equal(probes.mma_chain(a, b, 3),
                       probes.mma_chain_reference(a, b, 3))
    assert torch.equal(probes.concat_patches(x),
                       probes.concat_patches_reference(x))
    assert (probes.mma_chain.launches,
            probes.concat_patches.launches) == before


def test_wrappers_reject_tensors_off_cpu_and_cuda():
    a = torch.zeros((64, 16), dtype=torch.bfloat16, device="meta")
    b = torch.zeros((16, 32), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError):
        probes.mma_chain(a, b, 2)
    with pytest.raises(ValueError):
        probes.concat_patches(torch.zeros((1024, 32), dtype=torch.bfloat16,
                                          device="meta"))


def test_plain_patch_build_rejects_windows_outside_the_block():
    x = torch.zeros((128, 8), dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        probes.concat_patches_reference(x, taps=18, mt=64)
    with pytest.raises(ValueError):
        probes.concat_patches_reference(x, taps=9, mt=48)


@pytest.mark.parametrize("name,k,n", probes.SHAPES)
def test_every_stem_shape_has_a_tile_that_fits(name, k, n):
    bn, smem = probes.mma_tile(k, n)
    assert n % bn == 0 and smem <= probes.SMEM_LIMIT
    kp = -(-k // 16) * 16
    assert smem == 2 * (probes.TILE_M * (kp + 8) + kp * (bn + 8))
    # the widest tile that fits: the next wider one divides n but overflows
    wider = [t for t in probes.TILES_N if t > bn and n % t == 0]
    for t in wider:
        assert 2 * (probes.TILE_M * (kp + 8) + kp * (t + 8)) \
            > probes.SMEM_LIMIT, name


def test_tile_choice_refuses_what_no_tile_fits():
    assert probes.mma_tile(1104, 32)[0] == 32
    with pytest.raises(ValueError):
        probes.mma_tile(1105, 32)
    with pytest.raises(ValueError):
        probes.mma_tile(128, 48)


def test_measurements_need_a_gpu():
    with pytest.raises(RuntimeError):
        probes.mma_rate(1024, 128, 64, device=torch.device("cpu"))
    with pytest.raises(RuntimeError):
        probes.concat_rate(2048, 32, device=torch.device("cpu"))


def test_operands_are_drawn_as_the_jax_probe_draws_them():
    a, b = probes.mma_operands(64, 12, 32, torch.device("cpu"))
    rng = np.random.default_rng(0)
    want_a = rng.standard_normal((64, 12)).astype(np.float32)
    want_b = rng.standard_normal((12, 32)).astype(np.float32)
    for got, want in ((a, want_a), (b, want_b)):
        assert got.dtype == torch.bfloat16
        assert torch.equal(got, torch.from_numpy(want).to(torch.bfloat16))


@pytest.mark.cuda
def test_cuda_mma_chain_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    for k, n, reps in ((108, 128, 8), (1024, 128, 4), (40, 32, 3),
                       (30, 64, 2)):
        a, b = probes.mma_operands(2 * probes.MT, k, n, dev)
        before = probes.mma_chain.launches
        got = probes.mma_chain(a, b, reps)
        torch.cuda.synchronize()
        assert probes.mma_chain.launches == before + 1
        want = probes.mma_chain_reference(a, b, reps)
        rel = float((got - want).abs().max() / want.abs().max())
        assert rel <= 1e-4, (k, n, rel)
    with pytest.raises(ValueError, match="multiple of 64"):
        probes.mma_chain(a[:100], b, 2)


@pytest.mark.cuda
def test_cuda_concat_patches_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    for c, taps, mt in ((32, 9, 1024), (128, 9, 1024), (8, 17, 64),
                        (24, 1, 200)):
        x = probes.patch_operand(4 * mt, c, dev)
        before = probes.concat_patches.launches
        got = probes.concat_patches(x, taps, mt)
        torch.cuda.synchronize()
        assert probes.concat_patches.launches == before + 1
        assert torch.equal(got, probes.concat_patches_reference(x, taps, mt))
