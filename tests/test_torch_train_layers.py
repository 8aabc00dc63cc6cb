"""The port's live batch-norm layers against the JAX package's, on the CPU.

`batch_norm`, `conv_bn_leaky` and `neck_split_bn_leaky` at narrow widths
(8-16 channels, 8x8), in training and eval mode, in fp32: outputs, new
moving statistics, and the gradients (one VJP with a seeded cotangent)
with respect to the inputs and every parameter, each within 1e-5 of its
largest magnitude (the two frameworks sum the convs' products in different
orders). The bf16 training LeakyReLU is held bit-equal to JAX's, forward
and gradient, on every finite bf16 value and at +-0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov3_tensorflow_tpu.models import layers as jl
from yolov3_tensorflow_tpu_torch.models import layers as tl
from yolov3_tensorflow_tpu_torch.testing import CPU_TEST_THREADS

torch.set_num_threads(CPU_TEST_THREADS)

RTOL = 1e-5


def close(got, want, rtol=RTOL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"{what}: max err {err:.3g}, scale {scale:.3g}"


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


def oihw(w):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(w, (3, 2, 0, 1))))


def hwio(t):
    return np.transpose(t.detach().numpy(), (2, 3, 1, 0))


def bn_params(rng, c):
    p = {"gamma": rng.uniform(0.8, 1.2, c).astype(np.float32),
         "beta": rng.normal(0, 0.1, c).astype(np.float32)}
    s = {"mean": rng.normal(0, 0.1, c).astype(np.float32),
         "var": rng.uniform(0.8, 1.2, c).astype(np.float32)}
    return p, s


def conv_params(rng, k, cin, cout):
    p, s = bn_params(rng, cout)
    lim = np.sqrt(6.0 / (k * k * (cin + cout)))
    p["w"] = rng.uniform(-lim, lim, (k, k, cin, cout)).astype(np.float32)
    return p, s


def torch_leaves(p):
    """JAX-layout params -> torch leaves that take gradients."""
    return {k: (oihw(v) if v.ndim == 4 else torch.from_numpy(v.copy()))
            .requires_grad_(True) for k, v in p.items()}


def torch_stats(s):
    return {k: torch.from_numpy(v.copy()) for k, v in s.items()}


def check_grads(t_leaves, t_grads, j_grads, what):
    for (name, leaf), g in zip(t_leaves.items(), t_grads):
        want = j_grads[name]
        got = hwio(g) if leaf.ndim == 4 else g.numpy()
        close(got, want, what=f"{what} d{name}")


@pytest.mark.parametrize("train", [True, False])
def test_batch_norm(train):
    rng = np.random.default_rng(0)
    y = rng.normal(0.3, 1.5, (2, 8, 8, 16)).astype(np.float32)
    p, s = bn_params(rng, 16)
    ct = rng.normal(size=y.shape).astype(np.float32)

    def f(y, p):
        return jl.batch_norm(y, p, s, train=train)
    (jout, jstats), vjp = jax.vjp(f, jnp.asarray(y), p)
    jdy, jdp = vjp((jnp.asarray(ct), jax.tree_util.tree_map(jnp.zeros_like,
                                                            jstats)))

    ty = nchw(y).requires_grad_(True)
    tp = torch_leaves(p)
    tout, tstats = tl.batch_norm(ty, tp, torch_stats(s), train=train)
    grads = torch.autograd.grad(tout, [ty, *tp.values()], nchw(ct))
    close(nhwc(tout), jout, what="out")
    for k in ("mean", "var"):
        assert not tstats[k].requires_grad
        close(tstats[k].numpy(), jstats[k], what=k)
    close(nhwc(grads[0]), jdy, what="dy")
    check_grads(tp, grads[1:], jdp, "bn")


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("k,stride", [(3, 1), (3, 2), (1, 1)])
def test_conv_bn_leaky(k, stride, train):
    rng = np.random.default_rng(k * 10 + stride)
    x = rng.uniform(-1, 1, (2, 8, 8, 8)).astype(np.float32)
    p, s = conv_params(rng, k, 8, 16)

    def f(x, p):
        return jl.conv_bn_leaky(x, p, s, stride=stride, train=train,
                                compute_dtype=jnp.float32)
    (jout, jstats), vjp = jax.vjp(f, jnp.asarray(x), p)
    ct = rng.normal(size=jout.shape).astype(np.float32)
    jdx, jdp = vjp((jnp.asarray(ct), jax.tree_util.tree_map(jnp.zeros_like,
                                                            jstats)))

    tx = nchw(x).requires_grad_(True)
    tp = torch_leaves(p)
    tout, tstats = tl.conv_bn_leaky(tx, tp, torch_stats(s), stride=stride,
                                    train=train, compute_dtype=torch.float32)
    grads = torch.autograd.grad(tout, [tx, *tp.values()], nchw(ct))
    close(nhwc(tout), jout, what="out")
    for key in ("mean", "var"):
        close(tstats[key].numpy(), jstats[key], what=key)
    close(nhwc(grads[0]), jdx, what="dx")
    check_grads(tp, grads[1:], jdp, "conv_bn_leaky")


@pytest.mark.parametrize("train", [True, False])
def test_neck_split_bn_leaky(train):
    rng = np.random.default_rng(7)
    inter = rng.uniform(-1, 1, (2, 4, 4, 16)).astype(np.float32)
    route = rng.uniform(-1, 1, (2, 8, 8, 8)).astype(np.float32)
    p_lat, s_lat = conv_params(rng, 1, 16, 8)
    p_first, s_first = conv_params(rng, 1, 8 + 8, 12)

    def f(inter, route, p_lat, p_first):
        return jl.neck_split_bn_leaky(inter, route, p_lat, s_lat, p_first,
                                      s_first, train=train,
                                      compute_dtype=jnp.float32)
    (jout, js_lat, js_first), vjp = jax.vjp(
        f, jnp.asarray(inter), jnp.asarray(route), p_lat, p_first)
    ct = rng.normal(size=jout.shape).astype(np.float32)
    zeros = jax.tree_util.tree_map(jnp.zeros_like, (js_lat, js_first))
    jd_inter, jd_route, jd_lat, jd_first = vjp((jnp.asarray(ct), *zeros))

    t_inter = nchw(inter).requires_grad_(True)
    t_route = nchw(route).requires_grad_(True)
    t_lat, t_first = torch_leaves(p_lat), torch_leaves(p_first)
    tout, ts_lat, ts_first = tl.neck_split_bn_leaky(
        t_inter, t_route, t_lat, torch_stats(s_lat), t_first,
        torch_stats(s_first), train=train, compute_dtype=torch.float32)
    grads = torch.autograd.grad(
        tout, [t_inter, t_route, *t_lat.values(), *t_first.values()],
        nchw(ct))
    assert tuple(tout.shape) == (2, 12, 8, 8)
    close(nhwc(tout), jout, what="out")
    for got, want in ((ts_lat, js_lat), (ts_first, js_first)):
        for key in ("mean", "var"):
            close(got[key].numpy(), want[key], what=key)
    close(nhwc(grads[0]), jd_inter, what="d_inter")
    close(nhwc(grads[1]), jd_route, what="d_route")
    check_grads(t_lat, grads[2:5], jd_lat, "lateral")
    check_grads(t_first, grads[5:], jd_first, "first")


def test_neck_split_adds_in_compute_dtype():
    """In bf16 the two halves are added in bf16 (JAX's training junction),
    not in fp32 as the serving junction adds them: the pre-BN sum is the
    bf16 sum of the bf16 halves."""
    rng = np.random.default_rng(3)
    inter = rng.uniform(-1, 1, (1, 2, 2, 8)).astype(np.float32)
    route = rng.uniform(-1, 1, (1, 4, 4, 8)).astype(np.float32)
    p_lat, s_lat = conv_params(rng, 1, 8, 8)
    p_first, s_first = conv_params(rng, 1, 16, 8)
    want = jl.neck_split_bn_leaky(
        jnp.asarray(inter), jnp.asarray(route), p_lat, s_lat, p_first,
        s_first, train=False, compute_dtype=jnp.bfloat16)[0]
    got = tl.neck_split_bn_leaky(
        nchw(inter), nchw(route), torch_leaves(p_lat), torch_stats(s_lat),
        torch_leaves(p_first), torch_stats(s_first), train=False,
        compute_dtype=torch.bfloat16)[0]
    assert got.dtype == torch.bfloat16
    # bf16 convs may round their fp32 sums differently on the two CPUs:
    # hold the result to one bf16 ulp of JAX's
    np.testing.assert_allclose(nhwc(got.float()),
                               np.asarray(want, np.float32), rtol=2 ** -7,
                               atol=2 ** -7)


def _bf16_values() -> np.ndarray:
    """Every finite bf16 value with |x| > 1e-30, both zeros, as float32.
    Below 1e-30 the products leave the normal range, where XLA on the CPU
    flushes subnormals."""
    bits = np.arange(0x10000, dtype=np.uint32)
    vals = (bits << 16).view(np.float32)
    keep = np.isfinite(vals) & ((np.abs(vals) > 1e-30) | (vals == 0))
    return vals[keep]


def test_bf16_train_leaky_relu_bit_equal_to_jax():
    vals = _bf16_values()
    assert (vals == 0).sum() == 2
    cts = np.random.default_rng(5).normal(size=vals.shape).astype(np.float32)
    x = torch.from_numpy(vals).to(torch.bfloat16).requires_grad_(True)
    ct = torch.from_numpy(cts).to(torch.bfloat16)
    out = tl.leaky_relu_train(x)
    (grad,) = torch.autograd.grad(out, x, ct)
    jout, vjp = jax.vjp(jl.leaky_relu, jnp.asarray(vals, jnp.bfloat16))
    (jgrad,) = vjp(jnp.asarray(cts, jnp.bfloat16))
    assert out.dtype == grad.dtype == torch.bfloat16
    np.testing.assert_array_equal(out.detach().float().numpy(),
                                  np.asarray(jout, np.float32))
    np.testing.assert_array_equal(grad.float().numpy(),
                                  np.asarray(jgrad, np.float32))
    # the forward is the serving leaky_relu's; at 0 the gradient is the
    # cotangent itself, where F.leaky_relu's is the slope times it
    np.testing.assert_array_equal(out.detach().float().numpy(),
                                  tl.leaky_relu(x.detach()).float().numpy())
    zero = vals == 0
    np.testing.assert_array_equal(grad.float().numpy()[zero],
                                  ct.float().numpy()[zero])
    xs = x.detach().requires_grad_(True)
    (f_grad,) = torch.autograd.grad(tl.leaky_relu(xs), xs, ct)
    assert not np.array_equal(f_grad.float().numpy()[zero],
                              ct.float().numpy()[zero])
