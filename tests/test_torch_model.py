"""PyTorch port of the model against the JAX package, on the CPU.

Both packages get the same weights (a JAX-layout tree made with numpy from
a seed by testing.numpy_variables, carried across by from_jax_variables)
and the same images, and run in fp32. Tolerance atol 1e-5 on the feature maps: the two frameworks sum a
conv's products in different orders (oneDNN vs Eigen); the differences
measured on these shapes are below 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov3_tensorflow_tpu import config as jax_config
from yolov3_tensorflow_tpu.models import layers as jl
from yolov3_tensorflow_tpu.models import yolov3 as jy
from yolov3_tensorflow_tpu.ops import fast_postprocess as jfp
from yolov3_tensorflow_tpu_torch import config as port_config
from yolov3_tensorflow_tpu_torch.models import layers as tl
from yolov3_tensorflow_tpu_torch.models import yolov3 as ty
from yolov3_tensorflow_tpu_torch.models.convert import (from_jax_variables,
                                                        spread_head)
from yolov3_tensorflow_tpu_torch.ops import fast_postprocess as tfp
from yolov3_tensorflow_tpu_torch.testing import (CPU_TEST_THREADS,
                                                 numpy_variables)

torch.set_num_threads(CPU_TEST_THREADS)

CPU = torch.device("cpu")
NUM_CLASSES = 80


@pytest.fixture(scope="module")
def jax_vars():
    return numpy_variables(NUM_CLASSES)


@pytest.fixture(scope="module")
def torch_vars(jax_vars):
    return from_jax_variables(jax_vars, device=CPU)


@pytest.fixture(scope="module")
def jax_outputs(jax_vars):
    """JAX fp32 folded and packed outputs per image size, one jit each."""
    folded = jy.fold_batch_norm(jax_vars, dtype=jnp.float32)
    packed = jfp.pack_serving_head(folded, NUM_CLASSES, out_dtype=jnp.float32)

    @jax.jit
    def both(images):
        return (jy.yolov3_forward_folded(folded, images,
                                         compute_dtype=jnp.float32),
                jfp.yolov3_forward_packed(packed, images,
                                          compute_dtype=jnp.float32,
                                          out_dtype=jnp.float32))

    cache = {}

    def get(size):
        if size not in cache:
            img = images(size)
            f, p = both(jnp.asarray(img))
            cache[size] = {"folded": [np.asarray(x) for x in f],
                           "packed": [np.asarray(x) for x in p]}
        return cache[size]

    return get


def images(size: int) -> np.ndarray:
    rng = np.random.default_rng(size)
    return rng.uniform(0, 1, (2, size, size, 3)).astype(np.float32)


def test_plan_equals_jax_plan():
    assert ty.BACKBONE_PLAN == jy.BACKBONE_PLAN
    assert port_config.DEFAULT_ANCHORS == jax_config.DEFAULT_ANCHORS
    for c in (20, 80):
        assert ty.head_plan(c) == jy.head_plan(c)
        assert ty.darknet_layer_order(c) == jy.darknet_layer_order(c)
        assert ty._head_input_channels(c) == jy._head_input_channels(c)


def test_from_jax_variables_round_trips(jax_vars, torch_vars):
    want = jax.eval_shape(
        lambda: jy.init_yolov3(jax.random.PRNGKey(0), NUM_CLASSES))
    assert (jax.tree_util.tree_map(lambda a: a.shape, jax_vars)
            == jax.tree_util.tree_map(lambda a: a.shape, want))
    flat_j = jax.tree_util.tree_flatten_with_path(jax_vars)[0]
    assert len(flat_j) == len(jax.tree_util.tree_leaves(torch_vars))
    for path, leaf in flat_j:
        node = torch_vars
        for key in path:
            node = node[key.key]
        back = node.numpy()
        if leaf.ndim == 4:                         # OIHW -> HWIO
            assert node.shape == (leaf.shape[3], leaf.shape[2],
                                  leaf.shape[0], leaf.shape[1])
            back = np.transpose(back, (2, 3, 1, 0))
        np.testing.assert_array_equal(back, leaf)


def test_init_matches_jax_tree(torch_vars):
    """Same tree and shapes as the JAX init; glorot bounds; seeded."""
    v1 = ty.init_yolov3(torch.Generator().manual_seed(3), NUM_CLASSES,
                        device=CPU)
    v2 = ty.init_yolov3(torch.Generator().manual_seed(3), NUM_CLASSES,
                        device=CPU)
    shapes = jax.tree_util.tree_map(lambda t: tuple(t.shape), torch_vars)
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), v1) == shapes
    for scope, name, _ in ty.darknet_layer_order(NUM_CLASSES):
        w = v1["params"][scope][name]["w"]
        cout, cin, k, _ = w.shape
        lim = np.sqrt(6.0 / (k * k * (cin + cout)))
        assert float(w.abs().max()) <= lim * (1 + 1e-6)    # f32 rounding
        assert float(w.abs().max()) > 0.9 * lim
        assert torch.equal(w, v2["params"][scope][name]["w"])
    assert torch.equal(v1["batch_stats"]["backbone"]["conv_0"]["var"],
                       torch.ones(32))


def test_fold_batch_norm_matches_jax(jax_vars, torch_vars):
    fj = jy.fold_batch_norm(jax_vars, dtype=jnp.float32)
    ft = ty.fold_batch_norm(torch_vars, dtype=torch.float32)
    for scope in fj:
        for name, p in fj[scope].items():
            np.testing.assert_allclose(
                ft[scope][name]["w"].numpy(),
                np.transpose(np.asarray(p["w"]), (3, 2, 0, 1)), rtol=1e-6)
            np.testing.assert_allclose(ft[scope][name]["b"].numpy(),
                                       np.asarray(p["b"]), rtol=1e-6,
                                       atol=1e-7)


@pytest.mark.parametrize("size", [64, 96])
@pytest.mark.parametrize("kind", ["folded", "packed"])
def test_forward_matches_jax(kind, size, torch_vars, jax_outputs):
    folded = ty.fold_batch_norm(torch_vars, dtype=torch.float32)
    img = torch.from_numpy(images(size))
    if kind == "folded":
        got = ty.yolov3_forward_folded(folded, img,
                                       compute_dtype=torch.float32)
        row = 3 * (5 + NUM_CLASSES)
    else:
        packed = tfp.pack_serving_head(folded, NUM_CLASSES,
                                       out_dtype=torch.float32)
        got = tfp.yolov3_forward_packed(packed, img,
                                        compute_dtype=torch.float32,
                                        out_dtype=torch.float32)
        row = 3 * tfp.head_row_width(NUM_CLASSES)
    want = jax_outputs(size)[kind]
    for g, w, stride in zip(got, want, (32, 16, 8)):
        assert tuple(g.shape) == (2, size // stride, size // stride, row)
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5, rtol=0)


def test_spread_head_same_on_both_trees(torch_vars, jax_vars):
    """The same transform on either tree gives the same weights."""
    st = spread_head(torch_vars, seed=1)
    sj = spread_head(jax_vars, seed=1)
    for name in ("conv_6", "conv_14", "conv_22"):
        np.testing.assert_array_equal(st["params"]["head"][name]["b"].numpy(),
                                      sj["params"]["head"][name]["b"])
        np.testing.assert_array_equal(
            st["params"]["head"][name]["w"].numpy(),
            np.transpose(sj["params"]["head"][name]["w"], (3, 2, 0, 1)))
        assert not np.array_equal(sj["params"]["head"][name]["w"],
                                  jax_vars["params"]["head"][name]["w"])
    assert st["batch_stats"] is torch_vars["batch_stats"]


def _bf16_values(sign: str) -> np.ndarray:
    """Every finite bf16 value of one sign with |x| > 1e-30, as float32
    (bf16 is the top half of a float32). Below 1e-30 the products leave
    the normal range, where XLA on the CPU flushes subnormals."""
    bits = np.arange(0x8000, dtype=np.uint32) | (
        0x8000 if sign == "negative" else 0)
    vals = (bits << 16).view(np.float32)
    return vals[np.isfinite(vals) & (np.abs(vals) > 1e-30)]


@pytest.mark.parametrize("sign", ["negative", "positive"])
def test_bf16_leaky_relu_bit_equal_to_jax(sign):
    """JAX multiplies bf16 x by the weakly typed 0.1 rounded to bf16
    (0.10009765625); the port's slope is rounded the same way."""
    vals = _bf16_values(sign)
    x = torch.from_numpy(vals).to(torch.bfloat16)
    got = tl.leaky_relu(x)
    want = np.asarray(jl.leaky_relu(jnp.asarray(vals, jnp.bfloat16)),
                      np.float32)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    if sign == "negative":
        assert len(vals) > 29000
        # the fp32 slope rounds thousands of these values another way
        fp32_slope = torch.nn.functional.leaky_relu(x, 0.1)
        assert int((fp32_slope != got).sum()) > 1000


def test_bf16_conv_folded_epilogue_bit_equal_to_jax():
    """conv_folded (conv, bias add, LeakyReLU, all in bf16) with an exact
    1x1 identity conv, on every negative bf16 value of the test above."""
    vals = _bf16_values("negative")
    c = 8
    vals = np.concatenate([vals, vals[:(-len(vals)) % c]])
    x = vals.reshape(1, 1, -1, c)                          # NHWC
    eye = np.eye(c, dtype=np.float32)
    got = tl.conv_folded(
        torch.from_numpy(x).permute(0, 3, 1, 2),
        {"w": torch.from_numpy(eye)[:, :, None, None],     # OIHW
         "b": torch.zeros(c)}, compute_dtype=torch.bfloat16)
    want = jl.conv_folded(
        jnp.asarray(x), {"w": jnp.asarray(eye)[None, None],  # HWIO
                         "b": jnp.zeros(c)}, compute_dtype=jnp.bfloat16)
    assert got.dtype == torch.bfloat16
    got = got.permute(0, 2, 3, 1).float().numpy()
    np.testing.assert_array_equal(got, np.asarray(want, np.float32))
    np.testing.assert_array_equal(
        got, tl.leaky_relu(torch.from_numpy(x).to(torch.bfloat16))
        .float().numpy())
