"""The port's live-BN forward of the whole model against the JAX package's.

Full-width COCO-80 YOLOv3 at 64x64, fp32, from one seeded weight tree
(testing.numpy_variables, carried across by from_jax_variables), batch 4:
`yolov3_forward(train=True)`'s feature maps and new batch statistics and the
loss terms within 1e-4 of each tensor's largest magnitude (75 convs whose
products the two frameworks sum in different orders), and the eval forward
(train=False) with the gradient of its loss + L2 with respect to every
parameter leaf, within 1e-4 of each leaf's largest magnitude.

The gradient of the training forward is another matter. In fp32 it is
reproducible only to about 1e-2 in norm, by JAX itself: the same JAX step
on the same batch in reversed order (mathematically the same gradient)
moves the whole gradient by 7e-3 of its norm and single leaves by up to 3e-2
(and single elements by up to 40% of their leaf's largest), because the 72
training-mode batch norms amplify fp32 rounding; with the moments and the
normalization in fp64 the same reordering moves it by 2e-6. (At batch 2
even fp64 is ill-conditioned there: a 1e-7 change of the input moves a leaf
by 15%, hence batch 4.) So the training gradient is held to what JAX can
promise: the three detection convs, whose gradients reach them through no
batch norm, within 1e-4 of each leaf's largest; every leaf within twice
JAX's own reordering noise in norm. The layers themselves are held to JAX's
gradients at 1e-5 in tests/test_torch_train_layers.py. One module-scoped
JAX compile.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov3_tensorflow_tpu.models import yolov3 as jy
from yolov3_tensorflow_tpu.ops import losses as jlo
from yolov3_tensorflow_tpu_torch.config import DEFAULT_ANCHORS
from yolov3_tensorflow_tpu_torch.data.encoder import encode_labels
from yolov3_tensorflow_tpu_torch.models import yolov3 as ty
from yolov3_tensorflow_tpu_torch.models.convert import from_jax_variables
from yolov3_tensorflow_tpu_torch.ops import losses as tlo
from yolov3_tensorflow_tpu_torch.testing import (CPU_TEST_THREADS,
                                                 numpy_variables)
from yolov3_tensorflow_tpu_torch.train.optimizers import flatten, unflatten

torch.set_num_threads(CPU_TEST_THREADS)

C = 80
SIZE = 64
BATCH = 4
RTOL = 1e-4
ANCHORS = np.asarray(DEFAULT_ANCHORS, np.float32)
LOSS = dict(use_label_smooth=True, use_focal_loss=True)


def close(got, want, rtol=RTOL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"{what}: max err {err:.3g}, scale {scale:.3g}"


def hwio(g: np.ndarray) -> np.ndarray:
    """A gradient leaf in the JAX layout (conv kernels OIHW -> HWIO)."""
    return np.transpose(g, (2, 3, 1, 0)) if g.ndim == 4 else g


def fro(a, b) -> float:
    """|a - b| / |b| in the Frobenius norm."""
    return float(np.linalg.norm(np.ravel(a) - np.ravel(b))
                 / np.linalg.norm(np.ravel(b)))


def inputs():
    rng = np.random.default_rng(1)
    images = rng.uniform(0, 1, (BATCH, SIZE, SIZE, 3)).astype(np.float32)
    grids = []
    for _ in range(BATCH):
        xy = rng.uniform(0, 40, (3, 2))
        boxes = np.concatenate([xy, xy + rng.uniform(8, 24, (3, 2))], 1)
        grids.append(encode_labels(boxes.astype(np.float32),
                                   rng.integers(0, C, 3), (SIZE, SIZE), C,
                                   ANCHORS))
    y_true = [np.stack([g[s] for g in grids]) for s in range(3)]
    return images, y_true


@pytest.fixture(scope="module")
def case():
    variables = numpy_variables(C, seed=2)
    images, y_true = inputs()

    @jax.jit
    def run(params, stats, images, y_true):
        def loss_fn(params, train):
            fmaps, new_stats = jy.yolov3_forward(
                {"params": params, "batch_stats": stats}, images, train=train,
                compute_dtype=jnp.float32)
            losses = jlo.compute_loss(fmaps, y_true, ANCHORS, C,
                                      (SIZE, SIZE), **LOSS)
            l2 = jlo.l2_regularization(params, 5e-4)
            return losses["total"] + l2, (fmaps, new_stats, losses)
        grads, aux = jax.grad(loss_fn, has_aux=True)(params, True)
        eval_grads, (eval_fmaps, _, _) = jax.grad(loss_fn, has_aux=True)(
            params, False)
        return grads, aux, eval_grads, eval_fmaps

    args = (variables["params"], variables["batch_stats"])
    grads, (fmaps, new_stats, losses), eval_grads, eval_fmaps = \
        jax.device_get(run(*args, jnp.asarray(images),
                           [jnp.asarray(y) for y in y_true]))
    rev = slice(None, None, -1)                # the batch in reverse order
    rev_grads = jax.device_get(run(*args, jnp.asarray(images[rev]),
                                   [jnp.asarray(y[rev]) for y in y_true])[0])
    want = {"grads": flatten(grads), "rev_grads": flatten(rev_grads),
            "fmaps": fmaps, "stats": new_stats, "losses": losses,
            "eval_grads": flatten(eval_grads), "eval_fmaps": eval_fmaps}

    tv = from_jax_variables(variables, device=torch.device("cpu"))
    timages = torch.from_numpy(images)
    got = {}
    for train in (True, False):
        live = {p: t.detach().requires_grad_(True)
                for p, t in flatten(tv["params"]).items()}
        tfmaps, tstats = ty.yolov3_forward(
            {"params": unflatten(live), "batch_stats": tv["batch_stats"]},
            timages, train=train, compute_dtype=torch.float32)
        tlosses = tlo.compute_loss(tfmaps,
                                   [torch.from_numpy(y) for y in y_true],
                                   ANCHORS, C, (SIZE, SIZE), **LOSS)
        l2 = tlo.l2_regularization(unflatten(live), 5e-4)
        tgrads = torch.autograd.grad(tlosses["total"] + l2,
                                     list(live.values()))
        grads = {p: hwio(g.numpy()) for p, g in zip(live, tgrads)}
        if train:
            got.update(grads=grads, fmaps=tfmaps, stats=tstats,
                       losses=tlosses)
        else:
            got.update(eval_grads=grads, eval_fmaps=tfmaps)
    with torch.no_grad():
        got["literal"] = ty.yolov3_forward(
            tv, timages, train=True, compute_dtype=torch.float32,
            split_neck=False)
    return got, want


def test_train_forward_feature_maps(case):
    got, want = case
    for s, (g, w) in enumerate(zip(got["fmaps"], want["fmaps"])):
        assert g.dtype == torch.float32
        assert tuple(g.shape) == (BATCH, SIZE // (32 >> s), SIZE // (32 >> s),
                                  3 * (5 + C))
        close(g.detach().numpy(), w, what=f"fmap {s}")


def test_train_forward_batch_stats(case):
    got, want = case
    names = [(s, n) for s in want["stats"] for n in want["stats"][s]]
    assert len(names) == 72          # every BN conv: 52 + 20
    for scope, name in names:
        for k in ("mean", "var"):
            t = got["stats"][scope][name][k]
            assert not t.requires_grad
            close(t.numpy(), want["stats"][scope][name][k],
                  what=f"{scope}/{name}/{k}")


def test_loss_terms(case):
    got, want = case
    for k in tlo.LOSS_TERMS:
        close(got["losses"][k].item(), float(want["losses"][k]), what=k)


DETECTION = [f"head/{n}/{k}" for n in ("conv_6", "conv_14", "conv_22")
             for k in ("w", "b")]


def test_detection_conv_gradients(case):
    """The detection convs' gradients reach them through no batch norm."""
    got, want = case
    for path in DETECTION:
        close(got["grads"][path], want["grads"][path], what=path)


def test_training_gradients_within_jax_noise(case):
    """Every leaf's training gradient is as close to JAX's as JAX's is to
    itself on the batch in reverse order (see the module docstring)."""
    got, want = case
    j, jr, g = want["grads"], want["rev_grads"], got["grads"]
    assert set(g) == set(j)

    def whole(d):
        return np.concatenate([d[p].ravel() for p in j])
    noise = fro(whole(jr), whole(j))
    assert 0 < noise < 2e-2, noise
    assert fro(whole(g), whole(j)) <= 2 * noise + 1e-4
    leaf_noise = max(fro(jr[p], j[p]) for p in j)
    for path in j:
        assert fro(g[path], j[path]) <= 2 * leaf_noise + 1e-4, path


def test_eval_forward_and_gradients_of_every_leaf(case):
    got, want = case
    for s, (g, w) in enumerate(zip(got["eval_fmaps"], want["eval_fmaps"])):
        close(g.detach().numpy(), w, what=f"eval fmap {s}")
    assert set(got["eval_grads"]) == set(want["eval_grads"])
    assert len(got["eval_grads"]) == 72 * 3 + 3 * 2
    for path, g in got["eval_grads"].items():
        close(g, want["eval_grads"][path], what=path)


def test_split_neck_equals_literal_junction(case):
    """The split junction gives the literal upsample + concat + conv's
    feature maps and statistics (up to the order of the sums)."""
    got, _ = case
    lit_fmaps, lit_stats = got["literal"]
    for g, w in zip(got["fmaps"], lit_fmaps):
        close(g.detach().numpy(), w.numpy(), rtol=1e-5, what="fmap")
    for name in ("conv_7", "conv_8", "conv_15", "conv_16"):
        for k in ("mean", "var"):
            close(got["stats"]["head"][name][k].numpy(),
                  lit_stats["head"][name][k].numpy(), rtol=1e-5, what=name)
