"""The port's YOLOv3 loss against the JAX package's, on the CPU.

On the fixtures of tests/test_loss.py (a seeded 4x4 grid with a few ground
truth boxes and mixup weights; label smoothing and focal loss on and off;
the reference and GIoU box losses; an image with no objects; more occupied
cells than `max_gt`, where the order of the ignore mask's selection
decides which boxes count) and on the three scales of a 64x64 input: every
loss term within 1e-5 relative, and the gradients with respect to the
feature maps within 1e-5 of their largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov3_tensorflow_tpu.models.decode import decode_feature_map
from yolov3_tensorflow_tpu.ops import boxes as jb
from yolov3_tensorflow_tpu.ops import losses as jlo
from yolov3_tensorflow_tpu_torch.ops import boxes as tb
from yolov3_tensorflow_tpu_torch.ops import losses as tlo
from yolov3_tensorflow_tpu_torch.testing import CPU_TEST_THREADS

torch.set_num_threads(CPU_TEST_THREADS)

RTOL = 1e-5
WEIGHTS = (1.0, 0.7, 0.3, 1.3)    # terms mixed for one gradient check
ANCHORS = np.array([[10, 13], [16, 30], [33, 23], [30, 61], [62, 45],
                    [59, 119], [116, 90], [156, 198], [373, 326]], np.float32)


def close(got, want, rtol=RTOL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"{what}: max err {err:.3g}, scale {scale:.3g}"


def make_case(seed, n=2, hg=4, wg=4, c=3, boxes_per_image=3):
    """tests/test_loss.py's `_make_case`."""
    rng = np.random.RandomState(seed)
    img_size = (hg * 32, wg * 32)
    anchors = np.array([[30, 61], [62, 45], [59, 119]], np.float32)
    fmap = rng.randn(n, hg, wg, 3 * (5 + c)).astype(np.float32) * 0.5
    y_true = np.zeros((n, hg, wg, 3, 6 + c), np.float32)
    y_true[..., -1] = 1.0
    for b in range(n):
        for _ in range(boxes_per_image):
            y, x, a = rng.randint(hg), rng.randint(wg), rng.randint(3)
            cx = (x + rng.uniform(0.1, 0.9)) * 32
            cy = (y + rng.uniform(0.1, 0.9)) * 32
            w = rng.uniform(10, 80)
            h = rng.uniform(10, 80)
            y_true[b, y, x, a, 0:4] = [cx, cy, w, h]
            y_true[b, y, x, a, 4] = 1.0
            y_true[b, y, x, a, 5 + rng.randint(c)] = 1.0
            y_true[b, y, x, a, -1] = rng.uniform(0.3, 1.0)
    return fmap, y_true, anchors, c, img_size


def both_loss_scale(fmap, y_true, anchors, c, img_size, **kw):
    """(JAX terms, JAX d(weighted sum)/dfmap, port terms, port gradient)."""
    def jtotal(f):
        out = jlo.loss_scale(f, jnp.asarray(y_true), anchors, c, img_size,
                             **kw)
        return sum(w * t for w, t in zip(WEIGHTS, out)), out
    (_, jterms), jgrad = jax.jit(jax.value_and_grad(jtotal, has_aux=True))(
        jnp.asarray(fmap))
    tf = torch.from_numpy(fmap.copy()).requires_grad_(True)
    tterms = tlo.loss_scale(tf, torch.from_numpy(y_true), anchors, c,
                            img_size, **kw)
    (tgrad,) = torch.autograd.grad(
        sum(w * t for w, t in zip(WEIGHTS, tterms)), tf)
    return jterms, np.asarray(jgrad), tterms, tgrad.numpy()


@pytest.mark.parametrize("smooth,focal,box_loss", [
    (False, False, "reference"), (True, True, "reference"),
    (True, False, "reference"), (False, True, "giou"), (True, True, "giou")])
def test_loss_scale_matches_jax(smooth, focal, box_loss):
    case = make_case(0)
    jterms, jgrad, tterms, tgrad = both_loss_scale(
        *case, use_label_smooth=smooth, use_focal_loss=focal,
        box_loss=box_loss)
    for name, t, j in zip(("xy", "wh", "conf", "class"), tterms, jterms):
        assert t.dtype == torch.float32 and t.ndim == 0
        close(t.item(), float(j), what=name)
    assert float(jterms[0]) > 0 and float(jterms[3]) > 0
    close(tgrad, jgrad, what="d fmap")


def test_empty_image():
    fmap, y_true, anchors, c, img_size = make_case(1, n=1)
    y_true[...] = 0.0
    y_true[..., -1] = 1.0
    jterms, jgrad, tterms, tgrad = both_loss_scale(fmap, y_true, anchors, c,
                                                   img_size)
    assert [t.item() for t in tterms[:2]] == [0.0, 0.0]
    assert tterms[3].item() == 0.0
    close(tterms[2].item(), float(jterms[2]), what="conf")
    close(tgrad, jgrad, what="d fmap")


def test_more_occupied_cells_than_max_gt():
    """40 occupied cells of 48, max_gt 8: the ignore mask compares each cell
    with the first 8 occupied cells in index order, as lax.top_k orders
    ties; a selection in another order changes the mask."""
    fmap, y_true, anchors, c, img_size = make_case(2, n=2, c=3,
                                                   boxes_per_image=60)
    occupied = (y_true[..., 4] > 0).sum(axis=(1, 2, 3))
    assert (occupied > 8).all()
    # big predicted boxes so that many cells overlap the ground truth
    fmap = fmap.copy().reshape(2, 4, 4, 3, 8)
    fmap[..., 2:4] += 1.0
    fmap = fmap.reshape(2, 4, 4, 24)
    _, pred_boxes, _, _ = decode_feature_map(jnp.asarray(fmap), anchors, c,
                                             img_size)
    want = np.asarray(jlo._ignore_mask(pred_boxes, jnp.asarray(y_true),
                                       max_gt=8))
    got = tlo._ignore_mask(torch.from_numpy(np.array(pred_boxes)),
                           torch.from_numpy(y_true), max_gt=8).numpy()
    np.testing.assert_array_equal(got, want)
    # the mask depends on which 8 boxes are taken: the last 8 occupied
    # cells give another one
    obj = y_true[..., 4].reshape(2, -1)
    last = np.zeros_like(y_true)
    for b in range(2):
        idx = np.nonzero(obj[b])[0][-8:]
        flat = last[b].reshape(-1, y_true.shape[-1])
        flat[idx] = y_true[b].reshape(-1, y_true.shape[-1])[idx]
    other = np.asarray(jlo._ignore_mask(pred_boxes, jnp.asarray(last),
                                        max_gt=8))
    assert not np.array_equal(other, want)
    jterms, jgrad, tterms, tgrad = both_loss_scale(
        fmap, y_true, anchors, c, img_size, max_gt=8, use_focal_loss=True)
    for name, t, j in zip(("xy", "wh", "conf", "class"), tterms, jterms):
        close(t.item(), float(j), what=name)
    close(tgrad, jgrad, what="d fmap")


def test_grad_finite_under_wh_logit_overflow():
    """A wh logit past exp's float32 overflow (~88.7) leaves the gradient
    finite and equal to JAX's: the wh term is taken from the raw logits."""
    fmap, y_true, anchors, c, img_size = make_case(3)
    fmap = fmap.copy()
    fmap[0, 1, 1, 2] = 95.0
    fmap[1, 2, 2, 3 + (5 + c)] = 120.0
    jterms, jgrad, tterms, tgrad = both_loss_scale(
        fmap, y_true, anchors, c, img_size, use_focal_loss=True,
        use_label_smooth=True)
    assert np.isfinite(tgrad).all()
    for name, t, j in zip(("xy", "wh", "conf", "class"), tterms, jterms):
        close(t.item(), float(j), what=name)
    close(tgrad, jgrad, what="d fmap")


def _scales(seed, size=64, c=2):
    rng = np.random.RandomState(seed)
    fmaps, y_trues = [], []
    for s in (32, 16, 8):
        g = size // s
        fmaps.append((rng.randn(2, g, g, 3 * (5 + c)) * 0.3)
                     .astype(np.float32))
        yt = np.zeros((2, g, g, 3, 6 + c), np.float32)
        yt[..., -1] = 1.0
        for b in range(2):
            y, x, a = rng.randint(g), rng.randint(g), rng.randint(3)
            yt[b, y, x, a, 0:4] = [(x + 0.5) * s, (y + 0.5) * s,
                                   rng.uniform(8, 60), rng.uniform(8, 60)]
            yt[b, y, x, a, 4] = 1.0
            yt[b, y, x, a, 5 + rng.randint(c)] = 1.0
        y_trues.append(yt)
    return fmaps, y_trues, c


@pytest.mark.parametrize("box_loss", ["reference", "giou"])
def test_compute_loss_matches_jax(box_loss):
    fmaps, y_trues, c = _scales(3)
    kw = dict(use_label_smooth=True, use_focal_loss=True, box_loss=box_loss)

    def jtotal(fs):
        out = jlo.compute_loss(fs, [jnp.asarray(y) for y in y_trues],
                               ANCHORS, c, (64, 64), **kw)
        return out["total"], out
    (_, jout), jgrads = jax.jit(jax.value_and_grad(jtotal, has_aux=True))(
        [jnp.asarray(f) for f in fmaps])
    tfs = [torch.from_numpy(f.copy()).requires_grad_(True) for f in fmaps]
    tout = tlo.compute_loss(tfs, [torch.from_numpy(y) for y in y_trues],
                            ANCHORS, c, (64, 64), **kw)
    assert set(tout) == set(tlo.LOSS_TERMS) == set(jout)
    for k in tlo.LOSS_TERMS:
        close(tout[k].item(), float(jout[k]), what=k)
    tgrads = torch.autograd.grad(tout["total"], tfs)
    for s, (tg, jg) in enumerate(zip(tgrads, jgrads)):
        close(tg.numpy(), np.asarray(jg), what=f"d fmap {s}")


def test_l2_regularization_counts_every_kernel():
    """Every "w" leaf, the detection convs' included; no bias and no BN
    parameter; value and gradient equal JAX's."""
    rng = np.random.default_rng(4)
    params = {"backbone": {"conv_0": {
                  "w": rng.normal(size=(3, 3, 2, 4)).astype(np.float32),
                  "gamma": np.ones(4, np.float32),
                  "beta": np.ones(4, np.float32)}},
              "head": {"conv_6": {
                  "w": rng.normal(size=(1, 1, 4, 6)).astype(np.float32),
                  "b": np.ones(6, np.float32)}}}
    jval, jgrad = jax.value_and_grad(jlo.l2_regularization)(params, 5e-4)
    tparams = {s: {n: {k: torch.from_numpy(v.copy()).requires_grad_(True)
                       for k, v in p.items()} for n, p in tree.items()}
               for s, tree in params.items()}
    tval = tlo.l2_regularization(tparams, 5e-4)
    close(tval.item(), float(jval), what="l2")
    want = 0.5 * 5e-4 * sum(float(np.sum(np.square(p["w"])))
                            for tree in params.values() for p in tree.values())
    close(tval.item(), want, what="l2 by hand")
    leaves = [(s, n, k) for s in params for n in params[s]
              for k in params[s][n]]
    grads = torch.autograd.grad(tval, [tparams[s][n][k] for s, n, k in leaves],
                                allow_unused=True)
    for (s, n, k), g in zip(leaves, grads):
        if k == "w":
            close(g.numpy(), np.asarray(jgrad[s][n][k]), what=f"{s}/{n}")
        else:
            assert g is None and not np.asarray(jgrad[s][n][k]).any()


def test_iou_and_giou_match_jax():
    rng = np.random.default_rng(6)
    a = np.concatenate([rng.uniform(0, 100, (5, 7, 2)),
                        rng.uniform(1, 50, (5, 7, 2))], -1).astype(np.float32)
    b = np.concatenate([rng.uniform(0, 100, (9, 2)),
                        rng.uniform(1, 50, (9, 2))], -1).astype(np.float32)
    b[0] = 0.0                                   # a padding slot
    close(tb.iou_xywh(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
          np.asarray(jb.iou_xywh(jnp.asarray(a), jnp.asarray(b))), what="iou")
    a2 = a.reshape(-1, 4)[:9]

    def jg(x):
        return jnp.sum(jb.giou_xywh(x, jnp.asarray(b)))
    jval, jgrad = jax.value_and_grad(jg)(jnp.asarray(a2))
    ta = torch.from_numpy(a2.copy()).requires_grad_(True)
    tval = tb.giou_xywh(ta, torch.from_numpy(b)).sum()
    (tgrad,) = torch.autograd.grad(tval, ta)
    close(tval.item(), float(jval), what="giou")
    close(tgrad.numpy(), np.asarray(jgrad), what="d giou")


def test_loss_after_an_inference_mode_decode():
    """The decode's cached device constants, first made under
    torch.inference_mode (as a serving call makes them), still enter a
    training loss's autograd graph."""
    from yolov3_tensorflow_tpu_torch.models.decode import decode_feature_map
    fmap, y_true, anchors, c, img_size = make_case(7)
    anchors = anchors + 1.0                  # constants no test made yet
    with torch.inference_mode():
        decode_feature_map(torch.from_numpy(fmap), anchors, c, img_size)
    jterms, jgrad, tterms, tgrad = both_loss_scale(fmap, y_true, anchors, c,
                                                   img_size)
    for name, t, j in zip(("xy", "wh", "conf", "class"), tterms, jterms):
        close(t.item(), float(j), what=name)
    close(tgrad, jgrad, what="d fmap")
