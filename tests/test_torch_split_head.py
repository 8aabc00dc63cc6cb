"""The port's split serving head, space-to-depth stem and aligned head
against the JAX package's, on the CPU.

Both packages get the same weights (testing.numpy_variables, seeded, with
the spread head where detections matter) and the same numpy images or
head outputs. JAX's functions run unjitted but for one detector, at
64^2-96^2. What is held, and how tightly:

- the weight rewrites (`space_to_depth_stem`, `split_serving_head`,
  `pad_output_convs_aligned`) from one folded tree: every leaf bit-equal
  to JAX's, dtypes included; `space_to_depth_2x` bit-equal;
- `conv_folded_asym`: within 1e-5 of JAX's in fp32 (the convs sum in
  other orders); in bf16 bit-equal on integer-valued inputs and weights,
  whose sums are exact in both, so only the roundings (to bf16 after the
  conv, after the bias add and after the LeakyReLU) are compared;
- the space-to-depth stem against the original two convs within 1e-6
  (JAX's tests/test_serving_fast.py), and the folded forward with
  stem_s2d=True and with split_neck=False against JAX's: every output
  within 1e-5 of the largest magnitude (fp32 sums reassociated);
- `yolov3_forward_split` in fp32 with fp32 class logits: boxconf and cls
  within 1e-5 of the largest magnitude;
- `postprocess_split` on the same numpy split outputs, at K = 64 and
  K = 37, fp32 and bf16 class logits, with anchors whose class logits all
  sit below the -30 pad bias: the candidates (boxes and scores before the
  NMS, taken from JAX's per-class NMS call) equal to JAX's, and the same
  detection set (JAX's per-class rows and the port's candidate-order rows
  differ in order only);
- `build_detector(mode="split")` at 96^2, fp32 compute, against JAX's
  split detector (approx_topk=False, plain NMS) and against the port's
  own prefilter mode on the images where no more than box_topk boxes
  pass: detection identity (same label, IoU >= 0.9, scores >= the
  threshold + 0.02), as tests/test_torch_serving.py holds the other modes;
- the aligned head: `postprocess_prefilter(aligned_head=True)` on aligned
  maps bit-equal to the unaligned path on the maps they pad, and row for
  row equal to JAX's (valid, labels; scores 1e-5, boxes 1e-4 relative);
- `postprocess_packed` with `score_dtype="bf16"`, `cell_major` both ways
  and `approx_topk=True` (with fp32 scores, which do not tie here: JAX's
  approx_max_k orders equal values in no fixed order off the TPU) against
  JAX's, whose shared NMS runs in Pallas interpret mode: rows equal
  (valid, labels; scores and boxes 1e-5).
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov3_tensorflow_tpu.models import layers as jl
from yolov3_tensorflow_tpu.models import yolov3 as jy
from yolov3_tensorflow_tpu.ops import fast_postprocess as jfp
from yolov3_tensorflow_tpu.ops import nms as jnms
from yolov3_tensorflow_tpu.ops import nms_pallas as jnp_mod
from yolov3_tensorflow_tpu.ops.postprocess import \
    build_detector as jax_build_detector
from yolov3_tensorflow_tpu_torch.config import DEFAULT_ANCHORS
from yolov3_tensorflow_tpu_torch.models import layers as tl
from yolov3_tensorflow_tpu_torch.models import yolov3 as ty
from yolov3_tensorflow_tpu_torch.models.convert import (from_jax_variables,
                                                        spread_head)
from yolov3_tensorflow_tpu_torch.ops import fast_postprocess as tfp
from yolov3_tensorflow_tpu_torch.ops.postprocess import (SplitDetector,
                                                         build_detector,
                                                         detections_to_numpy)
from yolov3_tensorflow_tpu_torch.testing import (CPU_TEST_THREADS,
                                                 match_detections,
                                                 numpy_variables)

torch.set_num_threads(CPU_TEST_THREADS)

CPU = torch.device("cpu")
ANCHORS = np.asarray(DEFAULT_ANCHORS, np.float32)
C = 80
SCORE_T = 0.3


def _np(x) -> np.ndarray:
    """Either package's tensor as float32 numpy (bf16 widened exactly)."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _port_tree(jtree):
    """A JAX folded tree (HWIO jax arrays, any dtype) as the port's (OIHW
    tensors of the same dtype): the same weights, bit for bit."""
    out = {}
    for k, v in jtree.items():
        if isinstance(v, dict):
            out[k] = _port_tree(v)
            continue
        t = torch.from_numpy(np.asarray(v, np.float32).copy())
        if t.ndim == 4:
            t = t.permute(3, 2, 0, 1).contiguous()
        out[k] = t.to(torch.bfloat16 if v.dtype == jnp.bfloat16
                      else torch.float32)
    return out


def _close(got, want, rel: float, what: str) -> None:
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: max err {err:.3g}, scale {scale:.3g}"


def _same_leaves(got: dict, want: dict, path: str = "") -> int:
    """Every leaf of a port weight tree equal to the JAX tree's, bit for
    bit, with the same dtype. Returns the number of leaves compared."""
    assert sorted(got) == sorted(want), path
    n = 0
    for k, w in want.items():
        g = got[k]
        if isinstance(w, dict):
            n += _same_leaves(g, w, f"{path}/{k}")
            continue
        wd = w.dtype
        assert g.dtype == (torch.bfloat16 if wd == jnp.bfloat16
                           else torch.float32), f"{path}/{k} {g.dtype} {wd}"
        g = _np(g)
        if g.ndim == 4:
            g = g.transpose(2, 3, 1, 0)                  # OIHW -> HWIO
        np.testing.assert_array_equal(g, _np(w), err_msg=f"{path}/{k}")
        n += 1
    return n


@pytest.fixture(scope="module")
def jvars():
    return numpy_variables(C, seed=0)


@pytest.fixture(scope="module")
def jfolded32(jvars):
    return jy.fold_batch_norm(jvars, dtype=jnp.float32)


def test_space_to_depth_2x_bit_equal_to_jax():
    x = np.random.default_rng(1).normal(size=(2, 8, 6, 5)).astype(np.float32)
    want = np.asarray(jl.space_to_depth_2x(jnp.asarray(x)))
    got = tl.space_to_depth_2x(torch.from_numpy(x))
    assert got.shape == (2, 4, 3, 20) and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)
    # the cast in the same copy: the values of casting first
    got16 = tl.space_to_depth_2x(torch.from_numpy(x), dtype=torch.bfloat16)
    assert got16.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        _np(got16), _np(jl.space_to_depth_2x(jnp.asarray(x, jnp.bfloat16))))


@pytest.mark.parametrize("num_classes,dtype", [(80, "bfloat16"),
                                               (20, "float32")])
def test_space_to_depth_stem_bit_equal_to_jax(num_classes, dtype):
    """COCO-80 folded to bf16 (the serving fold) and VOC-20 in fp32."""
    jfolded = jy.fold_batch_norm(numpy_variables(num_classes, seed=2),
                                 dtype=getattr(jnp, dtype))
    want = jy.space_to_depth_stem(jfolded)
    got = ty.space_to_depth_stem(_port_tree(jfolded))
    assert got["backbone"]["conv_0"]["w"].shape == (128, 12, 3, 3)
    assert got["backbone"]["conv_1"]["w"].shape == (64, 128, 2, 2)
    assert _same_leaves(got, want) == 2 * (52 + 23)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv_folded_asym_matches_jax(dtype):
    rng = np.random.default_rng(3)
    pad = ((1, 0), (1, 0))
    if dtype == "float32":
        x = rng.normal(size=(2, 9, 7, 16)).astype(np.float32)
        w = rng.normal(0, 0.2, (2, 2, 16, 8)).astype(np.float32)
        b = rng.normal(0, 0.5, 8).astype(np.float32)
    else:                          # exact sums: only the roundings compared
        x = rng.integers(-8, 9, (2, 9, 7, 16)).astype(np.float32)
        w = rng.integers(-8, 9, (2, 2, 16, 8)).astype(np.float32)
        b = rng.integers(-40, 41, 8).astype(np.float32) + 0.375
    want = jl.conv_folded_asym(jnp.asarray(x), {"w": jnp.asarray(w),
                                                "b": jnp.asarray(b)},
                               padding=pad, compute_dtype=getattr(jnp, dtype))
    got = tl.conv_folded_asym(
        torch.from_numpy(x).permute(0, 3, 1, 2),
        {"w": torch.from_numpy(w).permute(3, 2, 0, 1),
         "b": torch.from_numpy(b)}, padding=pad,
        compute_dtype=getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype)
    got = got.permute(0, 2, 3, 1)
    assert got.shape == (2, 9, 7, 8)
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-5)
    else:
        assert np.abs(_np(want)).max() > 256          # bf16 rounds here
        np.testing.assert_array_equal(_np(got), _np(want))


def test_space_to_depth_stem_convs_exact(jfolded32):
    """The rewritten conv_0/conv_1 reproduce the original stem within 1e-6
    (JAX's tests/test_serving_fast.py on the port)."""
    folded = _port_tree(jfolded32)
    fs2d = ty.space_to_depth_stem(folded)
    img = torch.from_numpy(np.random.default_rng(1).uniform(
        0, 1, (2, 32, 32, 3)).astype(np.float32))
    f32 = dict(compute_dtype=torch.float32)
    y_ref = tl.conv_folded(img.permute(0, 3, 1, 2),
                           folded["backbone"]["conv_0"], **f32)
    y_got = tl.conv_folded(tl.space_to_depth_2x(img).permute(0, 3, 1, 2),
                           fs2d["backbone"]["conv_0"], **f32)
    np.testing.assert_allclose(
        tl.space_to_depth_2x(y_ref.permute(0, 2, 3, 1)).numpy(),
        y_got.permute(0, 2, 3, 1).numpy(), atol=1e-6)
    z_ref = tl.conv_folded(y_ref, folded["backbone"]["conv_1"], stride=2,
                           **f32)
    z_got = tl.conv_folded_asym(y_got, fs2d["backbone"]["conv_1"],
                                padding=((1, 0), (1, 0)), **f32)
    np.testing.assert_allclose(z_ref.numpy(), z_got.numpy(), atol=1e-6)


@pytest.mark.parametrize("variant", ["stem_s2d", "literal_neck"])
def test_folded_forward_variants_match_jax(variant, jfolded32):
    img = np.random.default_rng(2).uniform(0, 1, (1, 64, 64, 3)
                                           ).astype(np.float32)
    f32 = dict(compute_dtype=jnp.float32)
    if variant == "stem_s2d":
        jtree = jy.space_to_depth_stem(jfolded32)
        kw = dict(stem_s2d=True)
        tree = ty.space_to_depth_stem(_port_tree(jfolded32))
    else:
        jtree, kw, tree = jfolded32, dict(split_neck=False), \
            _port_tree(jfolded32)
    want = jy.yolov3_forward_folded(jtree, jnp.asarray(img), **f32, **kw)
    got = ty.yolov3_forward_folded(tree, torch.from_numpy(img),
                                   compute_dtype=torch.float32, **kw)
    plain = ty.yolov3_forward_folded(_port_tree(jfolded32),
                                     torch.from_numpy(img),
                                     compute_dtype=torch.float32)
    for s, (g, w, p) in enumerate(zip(got, want, plain)):
        _close(g, w, 1e-5, f"{variant} fmap {s}")
        _close(g, p, 1e-5, f"{variant} against the default forward {s}")


def test_split_serving_head_leaves_equal_jax(jfolded32):
    """Layout, the -30 pad bias and the bias dtypes, from a bf16 fold (the
    serving one) and with fp32 class logits."""
    for dtype, cls in ((jnp.bfloat16, None), (jnp.float32, jnp.float32)):
        jfolded = jy.fold_batch_norm(numpy_variables(C, seed=0), dtype=dtype)
        want = jfp.split_serving_head(jfolded, C, cls_dtype=cls)
        kw = {} if cls is None else {"cls_dtype": torch.float32}
        got = tfp.split_serving_head(_port_tree(jfolded), C, **kw)
        assert _same_leaves(got, want) == 2 * (52 + 20) + 3 * 4
        head = got["head"]["conv_6"]
        assert head["boxconf"]["b"].dtype == torch.float32
        assert head["cls"]["b"].dtype == (torch.bfloat16 if cls is None
                                          else torch.float32)
        b = _np(head["cls"]["b"]).reshape(3, 128)
        assert (b[:, C:] == -30.0).all()


def test_forward_split_matches_jax(jfolded32):
    """fp32 compute and class logits, 64^2: boxconf and cls."""
    img = np.random.default_rng(4).uniform(0, 1, (1, 64, 64, 3)
                                           ).astype(np.float32)
    jsplit = jfp.split_serving_head(jfolded32, C, cls_dtype=jnp.float32)
    want = jfp.yolov3_forward_split(jsplit, jnp.asarray(img),
                                    compute_dtype=jnp.float32,
                                    cls_dtype=jnp.float32)
    split = tfp.split_serving_head(_port_tree(jfolded32), C,
                                   cls_dtype=torch.float32)
    got = tfp.yolov3_forward_split(split, torch.from_numpy(img),
                                   compute_dtype=torch.float32,
                                   cls_dtype=torch.float32)
    assert len(got) == 3
    for s, ((gb, gc), (wb, wc)) in enumerate(zip(got, want)):
        assert gb.dtype == gc.dtype == torch.float32
        _close(gb, wb, 1e-5, f"boxconf {s}")
        _close(gc, wc, 1e-5, f"cls {s}")
    # the default: bf16 class logits, as JAX's
    bf = tfp.yolov3_forward_split(tfp.split_serving_head(
        _port_tree(jfolded32), C), torch.from_numpy(img),
        compute_dtype=torch.float32)
    assert [(b.shape[-1], b.dtype, c.shape[-1], c.dtype) for b, c in bf] == \
        [(15, torch.float32, 384, torch.bfloat16)] * 3


def _split_outputs(b: int, seed: int, dtype):
    """Numpy split head outputs at 64^2 (cells 2x2, 4x4, 8x8): class
    logits in [-6, 3], a quarter of the anchors with every class logit
    below the -30 pad bias (the pad lanes then hold the block's max),
    pad lanes at -30."""
    rng = np.random.default_rng(seed)
    row = tfp.head_row_width(C)
    outs = []
    for g in (2, 4, 8):
        bc = rng.uniform(-1.5, 1.5, (b, g, g, 3, 5)).astype(np.float32)
        bc[..., 4] = rng.uniform(-1, 4, (b, g, g, 3))
        cl = np.full((b, g, g, 3, row), -30.0, np.float32)
        cl[..., :C] = rng.uniform(-6, 3, (b, g, g, 3, C))
        low = rng.uniform(0, 1, (b, g, g, 3)) < 0.25
        cl[low, :C] = rng.uniform(-45, -31, (int(low.sum()), C))
        outs.append((bc.reshape(b, g, g, 15),
                     cl.reshape(b, g, g, 3 * row).astype(dtype)))
    return outs


def _det_sets(d, b: int):
    """(image, label, score, box) rows of a detection dict, rounded."""
    out = set()
    for i in range(b):
        v = np.asarray(d["valid"][i]).astype(bool)
        for box, sc, lb in zip(_np(d["boxes"][i])[v], _np(d["scores"][i])[v],
                               np.asarray(d["labels"][i])[v]):
            out.add((i, int(lb), round(float(sc), 4),
                     tuple(np.round(box, 2).tolist())))
    return out


@pytest.mark.parametrize("k,dtype", [(64, "float32"), (37, "float32"),
                                     (64, "bfloat16")])
def test_postprocess_split_matches_jax(k, dtype):
    b = 2
    outs = _split_outputs(b, seed=5, dtype=np.float32)
    jouts = [(jnp.asarray(bc), jnp.asarray(cl, getattr(jnp, dtype)))
             for bc, cl in outs]
    touts = [(torch.from_numpy(bc), torch.from_numpy(cl).to(
        getattr(torch, dtype))) for bc, cl in outs]
    kw = dict(max_out=128, box_topk=k, score_thresh=SCORE_T,
              iou_thresh=0.45)

    seen = {}
    orig = jnms.batched_nms

    def recording(boxes, scores, **nms_kw):
        seen["boxes"], seen["scores"] = np.asarray(boxes), np.asarray(scores)
        return orig(boxes, scores, **nms_kw)

    with mock.patch.object(jnms, "batched_nms", recording):
        want = jfp.postprocess_split(jouts, ANCHORS, C, (64, 64),
                                     approx_topk=False, use_pallas=False,
                                     **kw)
    tables = tfp.decode_tables((64, 64), ANCHORS, device=CPU)
    boxes, scores = tfp.split_candidates(touts, C, tables, k)
    assert boxes.shape == (b, k, 4) and scores.shape == (b, k, C)
    np.testing.assert_allclose(boxes.numpy(), seen["boxes"], rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(scores.numpy(), seen["scores"], rtol=1e-5,
                               atol=1e-7)

    got = tfp.postprocess_split(touts, ANCHORS, C, (64, 64),
                                approx_topk=False, **kw)
    want_set, got_set = _det_sets(want, b), _det_sets(got, b)
    assert len(want_set) >= 20
    assert got_set == want_set


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x.astype(np.float64)))


def test_postprocess_split_pad_lanes_rank_like_jax():
    """The split selection maxes over the whole class block, pad lanes
    included, as JAX's does: with box_topk reaching 8 anchors into those
    whose class logits all sit below -30, the port picks JAX's candidates,
    where a max masked to the class lanes (the packed path's) would pick
    others."""
    outs = _split_outputs(1, seed=6, dtype=np.float32)
    row = tfp.head_row_width(C)
    obj = {"block": [], "masked": []}
    for bc, cl in outs:
        conf = _sigmoid(bc.reshape(1, -1, 3, 5)[..., 4])
        blk = cl.reshape(1, -1, 3, row)
        obj["block"].append((conf * _sigmoid(blk.max(-1))).reshape(1, -1))
        obj["masked"].append(
            (conf * _sigmoid(blk[..., :C].max(-1))).reshape(1, -1))
    low = sum(int((cl.reshape(-1, row)[:, :C].max(-1) < -30).sum())
              for _, cl in outs)
    n = sum(bc.shape[1] * bc.shape[2] * 3 for bc, _ in outs)
    k = n - low + 8
    assert 0 < low and k < n
    picks = {m: set(np.argsort(-np.concatenate(v, 1)[0], kind="stable")[:k])
             for m, v in obj.items()}
    assert picks["block"] != picks["masked"]

    seen = {}
    orig = jnms.batched_nms

    def recording(boxes, scores, **nms_kw):
        seen["boxes"] = np.asarray(boxes)
        return orig(boxes, scores, **nms_kw)

    with mock.patch.object(jnms, "batched_nms", recording):
        jfp.postprocess_split([(jnp.asarray(bc), jnp.asarray(cl))
                               for bc, cl in outs], ANCHORS, C, (64, 64),
                              box_topk=k, approx_topk=False,
                              use_pallas=False)
    tables = tfp.decode_tables((64, 64), ANCHORS, device=CPU)
    boxes, _ = tfp.split_candidates(
        [(torch.from_numpy(bc), torch.from_numpy(cl)) for bc, cl in outs],
        C, tables, k)
    np.testing.assert_allclose(boxes.numpy(), seen["boxes"], rtol=1e-5,
                               atol=1e-4)


@pytest.fixture(scope="module")
def spread_vars():
    return spread_head(numpy_variables(C, seed=0), seed=0)


def test_split_detector_matches_jax_and_prefilter(spread_vars):
    size = 96
    kw = dict(max_out=128, box_topk=64, score_thresh=SCORE_T,
              iou_thresh=0.45)
    img = np.random.default_rng(96).uniform(0, 1, (2, size, size, 3)
                                            ).astype(np.float32)
    tvars = from_jax_variables(spread_vars, device=CPU)
    det = build_detector(tvars, ANCHORS, C, (size, size), device=CPU,
                         compute_dtype=torch.float32, mode="split", **kw)
    assert isinstance(det, SplitDetector) and not det.training
    got = det(torch.from_numpy(img))
    assert got["boxes"].shape == (2, C * 128, 4)
    assert torch.isfinite(got["boxes"]).all()
    jdet = jax_build_detector(spread_vars, ANCHORS, C, (size, size),
                              compute_dtype=jnp.float32, mode="split",
                              approx_topk=False, use_pallas=False, **kw)
    want = jax.device_get(jdet.__wrapped__(jnp.asarray(img)))

    def jax_dets(i):
        v = want["valid"][i].astype(bool)
        return want["boxes"][i][v], want["scores"][i][v], want["labels"][i][v]

    g = [detections_to_numpy(got, i) for i in range(2)]
    w = [jax_dets(i) for i in range(2)]
    min_score = SCORE_T + 0.02
    n_w, found_w = match_detections(w, g, min_score)
    n_g, found_g = match_detections(g, w, min_score)
    assert n_w >= 20 and n_g >= 20, (n_w, n_g)
    assert (found_w, found_g) == (n_w, n_g)

    # the prefilter's math: the same detections where <= box_topk pass,
    # at the lowest threshold of 0.3, 0.4, ..., 0.9 where an image does
    # (chip_smoke.py phase 7's choice)
    pre = build_detector(tvars, ANCHORS, C, (size, size), device=CPU,
                         compute_dtype=torch.float32, mode="prefilter", **kw)
    with torch.inference_mode():
        fmaps = ty.yolov3_forward_folded(pre.folded, torch.from_numpy(img),
                                         compute_dtype=torch.float32)
    raw = tfp.flatten_feature_maps(fmaps, C)
    best = torch.sigmoid(raw[..., 4]) * torch.sigmoid(raw[..., 5:].amax(-1))
    for t in (0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9):
        passing = (best >= t).sum(1)
        fits = ((passing > 0) & (passing <= kw["box_topk"])).nonzero()[:, 0]
        if len(fits):
            break
    assert len(fits) >= 1
    sel = torch.from_numpy(img[fits.numpy()])
    dets = {}
    for mode in ("split", "prefilter"):
        d = build_detector(tvars, ANCHORS, C, (size, size), device=CPU,
                           compute_dtype=torch.float32, mode=mode,
                           **dict(kw, score_thresh=t))(sel)
        dets[mode] = [detections_to_numpy(d, i) for i in range(len(fits))]
    n1, f1 = match_detections(dets["prefilter"], dets["split"], t + 0.02)
    n2, f2 = match_detections(dets["split"], dets["prefilter"], t + 0.02)
    assert n1 >= 5 and (f1, f2) == (n1, n2), (t, n1, f1, n2, f2)


def _plain_maps(b: int, seed: int):
    rng = np.random.default_rng(seed)
    return [rng.normal(-2, 1.5, (b, g, g, 3 * (5 + C))).astype(np.float32)
            for g in (2, 4, 8)]


def _aligned(maps):
    """Plain maps with each anchor's (5+C) block padded with zeros to
    row = 128: what the aligned head emits for the same logits."""
    row = tfp.head_row_width(C)
    out = []
    for m in maps:
        b, g, _, _ = m.shape
        a = np.zeros((b, g, g, 3, row), np.float32)
        a[..., :5 + C] = m.reshape(b, g, g, 3, 5 + C)
        out.append(a.reshape(b, g, g, 3 * row))
    return out


def test_aligned_head_matches_unaligned_and_jax(jfolded32):
    # the padded detection convs: leaves equal to JAX's
    want = jfp.pad_output_convs_aligned(jfolded32["head"], C)
    got = tfp.pad_output_convs_aligned(_port_tree(jfolded32)["head"], C)
    assert _same_leaves(got, want) == 2 * 23
    # the aligned postprocess on the padded maps
    maps = _plain_maps(2, seed=7)
    amaps = _aligned(maps)
    kw = dict(max_out=20, box_topk=96, pre_topk=128, score_thresh=SCORE_T,
              iou_thresh=0.45)
    got = tfp.postprocess_prefilter([torch.from_numpy(m) for m in amaps],
                                    ANCHORS, C, (64, 64), aligned_head=True,
                                    **kw)
    plain = tfp.postprocess_prefilter([torch.from_numpy(m) for m in maps],
                                      ANCHORS, C, (64, 64), **kw)
    for key in got:
        assert torch.equal(got[key], plain[key]), key
    want = jfp.postprocess_prefilter([jnp.asarray(m) for m in amaps],
                                     ANCHORS, C, (64, 64), aligned_head=True,
                                     use_pallas=False, **kw)
    want = {k: np.asarray(v) for k, v in want.items()}
    v = want["valid"]
    assert v.sum() >= 20
    for key in ("valid", "labels"):
        np.testing.assert_array_equal(got[key].numpy(), want[key])
    np.testing.assert_allclose(got["scores"].numpy()[v], want["scores"][v],
                               rtol=1e-5)
    np.testing.assert_allclose(got["boxes"].numpy()[v], want["boxes"][v],
                               rtol=1e-4)


def _packed_outputs(b: int, seed: int):
    row = tfp.head_row_width(C)
    rng = np.random.default_rng(seed)
    outs = []
    for g in (2, 4, 8):
        p = np.full((b, g, g, 3, row), -30.0, np.float32)
        p[..., :C] = rng.uniform(0, 4, (b, g, g, 3, C))
        p[..., C] = rng.uniform(-2, 2, (b, g, g, 3))
        p[..., C + 1:C + 5] = rng.uniform(-1, 1, (b, g, g, 3, 4))
        outs.append(p.reshape(b, g, g, 3 * row))
    return outs


@pytest.mark.parametrize("score_dtype,cell_major,approx_topk", [
    ("bf16", True, False), ("bf16", False, False), (None, False, True),
    (None, True, True)])
def test_postprocess_packed_options_match_jax(score_dtype, cell_major,
                                              approx_topk):
    """bf16 head outputs (the serving dtype), JAX's shared NMS in Pallas
    interpret mode. JAX's approx_max_k off the TPU is an unstable full
    sort (the top-k values exactly, equal values in no fixed order), so
    approx_topk=True is held where the fp32 scores do not tie; a bf16
    score ties often, and is held with the exact top-k."""
    outs = _packed_outputs(2, seed=9)
    kw = dict(max_out=128, box_topk=64, score_thresh=SCORE_T,
              iou_thresh=0.45, approx_topk=approx_topk,
              cell_major=cell_major, score_dtype=score_dtype)
    got = tfp.postprocess_packed(
        [torch.from_numpy(o).to(torch.bfloat16) for o in outs], ANCHORS, C,
        (64, 64), **kw)
    orig = jnp_mod.batched_nms_shared_pallas

    def interp(*a, **k):
        return orig(*a, **dict(k, interpret=True))

    with mock.patch.object(jnp_mod, "batched_nms_shared_pallas", interp):
        want = jfp.postprocess_packed(
            [jnp.asarray(o, jnp.bfloat16) for o in outs], ANCHORS, C,
            (64, 64), use_pallas=True, **kw)
    want = {k: np.asarray(v) for k, v in want.items()}
    assert want["valid"].any()
    for key in ("valid", "labels"):
        np.testing.assert_array_equal(got[key].numpy(), want[key])
    for key in ("boxes", "scores"):
        np.testing.assert_allclose(got[key].numpy(), want[key], rtol=1e-5)
