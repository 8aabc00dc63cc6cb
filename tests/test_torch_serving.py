"""The port's detectors against the JAX package, on the CPU.

- postprocess: the same packed head outputs (numpy, seeded) go through both
  packages' `postprocess_packed`, the JAX one with exact top-k and its
  Pallas shared NMS in interpret mode; the same plain feature maps through
  both packages' `postprocess` (exact) and `postprocess_prefilter`, the JAX
  ones with use_pallas=False (its plain per-class NMS, which is also the
  port's CPU route).
- end to end: `build_detector` of both packages, modes "packed", "exact"
  and "prefilter", on the same spread-head weights
  (models.convert.spread_head) and images at 96^2, fp32 compute. A conv
  summed in another order moves a logit in its last bits (and the packed
  path rounds its outputs to bf16 in both packages, so by up to one bf16
  step there); the detectors are held to detection identity (same label,
  IoU >= 0.9) for every detection scored at least 0.02 above the threshold.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov3_tensorflow_tpu_torch.config import DEFAULT_ANCHORS
from yolov3_tensorflow_tpu.ops import fast_postprocess as jfp
from yolov3_tensorflow_tpu.ops import postprocess as jpp
from yolov3_tensorflow_tpu.ops.postprocess import \
    build_detector as jax_build_detector
from yolov3_tensorflow_tpu_torch.models.convert import (from_jax_variables,
                                                        spread_head)
from yolov3_tensorflow_tpu_torch.ops import fast_postprocess as tfp
from yolov3_tensorflow_tpu_torch.ops import postprocess as tpp
from yolov3_tensorflow_tpu_torch.ops.postprocess import (build_detector,
                                                         detections_to_numpy,
                                                         pack_detections,
                                                         unpack_detections)
from yolov3_tensorflow_tpu_torch.testing import (CPU_TEST_THREADS,
                                                 match_detections,
                                                 numpy_variables)

torch.set_num_threads(CPU_TEST_THREADS)

CPU = torch.device("cpu")
ANCHORS = np.asarray(DEFAULT_ANCHORS, np.float32)
C = 80
SCORE_T = 0.3


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


@pytest.mark.parametrize("dtype,max_out", [("float32", 128),
                                           ("float32", 32),
                                           ("bfloat16", 128)])
def test_postprocess_packed_matches_jax(dtype, max_out):
    outs = _packed_outputs(2, seed=9)
    kw = dict(max_out=max_out, box_topk=64, score_thresh=SCORE_T,
              iou_thresh=0.45)
    got = tfp.postprocess_packed(
        [torch.from_numpy(o).to(getattr(torch, dtype)) for o in outs],
        ANCHORS, C, (64, 64), **kw)
    want = jfp.postprocess_packed(
        [jnp.asarray(o, getattr(jnp, dtype)) for o in outs], ANCHORS, C,
        (64, 64), approx_topk=False, use_pallas=True, pallas_interpret=True,
        **kw)
    want = {k: np.asarray(v) for k, v in want.items()}
    assert want["valid"].any()
    for key in ("valid", "labels"):
        np.testing.assert_array_equal(got[key].numpy(), want[key])
    for key in ("boxes", "scores"):
        np.testing.assert_allclose(got[key].numpy(), want[key], rtol=1e-5)


@pytest.mark.parametrize("kind", ["exact", "prefilter"])
def test_postprocess_matches_jax(kind):
    """Rows line up one to one: `valid` equal, scores to rtol 1e-5 and
    boxes to rtol 1e-4 on the valid rows."""
    rng = np.random.default_rng(5)
    maps = [rng.normal(-2, 1.5, (2, g, g, 3 * (5 + C))).astype(np.float32)
            for g in (2, 4, 8)]
    kw = dict(max_out=20, pre_topk=128, score_thresh=SCORE_T,
              iou_thresh=0.45)
    if kind == "exact":
        got = tpp.postprocess([torch.from_numpy(m) for m in maps], ANCHORS, C,
                              (64, 64), **kw)
        want = jpp.postprocess([jnp.asarray(m) for m in maps], ANCHORS, C,
                               (64, 64), use_pallas=False, **kw)
    else:
        got = tfp.postprocess_prefilter([torch.from_numpy(m) for m in maps],
                                        ANCHORS, C, (64, 64), box_topk=96,
                                        **kw)
        want = jfp.postprocess_prefilter([jnp.asarray(m) for m in maps],
                                         ANCHORS, C, (64, 64), box_topk=96,
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


@pytest.fixture(scope="module")
def spread_vars():
    return spread_head(numpy_variables(C, seed=0), seed=0)


def _detector_matches_jax(mode, spread_vars):
    """mode None builds both packages' default detectors."""
    size = 96
    kw = dict(max_out=128, box_topk=64, score_thresh=SCORE_T,
              iou_thresh=0.45)
    if mode is not None:
        kw["mode"] = mode
    rng = np.random.default_rng(96)
    img = rng.uniform(0, 1, (2, size, size, 3)).astype(np.float32)

    det = build_detector(from_jax_variables(spread_vars, device=CPU), ANCHORS,
                         C, (size, size), device=CPU,
                         compute_dtype=torch.float32, **kw)
    assert not det.training
    got = det(torch.from_numpy(img))
    jdet = jax_build_detector(spread_vars, ANCHORS, C, (size, size),
                              compute_dtype=jnp.float32, use_pallas=False,
                              **kw)
    want = jax.device_get(jdet(jnp.asarray(img)))

    assert got["boxes"].shape == (2, C * 128, 4)
    assert torch.isfinite(got["boxes"]).all()
    assert torch.isfinite(got["scores"]).all()

    def jax_to_numpy(i):
        v = want["valid"][i].astype(bool)
        return want["boxes"][i][v], want["scores"][i][v], want["labels"][i][v]

    g = [detections_to_numpy(got, i) for i in range(2)]
    w = [jax_to_numpy(i) for i in range(2)]
    min_score = SCORE_T + 0.02
    n_w, found_w = match_detections(w, g, min_score)
    n_g, found_g = match_detections(g, w, min_score)
    assert n_w >= 20 and n_g >= 20, f"only {n_w} / {n_g} confident detections"
    assert found_w == n_w, f"port misses {n_w - found_w} of {n_w} detections"
    assert found_g == n_g, f"port adds {n_g - found_g} of {n_g} detections"
    return got, det


def test_detector_end_to_end_matches_jax(spread_vars):
    got, _ = _detector_matches_jax("packed", spread_vars)
    # pack/unpack is the detections_to_numpy contract in one buffer
    packed = pack_detections(got)
    for i in range(2):
        for a, b in zip(unpack_detections(packed, i),
                        detections_to_numpy(got, i)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mode", ["exact", "prefilter"])
def test_folded_detector_matches_jax(mode, spread_vars):
    got, _ = _detector_matches_jax(mode, spread_vars)
    if mode == "exact":
        # rows are score-descending within each class group
        s = torch.where(got["valid"], got["scores"], -1.0).view(2, C, 128)
        assert bool((s[..., :-1] >= s[..., 1:]).all())


def test_build_detector_default_is_prefilter_as_in_jax(spread_vars):
    """With no mode, both packages build the prefilter detector (JAX:
    mode=None with fast=True), and they find the same detections."""
    _, det = _detector_matches_jax(None, spread_vars)
    assert isinstance(det, tpp.FoldedDetector) and det.mode == "prefilter"


def test_build_detector_defers_other_modes(spread_vars):
    """"split" is built (a SplitDetector, which answers a request;
    tests/test_torch_split_head.py holds it to JAX's); full int8 is no
    build_detector mode (ops.quantize.build_detector_int8 builds it) and
    an unknown mode raises ValueError; "stem8" is built
    (tests/test_torch_mode_select.py) and needs calibration images."""
    v = from_jax_variables(spread_vars, device=CPU)
    det = build_detector(v, ANCHORS, C, (64, 64), device=CPU, mode="split",
                         max_out=16, box_topk=32)
    assert isinstance(det, tpp.SplitDetector) and not det.training
    out = det(torch.zeros((1, 64, 64, 3)))
    assert out["boxes"].shape == (1, C * 16, 4)
    assert out["valid"].dtype == torch.bool
    with pytest.raises(ValueError, match="build_detector_int8"):
        build_detector(v, ANCHORS, C, (64, 64), device=CPU, mode="int8")
    with pytest.raises(ValueError):
        build_detector(v, ANCHORS, C, (64, 64), device=CPU, mode="bogus")
    with pytest.raises(ValueError, match="calibration_images"):
        build_detector(v, ANCHORS, C, (64, 64), device=CPU, mode="stem8")
