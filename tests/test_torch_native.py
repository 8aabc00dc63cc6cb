"""The port's host postprocess library (`utils/native.py` over
`csrc/postprocess.cc`) against the numpy oracles, on the CPU: greedy NMS
against `ops.nms.py_nms` at both pixel offsets, per-class NMS against
`cpu_nms`, the IoU matrix against JAX's `evaluation/metrics.py:
_iou_matrix`; `evaluation.metrics.iou_matrix`'s two routes (the library
where it loads, numpy where not) bit-equal; built under build/ (never into
the JAX package's native/); no fallback where the compiler is missing;
and a failing compiler started once a process on the metrics' route.
Skips where no C++ compiler exists, as tests/test_native.py does."""

import numpy as np
import pytest

from yolov3_tensorflow_tpu.evaluation.metrics import _iou_matrix
from yolov3_tensorflow_tpu_torch.evaluation import metrics
from yolov3_tensorflow_tpu_torch.ops.nms import cpu_nms, py_nms
from yolov3_tensorflow_tpu_torch.utils import kernels, native

ROOT = kernels.BUILD_DIR.parents[1]


@pytest.fixture
def lib():
    try:
        kernels.host_compiler()
    except RuntimeError:
        pytest.skip("no C++ toolchain in environment")
    return native.load()


def _random_boxes(rng, n, span=300.0):
    x0 = rng.uniform(0, span, n)
    y0 = rng.uniform(0, span, n)
    w = rng.uniform(5, 120, n)
    h = rng.uniform(5, 120, n)
    return np.stack([x0, y0, x0 + w, y0 + h], -1).astype(np.float32)


@pytest.mark.parametrize("offset", [0.0, 1.0])
def test_nms_matches_py_nms(lib, offset):
    rng = np.random.RandomState(0)
    for _ in range(3):
        boxes = _random_boxes(rng, 120, span=150.0)
        scores = rng.uniform(0, 1, 120).astype(np.float32)
        got = native.nms(boxes, scores, max_out=120, iou_thresh=0.5,
                         pixel_offset=offset)
        assert got == py_nms(boxes, scores, max_boxes=120, iou_thresh=0.5,
                             offset=offset)
        assert native.nms(boxes, scores, max_out=5, iou_thresh=0.5,
                          pixel_offset=offset) == got[:5]


def test_nms_multiclass_matches_cpu_nms(lib):
    rng = np.random.RandomState(1)
    boxes = _random_boxes(rng, 200)
    scores = rng.uniform(0, 0.9, (200, 6)).astype(np.float32)
    got = native.nms_multiclass(boxes, scores, 6, max_per_class=20,
                                score_thresh=0.4, iou_thresh=0.5)
    want = cpu_nms(boxes, scores, 6, max_boxes=20, score_thresh=0.4,
                   iou_thresh=0.5)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    empty = native.nms_multiclass(np.zeros((4, 4), np.float32),
                                  np.zeros((4, 3), np.float32), 3,
                                  score_thresh=0.5)
    assert empty == (None, None, None)


def test_iou_matrix_matches_jax(lib):
    rng = np.random.RandomState(2)
    a, b = _random_boxes(rng, 150, 400.0), _random_boxes(rng, 50, 400.0)
    got = native.iou_matrix(a, b)
    np.testing.assert_array_equal(got, _iou_matrix(a, b))
    np.testing.assert_array_equal(got, metrics._iou_matrix(a, b))
    one = native.iou_matrix(np.array([[0, 0, 10, 10]], np.float32),
                            np.array([[0, 0, 10, 10], [5, 5, 15, 15],
                                      [20, 20, 30, 30]], np.float32))
    np.testing.assert_allclose(one[0], [1.0, 25 / 175, 0.0], rtol=1e-6)


def test_metrics_iou_routes_give_the_same_bits(lib, monkeypatch):
    """evaluation.metrics.iou_matrix takes the library where it loads and
    numpy where it does not, as the JAX package's does: the same bits on
    random boxes (the in-train evaluation's shapes: many detections, few
    ground-truth boxes)."""
    rng = np.random.RandomState(7)
    a, b = _random_boxes(rng, 2000, 416.0), _random_boxes(rng, 4, 416.0)
    calls, library = [], native.iou_matrix
    monkeypatch.setattr(native, "iou_matrix",
                        lambda *args: calls.append(1) or library(*args))
    got = metrics.iou_matrix(a, b)
    assert calls == [1]
    monkeypatch.setattr(native, "available", lambda: False)
    want = metrics.iou_matrix(a, b)
    assert calls == [1]
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_self_test(lib):
    native.self_test(seed=3)


def test_built_under_build_not_native(lib):
    path = native.library_path()
    assert path.exists()
    rel = path.resolve().relative_to(ROOT)
    assert rel.parts[:2] == ("build", "torch_kernels")
    assert "native" not in rel.parts
    assert (kernels.CSRC / "postprocess.cc").exists()


def test_missing_compiler_raises(lib, monkeypatch):
    monkeypatch.setenv("CXX", "/nonexistent/bin/c++")
    boxes = np.zeros((2, 4), np.float32)
    with pytest.raises(RuntimeError, match="/nonexistent/bin/c"):
        native.nms(boxes, np.zeros(2, np.float32))
    with pytest.raises(RuntimeError, match="/nonexistent/bin/c"):
        native.iou_matrix(boxes, boxes)
    assert not native.available()


def test_failed_build_is_tried_once(tmp_path, monkeypatch):
    """Where the compiler runs but fails, evaluation.metrics.iou_matrix
    starts it at most once a process and answers with numpy's bits on
    every call."""
    log = tmp_path / "runs"
    cxx = tmp_path / "failing-c++"
    cxx.write_text(f"#!/bin/sh\necho run >> {log}\nexit 1\n")
    cxx.chmod(0o755)
    monkeypatch.setenv("CXX", str(cxx))
    rng = np.random.RandomState(3)
    for _ in range(3):
        a, b = _random_boxes(rng, 40, 416.0), _random_boxes(rng, 4, 416.0)
        np.testing.assert_array_equal(metrics.iou_matrix(a, b),
                                      metrics._iou_matrix(a, b))
    assert log.read_text().splitlines() == ["run"]
