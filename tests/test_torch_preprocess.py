"""The port's device preprocessing against the JAX package's, on the CPU:
the letterbox geometry, `device_letterbox` (bilinear with antialiasing,
within 0.01/255 of `jax.image.resize`; the padding exactly 128/255), and
the streaming detector end to end in fp32 on the same spread-head weights
and seeded BGR frames (detection identity: same label, IoU >= 0.9, for
every detection scored at least 0.02 above the threshold)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov3_tensorflow_tpu.data.augment import \
    letterbox_resize as jax_letterbox_resize
from yolov3_tensorflow_tpu.ops import preprocess as jpre
from yolov3_tensorflow_tpu_torch.config import DEFAULT_ANCHORS
from yolov3_tensorflow_tpu_torch.data.augment import letterbox_params
from yolov3_tensorflow_tpu_torch.models.convert import (from_jax_variables,
                                                        spread_head)
from yolov3_tensorflow_tpu_torch.ops import preprocess as tpre
from yolov3_tensorflow_tpu_torch.ops.postprocess import detections_to_numpy
from yolov3_tensorflow_tpu_torch.testing import (CPU_TEST_THREADS,
                                                 match_detections,
                                                 numpy_variables)

torch.set_num_threads(CPU_TEST_THREADS)

CPU = torch.device("cpu")
ANCHORS = np.asarray(DEFAULT_ANCHORS, np.float32)
C = 80
SCORE_T = 0.3
LETTERBOX_ATOL = 0.01 / 255
GRAY = np.float32(128) / np.float32(255)

# (source h, w) -> (target h, w): downscales to 312x416, 68x96 and
# 208x416, an upscale, and two non-square targets
SHAPES = [((480, 640), (416, 416)), ((100, 140), (96, 96)),
          ((200, 400), (416, 416)), ((90, 120), (96, 96)),
          ((416, 416), (96, 128)), ((90, 120), (128, 96))]


def _frames(src_hw, seed=0, b=2):
    return np.random.default_rng(seed).integers(0, 256, (b,) + src_hw + (3,),
                                                dtype=np.uint8)


@pytest.mark.parametrize("src_hw,dst_hw", SHAPES)
def test_letterbox_params_match_jax(src_hw, dst_hw):
    got = tpre.letterbox_params(src_hw, dst_hw)
    assert got == jpre.letterbox_params(src_hw, dst_hw)
    ratio, rh, rw, pad_h, pad_w = got
    # the host letterbox has the same geometry, in (w, h) order
    assert letterbox_params(src_hw[1], src_hw[0], dst_hw[1], dst_hw[0]) == (
        ratio, rw, rh, pad_w, pad_h)
    _, h_ratio, dw, dh = jax_letterbox_resize(
        np.zeros(src_hw + (3,), np.uint8), dst_hw[1], dst_hw[0])
    assert (h_ratio, dw, dh) == (ratio, pad_w, pad_h)


@pytest.mark.parametrize("src_hw,dst_hw", SHAPES)
def test_device_letterbox_matches_jax(src_hw, dst_hw):
    frames = _frames(src_hw, seed=src_hw[0])
    got = tpre.device_letterbox(torch.from_numpy(frames), dst_hw)
    want = np.asarray(jpre.device_letterbox(jnp.asarray(frames), dst_hw))
    assert tuple(got.shape) == want.shape == (2,) + dst_hw + (3,)
    assert got.dtype == torch.float32 and got.is_contiguous()
    got = got.numpy()
    assert got.min() >= 0.0 and got.max() <= 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=LETTERBOX_ATOL)
    _, rh, rw, pad_h, pad_w = tpre.letterbox_params(src_hw, dst_hw)
    pad = np.ones(dst_hw, bool)
    pad[pad_h:pad_h + rh, pad_w:pad_w + rw] = False
    assert (pad.any() or src_hw[0] * dst_hw[1] == src_hw[1] * dst_hw[0])
    assert (got[:, pad] == GRAY).all()
    assert (want[:, pad] == GRAY).all()


@pytest.fixture(scope="module")
def spread_vars():
    return spread_head(numpy_variables(C, seed=0), seed=0)


def _frame_dets(out, n):
    return [detections_to_numpy(out, i) for i in range(n)]


@pytest.mark.parametrize("mode", ["prefilter", "packed"])
def test_streaming_detector_matches_jax(mode, spread_vars):
    src_hw, dst_hw = (90, 120), (96, 96)
    frames = _frames(src_hw, seed=7)
    kw = dict(max_out=200, score_thresh=SCORE_T, iou_thresh=0.45,
              bgr_input=True, mode=mode)
    detect, invert = tpre.build_streaming_detector(
        from_jax_variables(spread_vars, device=CPU), ANCHORS, C, src_hw,
        dst_hw, device=CPU, compute_dtype=torch.float32, **kw)
    assert not detect.training
    got = detect(torch.from_numpy(frames))
    jdetect, jinvert = jpre.build_streaming_detector(
        spread_vars, ANCHORS, C, src_hw, dst_hw,
        compute_dtype=jnp.float32, **kw)
    want = jax.device_get(jdetect(jnp.asarray(frames)))

    assert got["boxes"].shape == (2, C * 200, 4)
    g = _frame_dets(got, 2)
    w = [(want["boxes"][i][want["valid"][i]],
          want["scores"][i][want["valid"][i]],
          want["labels"][i][want["valid"][i]]) for i in range(2)]
    n_w, found_w = match_detections(w, g, SCORE_T + 0.02)
    n_g, found_g = match_detections(g, w, SCORE_T + 0.02)
    assert n_w >= 10 and n_g >= 10, f"only {n_w} / {n_g} confident detections"
    assert found_w == n_w and found_g == n_g

    # the inverse transform: the same boxes give the same source pixels
    boxes = g[0][0]
    inv = invert(boxes)
    np.testing.assert_array_equal(inv, jinvert(boxes))
    assert inv.dtype == np.float32 and not np.shares_memory(inv, boxes)


def test_streaming_detector_rejects_other_modes_and_frames(spread_vars):
    v = from_jax_variables(spread_vars, device=CPU)
    for mode in ("exact", "split", "bogus"):
        with pytest.raises(ValueError, match="unsupported streaming mode"):
            tpre.build_streaming_detector(v, ANCHORS, C, (90, 120), (96, 96),
                                          device=CPU, mode=mode)
        with pytest.raises(ValueError, match="unsupported streaming mode"):
            jpre.build_streaming_detector(spread_vars, ANCHORS, C, (90, 120),
                                          (96, 96), mode=mode)
    detect, _ = tpre.build_streaming_detector(v, ANCHORS, C, (90, 120),
                                              (96, 96), device=CPU)
    with pytest.raises(ValueError, match="built for uint8 frames"):
        detect(torch.zeros((1, 96, 120, 3), dtype=torch.uint8))
    with pytest.raises(ValueError, match="built for uint8 frames"):
        detect(torch.zeros((1, 90, 120, 3)))
