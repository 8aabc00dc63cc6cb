"""The port's image and video CLIs against the JAX package's, on the CPU
(mirrors tests/test_e2e_cli.py).

Both CLIs of both packages load the same darknet .weights file (3 classes,
seeded weights with the spread head, written by the port's
save_darknet_weights) and read the same inputs. The tests patch every
detector builder the CLIs call to fp32: in bf16 the scores tie often, and
the packages order equal scores differently. Detections are recorded by
wrapping each CLI module's `plot_one_box` (video frames are delimited by
their `unpack_detections` calls), in source-image pixels, and held to
detection identity both ways: same label, IoU >= 0.9, for every detection
scored at least 0.02 above the threshold.
"""

import functools
from pathlib import Path

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov3_tensorflow_tpu.cli import detect_image as jax_image
from yolov3_tensorflow_tpu.cli import detect_video as jax_video
from yolov3_tensorflow_tpu.ops import postprocess as jax_post
from yolov3_tensorflow_tpu.ops import preprocess as jax_pre
from yolov3_tensorflow_tpu.utils import cache as jax_cache
from yolov3_tensorflow_tpu_torch.cli import detect_image as port_image
from yolov3_tensorflow_tpu_torch.cli import detect_video as port_video
from yolov3_tensorflow_tpu_torch.models.convert import (from_jax_variables,
                                                        spread_head)
from yolov3_tensorflow_tpu_torch.ops import postprocess as port_post
from yolov3_tensorflow_tpu_torch.ops import preprocess as port_pre
from yolov3_tensorflow_tpu_torch.testing import (CPU_TEST_THREADS,
                                                 match_detections,
                                                 numpy_variables)
from yolov3_tensorflow_tpu_torch.utils.weights import save_darknet_weights

torch.set_num_threads(CPU_TEST_THREADS)

ASSETS = Path(__file__).resolve().parent.parent / "assets"
NAMES = str(ASSETS / "demo_data" / "synth.names")
CLASSES = ["circle", "box", "triangle"]
SCORE_T = 0.3
FRAMES = 6


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    path = tmp_path_factory.mktemp("cli") / "synth3.weights"
    variables = spread_head(numpy_variables(len(CLASSES), seed=0), seed=0)
    save_darknet_weights(from_jax_variables(variables,
                                            device=torch.device("cpu")),
                         str(path), len(CLASSES))
    return str(path)


@pytest.fixture(scope="module")
def video(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("video") / "in.mp4")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 5,
                             (120, 90))
    assert writer.isOpened()
    rng = np.random.default_rng(1)
    for _ in range(FRAMES):
        writer.write(rng.integers(0, 255, (90, 120, 3), dtype=np.uint8))
    writer.release()
    return path


@pytest.fixture
def fp32(monkeypatch):
    """Every detector builder the four CLIs call builds fp32 detectors,
    and the JAX CLIs' persistent compile cache stays off."""
    monkeypatch.setattr(jax_cache, "enable_compile_cache",
                        lambda *a, **k: None)
    jdet = functools.partial(jax_post.build_detector,
                             compute_dtype=jnp.float32)
    pdet = functools.partial(port_post.build_detector,
                             compute_dtype=torch.float32)
    for module, fn in ((jax_image, jdet), (jax_video, jdet),
                       (port_image, pdet), (port_video, pdet)):
        monkeypatch.setattr(module, "build_detector", fn)
    monkeypatch.setattr(jax_pre, "build_streaming_detector", functools.partial(
        jax_pre.build_streaming_detector, compute_dtype=jnp.float32))
    monkeypatch.setattr(port_video, "build_streaming_detector",
                        functools.partial(port_pre.build_streaming_detector,
                                          compute_dtype=torch.float32))


def _record(monkeypatch, module):
    """Per-frame lists of (box, score, label) that `module` draws. A new
    frame starts at each `unpack_detections` call (video) or, for the
    image CLI, there is one frame."""
    plot, unpack = module.plot_one_box, getattr(module, "unpack_detections",
                                               None)
    frames = [] if unpack is not None else [[]]

    def plot_one_box(img, coord, label=None, color=None,
                     line_thickness=None):
        name, pct = label.rsplit(", ", 1)
        frames[-1].append((np.asarray(coord, np.float32),
                           float(pct.rstrip("%")) / 100,
                           CLASSES.index(name)))
        plot(img, coord, label=label, color=color,
             line_thickness=line_thickness)

    def unpack_detections(packed, batch_index=0):
        frames.append([])
        return unpack(packed, batch_index)

    monkeypatch.setattr(module, "plot_one_box", plot_one_box)
    if unpack is not None:
        monkeypatch.setattr(module, "unpack_detections", unpack_detections)
    return frames


def _as_arrays(frames):
    out = []
    for dets in frames:
        boxes = np.array([d[0] for d in dets], np.float32).reshape(-1, 4)
        out.append((boxes, np.array([d[1] for d in dets], np.float32),
                    np.array([d[2] for d in dets], np.int64)))
    return out


def _same_detections(port, jax, min_detections):
    port, jax = _as_arrays(port), _as_arrays(jax)
    assert len(port) == len(jax)
    n_j, found_j = match_detections(jax, port, SCORE_T + 0.02)
    n_p, found_p = match_detections(port, jax, SCORE_T + 0.02)
    assert n_j >= min_detections and n_p >= min_detections, (n_j, n_p)
    assert found_j == n_j, f"port misses {n_j - found_j} of {n_j} detections"
    assert found_p == n_p, f"port adds {n_p - found_p} of {n_p} detections"


@pytest.mark.parametrize("mode", ["prefilter", "exact", "packed", "split"])
def test_detect_image_matches_jax(mode, weights, fp32, monkeypatch,
                                  tmp_path):
    image = str(ASSETS / "demo_data" / "synth_shapes_1.jpg")
    args = [image, "--restore_path", weights, "--class_name_path", NAMES,
            "--new_size", "128", "96", "--mode", mode]
    port = _record(monkeypatch, port_image)
    jax = _record(monkeypatch, jax_image)
    out = str(tmp_path / "port.jpg")
    assert port_image.main(args + ["--device", "cpu", "--output", out]) == 0
    assert jax_image.main(args + ["--output", str(tmp_path / "jax.jpg")]) == 0
    assert cv2.imread(out).shape == cv2.imread(image).shape
    _same_detections(port, jax, min_detections=20)


@pytest.mark.parametrize("frame_batch", [1, 4])
@pytest.mark.parametrize("device_preprocess", ["true", "false"])
def test_detect_video_matches_jax(device_preprocess, frame_batch, weights,
                                  video, fp32, monkeypatch, tmp_path):
    """6 frames at 90x120 into 96x96; frame_batch 4 pads the short last
    batch with copies of its last frame and drops the pad rows."""
    args = [video, "--restore_path", weights, "--class_name_path", NAMES,
            "--new_size", "96", "96", "--frame_batch", str(frame_batch),
            "--device_preprocess", device_preprocess, "--pipeline_depth", "2"]
    port = _record(monkeypatch, port_video)
    jax = _record(monkeypatch, jax_video)
    out = str(tmp_path / "port.mp4")
    assert port_video.main(args + ["--device", "cpu", "--save_video", "true",
                                   "--output", out]) == 0
    assert jax_video.main(args) == 0
    assert len(port) == len(jax) == FRAMES
    _same_detections(port, jax, min_detections=10)
    cap = cv2.VideoCapture(out)
    shapes = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        shapes.append(frame.shape)
    cap.release()
    assert shapes == [(90, 120, 3)] * FRAMES


def test_checkpoint_directory_raises(weights, tmp_path):
    """A directory that is no checkpoint of this package (here an empty
    one) raises, naming the formats the CLIs read."""
    with pytest.raises(ValueError, match="neither a darknet .weights file "
                                         "nor a checkpoint directory"):
        port_image.main([str(ASSETS / "demo_data" / "synth_shapes_1.jpg"),
                         "--restore_path", str(tmp_path), "--device", "cpu",
                         "--class_name_path", NAMES])


@pytest.mark.parametrize("device_preprocess", ["false", "true"])
def test_detect_video_split_matches_jax(device_preprocess, weights, video,
                                        fp32, monkeypatch, tmp_path):
    """--mode split: with host preprocessing both packages build the split
    detector; with device preprocessing both stream in prefilter mode (the
    JAX CLI's rule)."""
    args = [video, "--restore_path", weights, "--class_name_path", NAMES,
            "--new_size", "96", "96", "--frame_batch", "4", "--mode",
            "split", "--device_preprocess", device_preprocess]
    built = []
    pdet = port_video.build_detector
    monkeypatch.setattr(port_video, "build_detector",
                        lambda *a, **k: built.append(k["mode"]) or
                        pdet(*a, **k))
    port = _record(monkeypatch, port_video)
    jax = _record(monkeypatch, jax_video)
    out = str(tmp_path / "port.mp4")
    assert port_video.main(args + ["--device", "cpu", "--save_video", "true",
                                   "--output", out]) == 0
    assert jax_video.main(args) == 0
    assert built == (["split"] if device_preprocess == "false" else [])
    assert len(port) == len(jax) == FRAMES
    _same_detections(port, jax, min_detections=10)


@pytest.mark.parametrize("cli", ["image", "video"])
def test_cuda_without_a_gpu_exits(cli, weights, video, monkeypatch):
    """No quiet fall back to the CPU: asking for CUDA without a GPU exits
    non-zero, with a message, before anything loads."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if cli == "image":
        main, src = port_image.main, str(ASSETS / "demo_data" /
                                         "synth_shapes_1.jpg")
    else:
        main, src = port_video.main, video
    with pytest.raises(SystemExit) as exc:
        main([src, "--restore_path", weights, "--class_name_path", NAMES])
    assert "no CUDA device" in str(exc.value.code)
