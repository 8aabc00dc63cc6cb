"""The port's copies of the JAX package's host helpers equal their
originals: class names, anchor and names files, the drawing code and the
host letterbox, on the same seeded inputs."""

from pathlib import Path

import cv2
import numpy as np
import pytest

from yolov3_tensorflow_tpu import config as jax_config
from yolov3_tensorflow_tpu.data import augment as jax_augment
from yolov3_tensorflow_tpu.utils import coco as jax_coco
from yolov3_tensorflow_tpu.utils import viz as jax_viz
from yolov3_tensorflow_tpu_torch import config as port_config
from yolov3_tensorflow_tpu_torch.data import augment as port_augment
from yolov3_tensorflow_tpu_torch.utils import coco as port_coco
from yolov3_tensorflow_tpu_torch.utils import viz as port_viz

ASSETS = Path(__file__).resolve().parent.parent / "assets"


def test_coco_class_names():
    assert port_coco.COCO_CLASS_NAMES == jax_coco.COCO_CLASS_NAMES
    assert len(port_coco.COCO_CLASS_NAMES) == 80


def test_parse_anchors():
    path = str(ASSETS / "yolo_anchors.txt")
    got, want = port_config.parse_anchors(path), jax_config.parse_anchors(path)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.asarray(port_config.DEFAULT_ANCHORS,
                                                  np.float32))


@pytest.mark.parametrize("name", ["coco.names", "demo_data/synth.names"])
def test_read_class_names(name):
    path = str(ASSETS / name)
    got = port_config.read_class_names(path)
    assert got == jax_config.read_class_names(path)
    assert len(got) in (80, 3)


@pytest.mark.parametrize("classes", [3, 80])
def test_color_table(classes):
    got = port_viz.get_color_table(classes)
    assert got == jax_viz.get_color_table(classes)
    for color in got.values():
        assert port_viz._text_color(color) == jax_viz._text_color(color)


def _canvas(seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 255, (120, 160, 3),
                                                dtype=np.uint8)


# (box, label, color, line_thickness): a tag above the box, a tag pushed
# inside at the top edge, a tag clamped at the right edge, no label, the
# default color, and a thick line with fractional coordinates
PLOTS = [
    ((20.0, 40.0, 90.0, 100.0), "circle, 91.37%", [0, 128, 255], None),
    ((10.0, 2.0, 60.0, 50.0), "box, 55.00%", [255, 255, 255], None),
    ((140.0, 30.0, 170.0, 80.0), "triangle, 30.10%", [20, 20, 20], None),
    ((5.0, 5.0, 150.0, 115.0), None, [10, 200, 30], None),
    ((30.0, 60.0, 70.0, 90.0), "x", None, None),
    ((12.4, 33.6, 80.5, 99.5), "thick, 42.00%", [200, 10, 10], 4),
]


@pytest.mark.parametrize("case", range(len(PLOTS)))
def test_plot_one_box_pixel_equal(case):
    box, label, color, thick = PLOTS[case]
    got, want = _canvas(case), _canvas(case)
    port_viz.plot_one_box(got, box, label=label, color=color,
                          line_thickness=thick)
    jax_viz.plot_one_box(want, box, label=label, color=color,
                         line_thickness=thick)
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, _canvas(case))


def test_draw_detections_pixel_equal():
    rng = np.random.default_rng(3)
    xy = rng.uniform(0, 120, (6, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(10, 40, (6, 2))], 1)
    scores = rng.uniform(0.3, 1.0, 6)
    labels = rng.integers(0, 3, 6)
    names = {0: "circle", 1: "box"}          # label 2 has no name
    got = port_viz.draw_detections(_canvas(9), boxes, scores, labels, names)
    want = jax_viz.draw_detections(_canvas(9), boxes, scores, labels, names)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("interp", [cv2.INTER_NEAREST, cv2.INTER_LINEAR])
@pytest.mark.parametrize("src_hw,dst_wh", [((416, 416), (128, 96)),
                                           ((90, 120), (96, 96)),
                                           ((480, 640), (416, 416)),
                                           ((100, 140), (416, 256))])
def test_letterbox_resize_byte_equal(src_hw, dst_wh, interp):
    img = np.random.default_rng(src_hw[0]).integers(
        0, 255, src_hw + (3,), dtype=np.uint8)
    got = port_augment.letterbox_resize(img, *dst_wh, interp=interp)
    want = jax_augment.letterbox_resize(img, *dst_wh, interp=interp)
    assert got[0].shape == (dst_wh[1], dst_wh[0], 3)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]
    assert (port_augment.letterbox_params(src_hw[1], src_hw[0], *dst_wh)
            == jax_augment.letterbox_params(src_hw[1], src_hw[0], *dst_wh))


def _after_header(text: str) -> list:
    """A C++ source's lines after its leading comment block."""
    lines = text.splitlines()
    i = 0
    while i < len(lines) and (lines[i].startswith("//") or not lines[i]):
        i += 1
    return lines[i:]


def test_native_source_copy():
    """csrc/postprocess.cc equals the JAX package's native/postprocess.cc
    apart from its header comment (which names the port's binding)."""
    root = ASSETS.parent
    got = _after_header((root / "yolov3_tensorflow_tpu_torch" / "csrc" /
                         "postprocess.cc").read_text())
    want = _after_header((root / "native" / "postprocess.cc").read_text())
    assert got[0].startswith("#include") and len(got) > 100
    diff = [(i, g, w) for i, (g, w) in enumerate(zip(got, want)) if g != w]
    assert not diff and len(got) == len(want), diff[:5]
