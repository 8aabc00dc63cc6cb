"""The port's real-weights parity harness
(`yolov3_tensorflow_tpu_torch/scripts/parity_demo.py`) runs end to end on
synthetic weights on the CPU, as tests/test_parity_demo.py runs the JAX
package's at its CI sizes; its matching helpers give the JAX script's
answers on the same inputs."""

import json
import os
import shutil

import cv2
import numpy as np
import pytest
import torch

from scripts import parity_demo as jax_demo
from yolov3_tensorflow_tpu_torch.models.yolov3 import init_yolov3
from yolov3_tensorflow_tpu_torch.scripts.parity_demo import (iou_xyxy, main,
                                                             match_detections)
from yolov3_tensorflow_tpu_torch.testing import CPU_TEST_THREADS
from yolov3_tensorflow_tpu_torch.train.checkpoint import CheckpointStore

torch.set_num_threads(CPU_TEST_THREADS)


def test_match_detections_exact_and_disjoint():
    boxes = np.array([[0, 0, 10, 10], [20, 20, 40, 40]], np.float32)
    scores = np.array([0.9, 0.8], np.float32)
    labels = np.array([1, 2], np.int64)
    empty = (np.zeros((0, 4), np.float32), np.zeros(0), np.zeros(0, np.int64))
    cases = [((boxes, scores, labels), (boxes, scores, labels), (2, 2, 2)),
             # label mismatch kills the match even at IoU 1.0
             ((boxes, scores, labels), (boxes, scores, labels[::-1].copy()),
              (0, 2, 2)),
             ((boxes, scores, labels), empty, (0, 2, 0))]
    for ref, other, want in cases:
        assert match_detections(ref, other) == want
        assert jax_demo.match_detections(ref, other) == want


def test_iou_xyxy_values():
    a = np.array([[0, 0, 10, 10]], np.float32)
    b = np.array([[0, 0, 10, 10], [5, 5, 15, 15], [20, 20, 30, 30]],
                 np.float32)
    got = iou_xyxy(a, b)[0]
    np.testing.assert_allclose(got, [1.0, 25 / 175, 0.0], atol=1e-6)
    rng = np.random.default_rng(0)
    xy = rng.uniform(0, 50, (2, 6, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + rng.uniform(1, 30, (2, 6, 2))], -1)
    np.testing.assert_array_equal(iou_xyxy(boxes[0], boxes[1]),
                                  jax_demo.iou_xyxy(boxes[0], boxes[1]))


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """A checkpoint of seeded 3-class weights, shared by the harness runs
    and removed after them (~0.25 GB)."""
    root = tmp_path_factory.mktemp("parity_weights")
    variables = init_yolov3(torch.Generator().manual_seed(11), 3,
                            device=torch.device("cpu"))
    CheckpointStore(str(root / "ckpt")).save(
        "m", {"params": variables["params"],
              "batch_stats": variables["batch_stats"]})
    yield root / "ckpt" / "m"
    shutil.rmtree(root)


def demo_image(path: str) -> str:
    rng = np.random.default_rng(3)
    cv2.imwrite(path, rng.integers(0, 255, (120, 160, 3), dtype=np.uint8))
    return path


# the JAX test's CI sizes (its 608^2 and 1344x896 cases are slow there):
# the exact-vs-packed gate at 0.7 on random weights, whose near-tied scores
# let the serving path's candidate cut diverge at larger sizes
@pytest.mark.parametrize("new_size,agreement_min", [
    ((96, 96), 0.7),
    ((96, 64), 0.7),                            # non-square letterbox (w, h)
])
def test_parity_demo_harness_synthetic(tmp_path, weights, new_size,
                                       agreement_min):
    """The whole harness on synthetic weights: checkpoint -> exact and
    packed detection on the CPU -> rendered jpg, numeric JSON and a
    summary with the agreement."""
    names = tmp_path / "names.txt"
    names.write_text("a\nb\nc\n")
    img_path = demo_image(str(tmp_path / "demo.jpg"))
    out_dir = str(tmp_path / "out")

    rc = main([
        "--weights", str(weights),
        "--images", img_path,
        "--out_dir", out_dir,
        "--new_size", str(new_size[0]), str(new_size[1]),
        "--class_name_path", str(names),
        "--score_thresh", "0.2",
        "--max_boxes", "8",
        "--expect", "off",
        "--agreement_min", str(agreement_min),
        "--device", "cpu",
    ])
    assert rc == 0
    assert os.path.exists(os.path.join(out_dir, "demo.jpg"))
    with open(os.path.join(out_dir, "demo_detections.json")) as f:
        dets = json.load(f)
    assert all({"box_xyxy", "score", "label", "class"} <= set(d)
               for d in dets["detections"])
    with open(os.path.join(out_dir, "parity_summary.json")) as f:
        summary = json.load(f)
    assert summary["ok"] is True
    entry = summary["images"]["demo"]
    assert entry["n_exact"] >= 1          # random weights at 0.2 detect
    assert entry["agreement"] >= agreement_min


def test_parity_demo_split_serving_mode(tmp_path, weights):
    """--serving_mode split runs the harness through the split detector
    and passes its agreement check against the exact path."""
    names = tmp_path / "names.txt"
    names.write_text("a\nb\nc\n")
    out_dir = str(tmp_path / "out")
    rc = main(["--weights", str(weights),
               "--images", demo_image(str(tmp_path / "demo.jpg")),
               "--out_dir", out_dir, "--new_size", "96", "96",
               "--class_name_path", str(names), "--score_thresh", "0.2",
               "--max_boxes", "8", "--expect", "off", "--agreement_min",
               "0.7", "--serving_mode", "split", "--device", "cpu"])
    assert rc == 0
    with open(os.path.join(out_dir, "parity_summary.json")) as f:
        summary = json.load(f)
    assert summary["ok"] is True
    assert summary["settings"]["serving_mode"] == "split"
    assert summary["images"]["demo"]["n_serving"] >= 1
    assert summary["images"]["demo"]["agreement"] >= 0.7


def test_parity_demo_fails_a_missing_class(tmp_path, weights, capsys):
    """--expect coco fails (exit code 1) when a demo image lacks its known
    COCO classes (here the names file calls the weights' classes person,
    kite and c, and the image is one grey field), and says which."""
    names = tmp_path / "names.txt"
    names.write_text("person\nkite\nc\n")
    img_path = str(tmp_path / "kite.jpg")
    cv2.imwrite(img_path, np.full((64, 64, 3), 127, np.uint8))
    rc = main(["--weights", str(weights), "--images", img_path,
               "--out_dir", str(tmp_path / "out"), "--new_size", "64", "64",
               "--class_name_path", str(names), "--score_thresh", "0.9",
               "--device", "cpu"])
    assert rc == 1
    assert "kite: expected classes missing" in capsys.readouterr().err
