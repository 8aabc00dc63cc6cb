"""The port's evaluation and checkpoint CLIs and its host-only tools, on the
CPU, against the JAX package's.

- `cli.evaluate.run_eval` on a checkpoint of this package made from JAX
  variables (`from_jax_variables`), against JAX's `run_eval` on an orbax
  checkpoint of the same variables: fp32, 96^2, 4 synthetic images, 3
  classes, ground truth taken from the detections themselves (the top 3
  inside each image, so that matches and misses both occur). mAP, recall,
  precision and every class's AP equal; the mean losses within 1e-4.
- `cli.convert_weights` -> `cli.common.load_variables` gives the tensors of
  `load_darknet_weights`, and step 0; `load_variables` refuses a directory
  that is no checkpoint, naming both formats.
- `cli.strip_checkpoint` keeps the keys JAX's keeps.
- `cli.kmeans_anchors` prints and writes JAX's anchors and average IoU on
  one file and seed; `utils.kmeans` equals its original.
- `cli.parse_voc` writes JAX's bytes on a small VOC tree.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

from yolov3_tensorflow_tpu.cli import evaluate as jax_evaluate
from yolov3_tensorflow_tpu.cli import kmeans_anchors as jax_kmeans_cli
from yolov3_tensorflow_tpu.cli import parse_voc as jax_parse_voc
from yolov3_tensorflow_tpu.cli import strip_checkpoint as jax_strip
from yolov3_tensorflow_tpu.train.checkpoint import \
    CheckpointStore as JaxStore
from yolov3_tensorflow_tpu.utils import coco as jax_coco
from yolov3_tensorflow_tpu.utils import kmeans as jax_kmeans
from yolov3_tensorflow_tpu_torch.cli import convert_weights, evaluate
from yolov3_tensorflow_tpu_torch.cli import kmeans_anchors as kmeans_cli
from yolov3_tensorflow_tpu_torch.cli import parse_voc, strip_checkpoint
from yolov3_tensorflow_tpu_torch.cli.common import load_variables
from yolov3_tensorflow_tpu_torch.config import Config
from yolov3_tensorflow_tpu_torch.data.annotations import (parse_line,
                                                          read_annotation_file)
from yolov3_tensorflow_tpu_torch.data.loader import DataLoader
from yolov3_tensorflow_tpu_torch.data.synthetic import generate_dataset
from yolov3_tensorflow_tpu_torch.models.convert import (from_jax_variables,
                                                        spread_head)
from yolov3_tensorflow_tpu_torch.models.yolov3 import init_yolov3
from yolov3_tensorflow_tpu_torch.testing import (CPU_TEST_THREADS,
                                                 numpy_variables)
from yolov3_tensorflow_tpu_torch.train.checkpoint import CheckpointStore
from yolov3_tensorflow_tpu_torch.train.optimizers import flatten
from yolov3_tensorflow_tpu_torch.train.trainer import (make_eval_step,
                                                       to_device, to_host)
from yolov3_tensorflow_tpu_torch.utils import coco, kmeans
from yolov3_tensorflow_tpu_torch.utils.weights import (load_darknet_weights,
                                                       save_darknet_weights)

torch.set_num_threads(CPU_TEST_THREADS)

CPU = torch.device("cpu")
EVAL_OVERRIDES = ["model.compute_dtype=float32", "eval.batch_size=2",
                  "eval.pre_nms_topk=256", "eval.nms_topk=50"]


def run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    return out.getvalue()


@pytest.fixture(scope="module")
def variables():
    """A JAX-layout tree with spread detection logits (varied scores)."""
    return spread_head(numpy_variables(3, seed=5), seed=1)


def self_labelled(tmp, variables):
    """4 synthetic 96^2 images whose ground truth is each image's 3 best
    detections inside the image under `variables` (through the port's eval
    step)."""
    data = generate_dataset(str(tmp / "data"), num_images=4, seed=3,
                            img_size=(96, 96), max_shapes=2)
    cfg = Config()
    cfg.data.class_name_path = data["names_file"]
    cfg.model.compute_dtype = "float32"
    cfg.eval.pre_nms_topk, cfg.eval.nms_topk = 256, 50
    cfg.finalize(count_files=False)
    tree = from_jax_variables(variables, device=CPU)
    batch = next(iter(DataLoader(data["annotation_file"], 3, cfg.anchors, 4,
                                 (96, 96), mode="val", num_threads=2
                                 ).epoch(0)))
    _, dets = make_eval_step(cfg)(tree, to_device(batch.images, CPU),
                                  tuple(to_device(y, CPU)
                                        for y in batch.y_true))
    (dets,) = to_host(dets)
    paths = {a.index: a.path for a in map(
        parse_line, read_annotation_file(data["annotation_file"]))}
    lines = []
    for i, index in enumerate(batch.image_ids.tolist()):
        boxes = dets["boxes"][i]
        inside = (boxes[:, :2] >= 0).all(1) & (boxes[:, 2:] <= 96).all(1)
        valid = np.flatnonzero(dets["valid"][i] & inside)
        top = valid[np.argsort(-dets["scores"][i][valid], kind="stable")][:3]
        fields = [str(index), paths[index], "96", "96"]
        for k in top:
            fields.append(str(int(dets["labels"][i][k])))
            fields += [f"{v:.3f}" for v in boxes[k]]
        lines.append(" ".join(fields))
    ann = tmp / "self.txt"
    ann.write_text("\n".join(lines) + "\n")
    return str(ann), data["names_file"]


def test_run_eval_matches_jax(tmp_path, variables):
    ann, names = self_labelled(tmp_path, variables)
    port_store = CheckpointStore(str(tmp_path / "port"))
    port_ckpt = port_store.save("ckpt", {
        **from_jax_variables(variables, device=CPU), "step": 0})
    jax_ckpt = JaxStore(str(tmp_path / "jax")).save(
        "ckpt", {**variables, "step": np.int64(0)})
    common = ["--eval_file", ann, "--class_name_path", names, "--img_size",
              "96", "96", "--num_threads", "2"]
    got = evaluate.run_eval(evaluate.build_parser().parse_args(
        common + ["--restore_path", port_ckpt, "--device", "cpu"]
        + EVAL_OVERRIDES))
    want = jax_evaluate.run_eval(jax_evaluate.build_parser().parse_args(
        common + ["--restore_path", jax_ckpt] + EVAL_OVERRIDES))
    for key in ("mAP", "recall", "precision"):
        assert got[key] == want[key], key
    assert got["recall"] > 0.5 and 0.1 < max(
        r["ap"] for r in got["per_class"].values()) < 1.0
    assert got["per_class"].keys() == want["per_class"].keys()
    for c, r in want["per_class"].items():
        assert got["per_class"][c] == r, c
    for k, v in want["losses"].items():
        assert abs(got["losses"][k] - v) <= 1e-4 * max(abs(v), 1.0), k


def test_evaluate_main_prints_and_refuses_a_plain_directory(
        tmp_path, variables, capsys):
    ann, names = self_labelled(tmp_path, variables)
    ckpt = CheckpointStore(str(tmp_path / "c")).save(
        "ckpt", from_jax_variables(variables, device=CPU))
    args = ["--eval_file", ann, "--class_name_path", names, "--img_size",
            "96", "96", "--device", "cpu", "--num_threads", "2"]
    assert evaluate.main(args + ["--restore_path", ckpt]
                         + EVAL_OVERRIDES) == 0
    out = capsys.readouterr().out
    assert "EVAL: Recall:" in out and "mAP:" in out
    with pytest.raises(ValueError, match="darknet .weights file nor a "
                                         "checkpoint directory"):
        load_variables(str(tmp_path), 3, CPU)


def test_convert_weights_round_trip(tmp_path, variables):
    path = str(tmp_path / "w.weights")
    save_darknet_weights(from_jax_variables(variables, device=CPU), path, 3)
    out = run(convert_weights.main, ["--weights", path, "--output",
                                     str(tmp_path / "ckpt" / "conv"),
                                     "--num_classes", "3", "--device", "cpu"])
    assert "converted" in out
    got = load_variables(str(tmp_path / "ckpt" / "conv"), 3, CPU)
    want = load_darknet_weights(
        init_yolov3(torch.Generator().manual_seed(7), 3, device=CPU), path, 3)
    got, want = flatten(got), flatten(want)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    state = CheckpointStore(str(tmp_path / "ckpt")).restore("conv")
    assert state["step"] == 0 and "opt_state" not in state


def test_strip_checkpoint_keeps_jax_keys(tmp_path):
    rng = np.random.default_rng(0)
    tree = {"params": {"a": rng.normal(size=(3,)).astype(np.float32)},
            "batch_stats": {"m": np.ones(2, np.float32)},
            "opt_state": {"mu": np.zeros(3, np.float32)},
            "step": np.int64(4)}
    port_tree = {"params": {"a": torch.from_numpy(tree["params"]["a"])},
                 "batch_stats": {"m": torch.ones(2)},
                 "opt_state": {"mu": torch.zeros(3)}, "step": 4}
    p_in = CheckpointStore(str(tmp_path / "p")).save("full", port_tree)
    j_in = JaxStore(str(tmp_path / "j")).save("full", tree)
    got = run(strip_checkpoint.main, ["--input", p_in, "--output",
                                      str(tmp_path / "p" / "stripped")])
    want = run(jax_strip.main, ["--input", j_in, "--output",
                                str(tmp_path / "j" / "stripped")])
    assert got.split("(kept:")[1] == want.split("(kept:")[1]
    restored = CheckpointStore(str(tmp_path / "p")).restore("stripped")
    assert sorted(restored) == sorted(
        JaxStore(str(tmp_path / "j")).restore("stripped"))
    assert torch.equal(restored["params"]["a"], port_tree["params"]["a"])


def test_kmeans_anchors_equal(tmp_path):
    data = generate_dataset(str(tmp_path / "d"), num_images=12, seed=2,
                            img_size=(120, 90), max_shapes=4)
    ann = data["annotation_file"]
    sizes = kmeans.parse_annotation_sizes(ann, (416, 416))
    np.testing.assert_array_equal(
        sizes, jax_kmeans.parse_annotation_sizes(ann, (416, 416)))
    for k, seed in ((9, 0), (5, 3)):
        a, iou = kmeans.kmeans_anchors(sizes, k, seed=seed)
        b, jiou = jax_kmeans.kmeans_anchors(sizes, k, seed=seed)
        np.testing.assert_array_equal(a, b)
        assert iou == jiou
        assert kmeans.anchors_to_string(a) == jax_kmeans.anchors_to_string(b)
    argv = [ann, "--clusters", "6", "--seed", "1", "--output"]
    got = run(kmeans_cli.main, argv + [str(tmp_path / "a.txt")])
    want = run(jax_kmeans_cli.main, argv + [str(tmp_path / "b.txt")])
    assert got == want
    assert (tmp_path / "a.txt").read_bytes() == \
        (tmp_path / "b.txt").read_bytes()


def voc_tree(root):
    """VOC2007 with 4 images: a difficult object, an unknown class, an
    image left without objects."""
    objects = {
        "000001": [("dog", 0, (48, 240, 195, 371)),
                   ("person", 0, (8, 12, 352, 498))],
        "000002": [("train", 0, (139, 200, 207, 301)),
                   ("cat", 1, (10, 10, 50, 50))],
        "000003": [("unicorn", 0, (1, 2, 3, 4)),
                   ("cat", 1, (5, 6, 7, 8))],
        "000004": [("tvmonitor", 0, (12, 14, 90, 100))],
    }
    base = root / "VOC2007"
    for sub in ("Annotations", "ImageSets/Main", "JPEGImages"):
        (base / sub).mkdir(parents=True)
    for img_id, objs in objects.items():
        body = "".join(
            f"<object><name>{n}</name><difficult>{d}</difficult><bndbox>"
            f"<xmin>{b[0]}</xmin><ymin>{b[1]}</ymin><xmax>{b[2]}</xmax>"
            f"<ymax>{b[3]}</ymax></bndbox></object>" for n, d, b in objs)
        (base / "Annotations" / f"{img_id}.xml").write_text(
            f"<annotation><size><width>353</width><height>500</height>"
            f"<depth>3</depth></size>{body}</annotation>")
    (base / "ImageSets/Main/trainval.txt").write_text("000001\n000002\n")
    (base / "ImageSets/Main/test.txt").write_text("000003\n\n000004\n")


def test_parse_voc_byte_equal(tmp_path):
    assert coco.VOC_CLASS_NAMES == jax_coco.VOC_CLASS_NAMES
    voc_tree(tmp_path)
    sets = ["--train_sets", "2007:trainval", "--test_sets", "2007:test",
            "--voc_root", str(tmp_path)]
    got = run(parse_voc.main, sets + ["--out_dir", str(tmp_path / "p")])
    want = run(jax_parse_voc.main, sets + ["--out_dir", str(tmp_path / "j")])
    assert got == want == "wrote 2 train lines\nwrote 1 val lines\n"
    for name in ("train.txt", "val.txt"):
        assert (tmp_path / "p" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes()
