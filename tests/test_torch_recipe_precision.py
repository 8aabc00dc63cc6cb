"""The port's recipe-precision analyzer on a small gate directory, on the
CPU.

A 4-image 64^2 gate directory laid out as `scripts/overfit_gate.py` writes
it (`data/train.txt`, `data/synth.names`, `ckpt/overfit_final`), with a
seeded random-init checkpoint (every score near 0.25: a long tail above
0.01). The analyzer's mAP at cutoff 0.01 is `cli.evaluate`'s on the same
directory; every cutoff's recall, precision and mAP equal JAX's
`evaluation/voc.py:evaluate_map` on the same prediction rows; every
detection's score is one of the decomposed (anchor, class) products
sigmoid(conf) * class prob, bit for bit, and each decomposed anchor's
product is its best class's pair.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from yolov3_tensorflow_tpu.evaluation import voc as jax_voc
from yolov3_tensorflow_tpu_torch.cli import evaluate
from yolov3_tensorflow_tpu_torch.data.synthetic import generate_dataset
from yolov3_tensorflow_tpu_torch.models.yolov3 import init_yolov3
from yolov3_tensorflow_tpu_torch.scripts import analyze_recipe_precision as arp
from yolov3_tensorflow_tpu_torch.testing import CPU_TEST_THREADS
from yolov3_tensorflow_tpu_torch.train.checkpoint import CheckpointStore

torch.set_num_threads(CPU_TEST_THREADS)

CPU = torch.device("cpu")
SIZE = 64


@pytest.fixture(scope="module")
def gate(tmp_path_factory):
    out = tmp_path_factory.mktemp("gate")
    data = generate_dataset(str(out / "data"), num_images=4, seed=0,
                            img_size=(SIZE, SIZE))
    assert Path(data["annotation_file"]) == out / "data" / "train.txt"
    assert Path(data["names_file"]) == out / "data" / "synth.names"
    variables = init_yolov3(torch.Generator().manual_seed(0), 3, device=CPU)
    CheckpointStore(str(out / "ckpt")).save(
        "overfit_final", {"params": variables["params"],
                          "batch_stats": variables["batch_stats"],
                          "step": 0}, include_opt=False)
    with torch.inference_mode():
        run = arp.eval_gate(str(out), SIZE, CPU)
    return out, run


def test_sweep_at_001_is_cli_evaluate(gate):
    out, run = gate
    sweep = arp.sweep(run)
    want = evaluate.run_eval(evaluate.build_parser().parse_args([
        "--eval_file", str(out / "data" / "train.txt"), "--restore_path",
        str(out / "ckpt" / "overfit_final"), "--class_name_path",
        str(out / "data" / "synth.names"), "--img_size", str(SIZE),
        str(SIZE), "--device", "cpu"]))
    assert sweep["0.01"]["mAP"] == want["mAP"]
    assert sweep["0.01"]["recall"] == want["recall"]
    assert sweep["0.01"]["precision"] == want["precision"]
    assert sweep["0.01"]["n_dets"] == len(run["rows"]) > 0
    assert run["batches"] == 1                       # eval.batch_size 8


def test_sweep_matches_jax_evaluate_map(gate):
    out, run = gate
    cfg = run["cfg"]
    gt = jax_voc.parse_gt_records(str(out / "data" / "train.txt"),
                                  (SIZE, SIZE), True)
    assert gt == run["gt"]
    sweep = arp.sweep(run)
    assert list(sweep) == [str(c) for c in arp.CUTOFFS]
    counts = [s["n_dets"] for s in sweep.values()]
    assert counts == sorted(counts, reverse=True) and counts[0] > counts[-1]
    for cut, got in sweep.items():
        kept = [r for r in run["rows"] if r[5] >= float(cut)]
        want = jax_voc.evaluate_map(gt, kept, cfg.model.num_classes,
                                    cfg.eval.eval_threshold,
                                    cfg.eval.use_voc_07_metric)
        for key in ("recall", "precision", "mAP"):
            assert got[key] == want[key], (cut, key)


def test_decomposition_products_are_the_detection_scores(gate):
    _, run = gate
    pairs = {(int(i), int(lab), np.float32(s)) for i, lab, s in run["pairs"]}
    for img, *_, score, label in run["rows"]:
        assert (int(img), int(label), np.float32(score)) in pairs
    conf, prob = run["anchors"][:, 0], run["anchors"][:, 1]
    products = (conf * prob).astype(np.float32)
    assert len(products) and (products > arp.TAIL).all()
    assert {np.float32(p) for p in products} <= {s for _, _, s in pairs}
    d = arp.decomposition(run["anchors"])
    assert d["n_anchors_above_001"] == len(products)
    assert 0 < d["conf_quantiles_50_90_99"][0] < 1


def test_main_writes_json_and_note(gate, capsys, tmp_path):
    out, _ = gate
    rc = arp.main(["--device", "cpu", "--img_size", str(SIZE), "--gate",
                   f"tiny={out}", "--gate", f"none={tmp_path / 'none'}",
                   "--out", str(tmp_path / "r.json"), "--note",
                   str(tmp_path / "note.md")])
    assert rc == 0
    text = capsys.readouterr().out
    assert "[none] missing checkpoint dir" in text
    last = json.loads(text.strip().splitlines()[-1])
    assert last == json.loads((tmp_path / "r.json").read_text())
    assert list(last["gates"]) == ["tiny"] and last["device"] == "cpu"
    assert last["gates"]["tiny"]["eval_batches"] == 1
    note = (tmp_path / "note.md").read_text()
    assert "## tiny" in note and "| 0.01 |" in note
    defaults = arp.build_parser().parse_args([])
    for path in (defaults.out, defaults.note):
        assert Path(path).parts[0] == "build"
    assert all(Path(d).parts[0] == "build" for _, d in arp.GATES)
