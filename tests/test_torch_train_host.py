"""The port's host-side training helpers, on the CPU: the copied metrics,
VOC evaluation and summary writer equal to their JAX-package originals on
the same seeded inputs, and the port's own checkpoint store (round trip,
`latest` by mtime, parameter-only saves) with `scope_filter`,
`partial_restore` and `strip_optimizer` selecting what the JAX functions
select."""

import time

import jax
import numpy as np
import pytest
import torch

from yolov3_tensorflow_tpu.evaluation import metrics as jm
from yolov3_tensorflow_tpu.evaluation import voc as jvoc
from yolov3_tensorflow_tpu.train import checkpoint as jck
from yolov3_tensorflow_tpu.utils import summary as jsum
from yolov3_tensorflow_tpu_torch.config import DEFAULT_ANCHORS
from yolov3_tensorflow_tpu_torch.data.encoder import encode_labels
from yolov3_tensorflow_tpu_torch.data.synthetic import generate_dataset
from yolov3_tensorflow_tpu_torch.evaluation import metrics as tm
from yolov3_tensorflow_tpu_torch.evaluation import voc as tvoc
from yolov3_tensorflow_tpu_torch.train import checkpoint as tck
from yolov3_tensorflow_tpu_torch.utils import summary as tsum
from yolov3_tensorflow_tpu_torch.testing import CPU_TEST_THREADS

torch.set_num_threads(CPU_TEST_THREADS)

ANCHORS = np.asarray(DEFAULT_ANCHORS, np.float32)


def _dets(seed, batch=3, m=40, c=4):
    """Fixed-shape NMS output of a batch, as numpy."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 80, (batch, m, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(5, 40, (batch, m, 2))], -1)
    return {"boxes": boxes.astype(np.float32),
            "scores": rng.uniform(0, 1, (batch, m)).astype(np.float32),
            "labels": rng.integers(0, c, (batch, m)).astype(np.int32),
            "valid": rng.uniform(0, 1, (batch, m)) < 0.6}


def _y_true(dets, seed, c=4):
    """Label grids holding a noisy copy of some detections as ground truth."""
    rng = np.random.default_rng(seed)
    grids = []
    for i in range(dets["boxes"].shape[0]):
        pick = rng.choice(dets["boxes"].shape[1], 6, replace=False)
        boxes = dets["boxes"][i, pick] + rng.normal(0, 2, (6, 4))
        labels = np.where(rng.uniform(size=6) < 0.7, dets["labels"][i, pick],
                          rng.integers(0, c, 6))
        grids.append(encode_labels(boxes.astype(np.float32), labels,
                                   (128, 128), c, ANCHORS))
    return [np.stack([g[s] for g in grids]) for s in range(3)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_batch_metrics_equal(seed):
    dets = _dets(seed)
    y_true = _y_true(dets, seed + 10)
    for t in (0.3, 0.5):
        assert (tm.evaluate_batch(dets, y_true, 4, t)
                == jm.evaluate_batch(dets, y_true, 4, t))
    for i in range(3):
        got = tm.extract_gt_from_y_true(y_true, i)
        want = jm.extract_gt_from_y_true(y_true, i)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(
        tm.iou_matrix(dets["boxes"][0], dets["boxes"][1]),
        jm.iou_matrix(dets["boxes"][0], dets["boxes"][1]), rtol=1e-6,
        atol=1e-7)
    ids = np.arange(3) + 7
    assert (tm.detections_to_pred_rows(dets, ids)
            == jm.detections_to_pred_rows(dets, ids))


def test_average_meter_equal():
    got, want = tm.AverageMeter(), jm.AverageMeter()
    for v, n in ((1.5, 2), (3.0, 1), (0.25, 5)):
        got.update(v, n)
        want.update(v, n)
        assert vars(got) == vars(want)


@pytest.fixture(scope="module")
def annotations(tmp_path_factory):
    root = tmp_path_factory.mktemp("voc")
    return generate_dataset(str(root), num_images=6, seed=4,
                            img_size=(160, 120), max_shapes=3)


@pytest.mark.parametrize("letterbox", [True, False])
@pytest.mark.parametrize("use_07", [False, True])
def test_voc_evaluation_equal(annotations, letterbox, use_07):
    path = annotations["annotation_file"]
    gt = tvoc.parse_gt_records(path, (96, 128), letterbox)
    assert gt == jvoc.parse_gt_records(path, (96, 128), letterbox)
    rng = np.random.default_rng(int(letterbox) + 2 * int(use_07))
    rows = []
    for img_id, objs in gt.items():
        for o in objs:                       # a noisy hit per object ...
            rows.append([img_id, *(np.asarray(o[:4]) + rng.normal(0, 3, 4)),
                         float(rng.uniform()), int(o[4])])
        for _ in range(3):                   # ... and some misses
            xy = rng.uniform(0, 80, 2)
            rows.append([img_id, *xy, *(xy + 20), float(rng.uniform()),
                         int(rng.integers(0, 3))])
    assert (tvoc.evaluate_map(gt, rows, 3, 0.5, use_07)
            == jvoc.evaluate_map(gt, rows, 3, 0.5, use_07))
    assert tvoc.voc_eval(gt, [], 1) == jvoc.voc_eval(gt, [], 1)
    rec = np.sort(rng.uniform(0, 1, 10))
    prec = rng.uniform(0, 1, 10)
    assert tvoc.voc_ap(rec, prec, use_07) == jvoc.voc_ap(rec, prec, use_07)


def test_summary_writer_bytes_equal(tmp_path, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1700000000.25)
    for module, name in ((tsum, "port"), (jsum, "jax")):
        writer = module.SummaryWriter(str(tmp_path / name))
        for step in range(3):
            writer.scalar("train_batch_statistics/loss_total",
                          10.0 / (step + 1), step)
            writer.scalar("learning_rate", 1e-4 * step, step)
        writer.close()
        null = module.NullSummaryWriter()
        null.scalar("x", 1.0, 0)
        null.flush()
        null.close()
    port = sorted((tmp_path / "port").iterdir())
    ref = sorted((tmp_path / "jax").iterdir())
    assert [p.name for p in port] == [p.name for p in ref]
    assert len(port) == 2
    for a, b in zip(port, ref):
        assert a.read_bytes() == b.read_bytes()
    for data in (b"", b"123456789", bytes(range(256))):
        assert tsum.crc32c(data) == jsum.crc32c(data)
    assert tsum.crc32c(b"123456789") == 0xE3069283   # the CRC-32C check


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    params = {"backbone": {"conv_0": {"w": torch.randn(4, 2, 3, 3,
                                                       generator=g),
                                      "gamma": torch.randn(4, generator=g)}},
              "head": {"conv_6": {"w": torch.randn(6, 4, 1, 1, generator=g),
                                  "b": torch.randn(6, generator=g)},
                       "conv_7": {"w": torch.randn(3, 4, 1, 1,
                                                   generator=g)}}}
    return {"params": params,
            "batch_stats": {"backbone": {"conv_0": {"mean": torch.zeros(4),
                                                    "var": torch.ones(4)}}},
            "opt_state": {"count": 5, "trace": {
                "head/conv_6/w": torch.randn(6, 4, 1, 1, generator=g)}},
            "step": 17}


def _same_tree(a, b):
    assert type(a) is type(b) or isinstance(a, torch.Tensor)
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _same_tree(a[k], b[k])
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b)
    else:
        assert a == b


def test_checkpoint_round_trip(tmp_path):
    store = tck.CheckpointStore(str(tmp_path / "ckpt"))
    state = _state()
    path = store.save("model-epoch_1", state)
    assert path == str(tmp_path / "ckpt" / "model-epoch_1")
    assert sorted(p.name for p in (tmp_path / "ckpt" / "model-epoch_1")
                  .iterdir()) == [tck.STATE_FILE]
    back = store.restore("model-epoch_1")
    _same_tree(back, state)
    assert isinstance(back["step"], int) and back["opt_state"]["count"] == 5
    _same_tree(store.restore(path), state)          # an absolute path too

    store.save("infer", state, include_opt=False)
    assert "opt_state" not in store.restore("infer")
    assert store.list() == ["infer", "model-epoch_1"]
    with pytest.raises(FileExistsError):
        store.save("infer", state, overwrite=False)
    state2 = _state(1)
    store.save("infer", state2, include_opt=False)    # overwrite
    _same_tree(store.restore("infer")["params"], state2["params"])
    # (tmp_path / name) without a state file is not a checkpoint
    (tmp_path / "ckpt" / "empty").mkdir()
    assert "empty" not in store.list()


def test_latest_checkpoint_is_by_mtime_not_name(tmp_path):
    store = tck.CheckpointStore(str(tmp_path / "s"))
    assert store.latest() is None
    store.save("model-epoch_9_step_9", {"step": 9})
    time.sleep(0.05)
    store.save("model-epoch_10_step_10", {"step": 10})
    assert store.latest() == "model-epoch_10_step_10"


@pytest.mark.parametrize("include,exclude", [
    (None, None), (None, ("head/conv_6",)), (("backbone",), None),
    (("head",), ("head/conv_7",)), (("conv_6",), None)])
def test_scope_filter_matches_jax(include, exclude):
    tree = _state()["params"]
    got = tck.scope_filter(tree, include, exclude)
    np_tree = jax.tree_util.tree_map(lambda t: t.numpy(), tree)
    want = jck.scope_filter(np_tree, include, exclude)
    assert got == want


def test_partial_restore_and_strip_optimizer(tmp_path):
    current, restored = _state(0), _state(1)
    merged = tck.partial_restore(current["params"], restored["params"],
                                 exclude=("head/conv_6",))
    assert merged["head"]["conv_6"]["w"] is current["params"]["head"][
        "conv_6"]["w"]
    assert torch.equal(merged["backbone"]["conv_0"]["w"],
                       restored["params"]["backbone"]["conv_0"]["w"])
    assert torch.equal(merged["head"]["conv_7"]["w"],
                       restored["params"]["head"]["conv_7"]["w"])
    np_cur = jax.tree_util.tree_map(lambda t: t.numpy(), current["params"])
    np_res = jax.tree_util.tree_map(lambda t: t.numpy(), restored["params"])
    want = jck.partial_restore(np_cur, np_res, include=("head",),
                               exclude=("head/conv_7",))
    got = tck.partial_restore(current["params"], restored["params"],
                              include=("head",), exclude=("head/conv_7",))
    for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]:
        node = got
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node.numpy(), leaf)
    stripped = tck.strip_optimizer(current)
    assert "opt_state" not in stripped and "opt_state" in current
    assert stripped["params"] is current["params"]
