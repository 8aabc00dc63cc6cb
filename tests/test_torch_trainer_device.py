"""The port's trainer on the device-resident data path
(`data.device_augment`, `data.device_encode`), on the CPU, against the JAX
package.

- `cli.train --device cpu` with both modes on, at 64^2 with mixup: it
  trains, evaluates in training (through `evaluate_batch(gt=...)`, since a
  device-encode batch has no host grids), validates and checkpoints, with
  finite losses.
- The step's prologue on a device-mode loader batch (the Trainer's
  `_batch_images` and `_batch_y_true`, the functions the train step runs
  first) against JAX's `augment_batch` and `encode_labels_device` on the
  same batch: pixels within 1/255 and equal on at least 99.5%, grids bit
  for bit, and equal to the host loader's grids for the same seed.
- The train step in device mode gives the same losses as the host-mode
  step on the prologue's own images and grids, and refuses a call without
  the batch's `out_size`.
- `evaluate_batch(gt=...)` equals JAX's on the same detections, and the
  grid route of both packages on the same batch.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov3_tensorflow_tpu.data.device_augment import \
    augment_batch as jax_augment
from yolov3_tensorflow_tpu.data.device_encode import \
    encode_labels_device as jax_encode
from yolov3_tensorflow_tpu.evaluation.metrics import \
    evaluate_batch as jax_evaluate_batch
from yolov3_tensorflow_tpu_torch.cli import train as cli_train
from yolov3_tensorflow_tpu_torch.config import Config
from yolov3_tensorflow_tpu_torch.data.loader import DataLoader
from yolov3_tensorflow_tpu_torch.data.synthetic import generate_dataset
from yolov3_tensorflow_tpu_torch.evaluation.metrics import evaluate_batch
from yolov3_tensorflow_tpu_torch.train.optimizers import build_optimizer
from yolov3_tensorflow_tpu_torch.train.schedules import build_schedule
from yolov3_tensorflow_tpu_torch.train.trainer import (Trainer, copied_arrays,
                                                       make_train_step,
                                                       to_host)
from yolov3_tensorflow_tpu_torch.testing import CPU_TEST_THREADS

torch.set_num_threads(CPU_TEST_THREADS)

CPU = torch.device("cpu")
SIZE = (64, 64)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("dev_train")
    train = generate_dataset(str(root / "train"), num_images=6, seed=1,
                             img_size=(80, 64), max_shapes=3, prefix="t")
    val = generate_dataset(str(root / "val"), num_images=2, seed=2,
                           img_size=(80, 64), max_shapes=3, prefix="v")
    return root, train, val


def config(root, train, val, **data):
    cfg = Config()
    cfg.model.compute_dtype = "float32"
    cfg.data.train_file = train["annotation_file"]
    cfg.data.val_file = val["annotation_file"]
    cfg.data.class_name_path = train["names_file"]
    cfg.data.img_size = SIZE
    cfg.data.multi_scale_train = False
    cfg.data.num_threads = 2
    cfg.data.staged_size = 96
    cfg.data.max_boxes_per_image = 8
    for key, value in data.items():
        setattr(cfg.data, key, value)
    cfg.train.batch_size = 3
    cfg.train.update_part = ("head",)
    cfg.train.lr_type = "fixed"
    cfg.train.use_warm_up = False
    cfg.train.learning_rate_init = 1e-3
    cfg.eval.batch_size = 2
    cfg.eval.pre_nms_topk = 64
    cfg.eval.nms_topk = 8
    cfg.train.save_dir = str(root / "ckpt")
    cfg.train.log_dir = str(root / "logs")
    cfg.train.progress_log_path = str(root / "progress.log")
    return cfg.finalize()


def device_batch(cfg):
    d = cfg.data
    loader = DataLoader(d.train_file, cfg.model.num_classes, cfg.anchors, 3,
                        d.img_size, mode="train", use_mix_up=d.use_mix_up,
                        num_threads=2, seed=0, device_augment=True,
                        staged_size=d.staged_size, device_encode=True,
                        max_boxes=d.max_boxes_per_image)
    return next(iter(loader.epoch(0)))


def test_cli_train_device_modes(data, capsys):
    root, train, val = data
    argv = ["--device", "cpu", "model.compute_dtype=float32",
            f"data.train_file={train['annotation_file']}",
            f"data.val_file={val['annotation_file']}",
            f"data.class_name_path={train['names_file']}",
            "data.img_size=64,64", "data.multi_scale_train=false",
            "data.num_threads=2", "data.device_augment=true",
            "data.device_encode=true", "data.staged_size=96",
            "train.batch_size=3", "train.total_epochs=1",
            "train.train_evaluation_step=1", "train.warm_up_epoch=0",
            "train.lr_type=fixed", "train.restore_exclude=none",
            f"train.save_dir={root / 'cli_ckpt'}",
            f"train.log_dir={root / 'cli_logs'}",
            f"train.progress_log_path={root / 'cli_progress.log'}",
            "eval.batch_size=2", "eval.pre_nms_topk=64", "eval.nms_topk=8"]
    assert cli_train.main(argv) == 0
    out = capsys.readouterr().out
    assert "Epoch: 0, global_step: 1 | loss: total:" in out
    assert "Epoch: 0, global_step: 2 | loss: total:" in out
    assert "mAP:" in out
    assert any(p.name.startswith("best_model_")
               for p in (root / "cli_ckpt").iterdir())
    with open(root / "cli_logs" / "metrics.jsonl") as f:
        totals = [json.loads(line)["value"] for line in f
                  if "train_batch_statistics/loss_total" in line]
    assert len(totals) == 2 and np.isfinite(totals).all()


@pytest.mark.parametrize("mixup", [False, True])
def test_prologue_matches_jax_and_host(data, mixup):
    root, train, val = data
    cfg = config(root, train, val, use_mix_up=mixup, device_augment=True,
                 device_encode=True)
    batch = device_batch(cfg)
    assert batch.images is None and batch.y_true is None
    trainer = Trainer(cfg, device=CPU)
    try:
        images, gt = trainer._train_args(batch)
        got_img = trainer._batch_images(batch, images).numpy()
        got_grids = [g.numpy() for g in trainer._batch_y_true(batch, gt)]
    finally:
        trainer.close()
    # the arrays _train_args copies: staged2 only when it is a tile of its own
    copied = copied_arrays(batch)
    own = batch.staged2 is not batch.staged
    assert ("staged2" in copied) == own and (images[1] is images[0]) != own
    np.testing.assert_array_equal(images[0].numpy(), copied["staged"])
    np.testing.assert_array_equal(gt[0].numpy(), copied["gt_boxes"])
    want_img = np.asarray(jax_augment(
        batch.staged, batch.staged2, batch.params, SIZE, mixup=mixup,
        distort=True))
    diff = np.abs(got_img.astype(np.float64) - want_img) * 255
    assert diff.max() <= 1.0 + 1e-4 and (diff < 1e-3).mean() >= 0.995
    want_grids = jax_encode(jnp.asarray(batch.gt_boxes),
                            jnp.asarray(batch.gt_labels),
                            jnp.asarray(batch.gt_mask), SIZE,
                            cfg.model.num_classes, cfg.anchors)
    host = next(iter(DataLoader(
        cfg.data.train_file, cfg.model.num_classes, cfg.anchors, 3, SIZE,
        mode="train", use_mix_up=mixup, num_threads=2, seed=0,
        device_augment=True, staged_size=96).epoch(0)))
    for g, w, h in zip(got_grids, want_grids, host.y_true):
        np.testing.assert_array_equal(g, np.asarray(w))
        np.testing.assert_array_equal(g, h)
    assert sum(int(g[..., 4].sum()) for g in got_grids) > 0


def test_device_step_equals_host_step_on_its_prologue(data):
    root, train, val = data
    cfg = config(root, train, val, device_augment=True, device_encode=True)
    batch = device_batch(cfg)
    trainer = Trainer(cfg, device=CPU)
    try:
        state = trainer.init_state()
        images, gt = trainer._train_args(batch)
        _, dev_metrics = trainer._train_step(state, images, gt,
                                             out_size=batch.img_size)
        host_step = make_train_step(cfg, trainer.optimizer,
                                    schedule=trainer.schedule)
        _, host_metrics = host_step(state,
                                    trainer._batch_images(batch, images),
                                    trainer._batch_y_true(batch, gt))
    finally:
        trainer.close()
    for k, v in host_metrics.items():
        if k == "lr":
            assert dev_metrics[k] == v
        else:
            assert torch.isfinite(v)
            assert torch.equal(dev_metrics[k], v), k


def test_device_step_needs_out_size(data):
    """With both device modes nothing in the batch carries the resolution:
    the step refuses a call without out_size, before any work."""
    root, train, val = data
    cfg = config(root, train, val, device_augment=True, device_encode=True)
    sched = build_schedule(cfg)
    step = make_train_step(cfg, build_optimizer("momentum", sched),
                           schedule=sched, device_augment=True,
                           device_encode=True)
    batch = device_batch(cfg)
    images = tuple(torch.from_numpy(a) for a in (batch.staged, batch.staged2))
    params = {k: torch.from_numpy(v) for k, v in batch.params.items()}
    gt = tuple(torch.from_numpy(a) for a in
               (batch.gt_boxes, batch.gt_labels, batch.gt_mask))
    with pytest.raises(ValueError, match="out_size"):
        step({}, images + (params,), gt)


def test_evaluate_batch_gt_matches_jax(data):
    root, train, val = data
    cfg = config(root, train, val, device_augment=True, device_encode=True)
    batch = device_batch(cfg)
    rng = np.random.default_rng(3)
    gt = (batch.gt_boxes, batch.gt_labels, batch.gt_mask)
    # detections: the ground truth jittered, relabelled and padded
    b, m = batch.gt_mask.shape
    boxes = batch.gt_boxes[..., :4] + rng.normal(0, 3, (b, m, 4))
    dets = {"boxes": boxes.astype(np.float32),
            "scores": rng.uniform(0, 1, (b, m)).astype(np.float32),
            "labels": np.where(rng.uniform(size=(b, m)) < 0.8,
                               batch.gt_labels, 2).astype(np.int32),
            "valid": batch.gt_mask & (rng.uniform(size=(b, m)) < 0.9)}
    got = evaluate_batch(dets, None, 3, 0.5, gt=gt)
    want = jax_evaluate_batch(dets, None, 3, 0.5, gt=gt)
    assert got == want and got[0] > 0
    # the same ground truth through the grids: the host-encode route
    trainer = Trainer(cfg, device=CPU)
    try:
        grids = [g.numpy() for g in trainer._batch_y_true(
            batch, tuple(torch.from_numpy(a) for a in gt))]
    finally:
        trainer.close()
    assert evaluate_batch(dets, grids, 3, 0.5) == \
        jax_evaluate_batch(dets, grids, 3, 0.5)
    # the port's eval step output goes through the same function
    losses, det_t = (to_host({"a": torch.tensor([1.5, 2.0])},
                             {"v": torch.tensor([True, False]),
                              "l": torch.tensor([3, 7], dtype=torch.int32)}))
    assert losses["a"].dtype == np.float32 and det_t["v"].dtype == bool
    np.testing.assert_array_equal(det_t["l"], np.array([3, 7], np.int32))
