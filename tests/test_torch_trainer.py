"""The port's Trainer and `cli.train` on the CPU (`--device cpu`), against
the JAX package's trainer where both can run the same step.

- One train step (the tiny config of tests/test_trainer.py in fp32, the
  same weights, the same loader batch) against JAX's `make_train_step`:
  the learning rate equal, frozen leaves bit-identical, and the loss terms,
  L2, new BN statistics and the detection convs' updates each within 1e-4
  of its largest magnitude or twice JAX's own noise, whichever is larger;
  every update within twice JAX's noise in norm. JAX's noise is its own
  step on the batch in reverse order, the same step mathematically: see
  tests/test_torch_train_model.py for why the training gradient of 72
  batch norms is reproducible in fp32 only to about 1e-2, and at this batch
  of 3 the loss terms only to about 1e-4.
- Head-only updates, `fit` end to end (best checkpoint, progress log,
  summary), restore and auto-resume, the loss halving over 15 real steps at
  96x96, `cli.train` with `--device cpu`, and the refusals: `--device
  cuda` without a GPU, the multi-host flags and data parallelism, each
  naming its ROADMAP item (the device data path is ported).
"""

import json
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov3_tensorflow_tpu.config import Config as JaxConfig
from yolov3_tensorflow_tpu.train import optimizers as jopt
from yolov3_tensorflow_tpu.train import schedules as jsched
from yolov3_tensorflow_tpu.train import trainer as jtrain
from yolov3_tensorflow_tpu_torch.cli import train as cli_train
from yolov3_tensorflow_tpu_torch.config import Config
from yolov3_tensorflow_tpu_torch.data.loader import DataLoader
from yolov3_tensorflow_tpu_torch.data.synthetic import generate_dataset
from yolov3_tensorflow_tpu_torch.models.convert import from_jax_variables
from yolov3_tensorflow_tpu_torch.ops.losses import LOSS_TERMS
from yolov3_tensorflow_tpu_torch.testing import (CPU_TEST_THREADS,
                                                 numpy_variables)
from yolov3_tensorflow_tpu_torch.train.optimizers import flatten
from yolov3_tensorflow_tpu_torch.train.trainer import Trainer

torch.set_num_threads(CPU_TEST_THREADS)

CPU = torch.device("cpu")


def close(got, want, rtol=1e-4, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"{what}: max err {err:.3g}, scale {scale:.3g}"


def within_noise(got, want, rev, what=""):
    """|got - want| within 1e-4 of want's largest magnitude or within twice
    |rev - want| (JAX against itself), whichever is larger."""
    got, want, rev = (np.asarray(x, np.float64) for x in (got, want, rev))
    noise = float(np.abs(rev - want).max())
    close(got, want, rtol=max(1e-4, 2 * noise
                              / max(float(np.abs(want).max()), 1e-30)),
          what=what)


def fro(a, b) -> float:
    return float(np.linalg.norm(np.ravel(a) - np.ravel(b))
                 / np.linalg.norm(np.ravel(b)))


def tiny(cls, root, **over):
    """tests/test_trainer.py's tiny_cfg for either package's Config."""
    cfg = cls()
    cfg.model.num_classes = 2
    cfg.data.train_file = str(root / "train.txt")
    cfg.data.val_file = str(root / "val.txt")
    cfg.data.img_size = (64, 64)
    cfg.data.multi_scale_train = False
    cfg.data.use_mix_up = True
    cfg.data.num_threads = 2
    cfg.train.batch_size = 3
    cfg.train.total_epochs = 1
    cfg.train.train_evaluation_step = 0
    cfg.train.val_evaluation_epoch = 1
    cfg.train.warm_up_epoch = 0
    cfg.train.use_warm_up = False
    cfg.train.lr_type = "fixed"
    cfg.train.learning_rate_init = 1e-3
    cfg.train.update_part = ("head",)
    cfg.train.restore_exclude = None
    cfg.train.save_dir = str(root / "ckpt")
    cfg.train.log_dir = str(root / "logs")
    cfg.train.progress_log_path = str(root / "progress.log")
    cfg.eval.batch_size = 1
    cfg.eval.pre_nms_topk = 64
    cfg.eval.nms_topk = 8
    for key, value in over.items():
        section, name = key.split("__")
        setattr(getattr(cfg, section), name, value)
    return cfg.finalize()


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_ds")
    rng = np.random.default_rng(0)
    lines = []
    for i in range(4):
        img = rng.integers(0, 255, (100, 120, 3), dtype=np.uint8)
        p = str(root / f"t{i}.jpg")
        cv2.imwrite(p, img)
        lines.append(f"{i} {p} 120 100 {i % 2} 10 10 90 80")
    (root / "train.txt").write_text("\n".join(lines[:3]))
    (root / "val.txt").write_text("\n".join(lines[3:]))
    return root


def test_one_train_step_matches_jax(root):
    over = dict(model__compute_dtype="float32")
    cfg_t, cfg_j = tiny(Config, root, **over), tiny(JaxConfig, root, **over)
    variables = numpy_variables(2, seed=5)
    batch = next(iter(DataLoader(cfg_t.data.train_file, 2, cfg_t.anchors, 3,
                                 (64, 64), use_mix_up=True, num_threads=2,
                                 seed=0).epoch(0)))

    sched = jsched.build_schedule(cfg_j)
    tx = jopt.build_optimizer(
        "momentum", sched, grad_clip_norm=100.0,
        update_mask=jopt.path_prefix_mask(variables["params"], ("head",)))
    step_fn = jax.jit(jtrain.make_train_step(cfg_j, tx, schedule=sched))

    def jax_step(order):
        params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
        state = {"params": params,
                 "batch_stats": jax.tree_util.tree_map(
                     jnp.asarray, variables["batch_stats"]),
                 "opt_state": tx.init(params),
                 "step": jnp.asarray(0, jnp.int32)}
        return jax.device_get(step_fn(
            state, jnp.asarray(batch.images[order]),
            tuple(jnp.asarray(y[order]) for y in batch.y_true)))

    jstate, jmetrics = jax_step(slice(None))
    jrev, jrev_metrics = jax_step(slice(None, None, -1))

    trainer = Trainer(cfg_t, seed=0, device=CPU)
    state = trainer.init_state()
    tv = from_jax_variables(variables, device=CPU)
    state.update(params=tv["params"], batch_stats=tv["batch_stats"],
                 opt_state=trainer.optimizer.init(tv["params"]))
    new, metrics = trainer._train_step(
        state, torch.from_numpy(batch.images),
        tuple(torch.from_numpy(y) for y in batch.y_true))
    trainer.close()

    assert new["step"] == 1 and int(jstate["step"]) == 1
    for k in (*LOSS_TERMS, "l2"):
        within_noise(metrics[k].item(), jmetrics[k], jrev_metrics[k], k)
    assert metrics["lr"] == pytest.approx(float(jmetrics["lr"]), rel=1e-6)
    for scope, tree in jstate["batch_stats"].items():
        for name, s in tree.items():
            for k in ("mean", "var"):
                within_noise(new["batch_stats"][scope][name][k].numpy(),
                             s[k], jrev["batch_stats"][scope][name][k],
                             f"{scope}/{name}/{k}")

    before = flatten(variables["params"])
    want = {p: np.asarray(v) - before[p]
            for p, v in flatten(jstate["params"]).items()}
    noise_of = {p: np.asarray(v) - before[p]
                for p, v in flatten(jrev["params"]).items()}
    got = {}
    for path, t in flatten(new["params"]).items():
        g = t.numpy()
        got[path] = (np.transpose(g, (2, 3, 1, 0)) if g.ndim == 4 else g) \
            - before[path]
    head = [p for p in want if p.startswith("head/")]
    assert len(head) == 20 * 3 + 3 * 2
    for path in want:
        if path.startswith("backbone/"):        # frozen: bit-identical
            assert not got[path].any() and not want[path].any(), path
    for path in ("head/conv_6/w", "head/conv_6/b", "head/conv_14/w",
                 "head/conv_14/b", "head/conv_22/w", "head/conv_22/b"):
        within_noise(got[path], want[path], noise_of[path], path)
    noise = max(fro(noise_of[p], want[p]) for p in head)
    for path in head:
        assert fro(got[path], want[path]) <= 2 * noise + 1e-4, path


def test_train_step_updates_head_only(root):
    trainer = Trainer(tiny(Config, root), seed=0, device=CPU)
    state = trainer.init_state()
    p0 = {k: v.clone() for k, v in flatten(state["params"]).items()}
    images = torch.from_numpy(np.random.default_rng(0).uniform(
        0, 1, (2, 64, 64, 3)).astype(np.float32))
    y_true = []
    for s in (32, 16, 8):
        y = torch.zeros((2, 64 // s, 64 // s, 3, 6 + 2))
        y[..., -1] = 1.0
        y_true.append(y)
    new, metrics = trainer._train_step(state, images, tuple(y_true))
    trainer.close()
    assert np.isfinite(metrics["total"].item()) and new["step"] == 1
    p1 = flatten(new["params"])
    assert torch.equal(p0["backbone/conv_0/w"], p1["backbone/conv_0/w"])
    assert not torch.allclose(p0["head/conv_22/w"], p1["head/conv_22/w"])
    # BN statistics move in frozen scopes too (training forward)
    assert not torch.allclose(
        new["batch_stats"]["backbone"]["conv_0"]["mean"], torch.zeros(32))
    # the frozen backbone holds no optimizer state
    assert not any(p.startswith("backbone/")
                   for p in new["opt_state"]["trace"])
    # the input state is not modified
    assert torch.equal(flatten(state["params"])["head/conv_22/w"],
                       p0["head/conv_22/w"])


def test_fit_end_to_end(root):
    cfg = tiny(Config, root, train__save_dir=str(root / "fit_ckpt"),
               train__train_evaluation_step=1)
    trainer = Trainer(cfg, seed=1, device=CPU)
    state = trainer.fit()
    trainer.close()
    assert state["step"] == 1                 # 3 images / batch 3
    names = trainer.store.list()
    assert any(n.startswith("best_model_Epoch_0_step_1_mAP_") for n in names)
    log = open(cfg.train.progress_log_path).read()
    assert "Epoch: 0, global_step: 1 | loss: total:" in log
    assert "EVAL: Recall:" in log and "step time: p50" in log
    restored = trainer.store.restore(names[0])
    assert {"params", "batch_stats", "opt_state", "step"} <= set(restored)
    tags = {json.loads(line)["tag"] for line in
            open(os.path.join(cfg.train.log_dir, "metrics.jsonl"))}
    assert {"train_batch_statistics/loss_total", "learning_rate",
            "evaluation/val_mAP", "evaluation/train_batch_recall"} <= tags


def test_restore_into(root):
    cfg = tiny(Config, root, train__save_dir=str(root / "restore_ckpt"))
    trainer = Trainer(cfg, seed=2, device=CPU)
    state = trainer.init_state()
    trainer.store.save("unit_restore", state)
    fresh = Trainer(cfg, seed=3, device=CPU)
    other = fresh.init_state()
    assert not torch.equal(other["params"]["head"]["conv_6"]["w"],
                           state["params"]["head"]["conv_6"]["w"])
    merged = fresh.restore_into(other, "unit_restore")
    assert torch.equal(merged["params"]["head"]["conv_6"]["w"],
                       state["params"]["head"]["conv_6"]["w"])
    # excluded scopes keep their fresh values
    fresh.cfg.train.restore_exclude = ("head/conv_6",)
    merged = fresh.restore_into(other, "unit_restore")
    assert merged["params"]["head"]["conv_6"]["w"] is \
        other["params"]["head"]["conv_6"]["w"]
    trainer.close()
    fresh.close()


def test_auto_resume(tmp_path):
    rng = np.random.default_rng(0)
    lines = []
    for i in range(2):
        p = str(tmp_path / f"r{i}.jpg")
        cv2.imwrite(p, rng.integers(0, 255, (80, 80, 3), dtype=np.uint8))
        lines.append(f"{i} {p} 80 80 0 10 10 70 70")
    (tmp_path / "train.txt").write_text("\n".join(lines))
    (tmp_path / "val.txt").write_text("")
    cfg = tiny(Config, tmp_path, data__use_mix_up=False,
               data__num_threads=1, train__batch_size=2,
               train__val_evaluation_epoch=0, train__save_epoch=0,
               train__update_part=None, train__auto_resume=True,
               train__progress_log_path="")
    t1 = Trainer(cfg, seed=0, device=CPU)
    state = t1.fit()
    assert state["step"] == 1
    t1.store.save("model-epoch_0_step_1", state)
    t1.close()

    # a finished run adds no epochs
    t2 = Trainer(cfg, seed=0, device=CPU)
    assert t2.fit()["step"] == 1
    t2.close()

    cfg.train.total_epochs = 2
    t3 = Trainer(cfg, seed=0, device=CPU)
    resumed = t3.fit()
    t3.close()
    assert resumed["step"] == 2
    assert resumed["opt_state"]["count"] == 2      # the optimizer resumed
    fresh = Trainer(cfg, seed=0, device=CPU)
    init = fresh.init_state()
    fresh.close()
    assert not torch.equal(resumed["params"]["head"]["conv_6"]["b"],
                           init["params"]["head"]["conv_6"]["b"])


def test_loss_decreases_over_real_steps(tmp_path):
    """15 optimizer steps (Adam, lr 1e-3) on 4 synthetic 96x96 images cut
    the total loss by more than half: tests/test_trainer.py's learning test
    on the port."""
    data = generate_dataset(str(tmp_path / "ds"), num_images=4, seed=1,
                            img_size=(96, 96), max_shapes=1)
    cfg = Config()
    cfg.data.train_file = data["annotation_file"]
    cfg.data.val_file = data["annotation_file"]
    cfg.data.class_name_path = data["names_file"]
    cfg.data.img_size = (96, 96)
    cfg.train.batch_size = 4
    cfg.train.optimizer = "adam"
    cfg.train.lr_type = "fixed"
    cfg.train.learning_rate_init = 1e-3
    cfg.train.use_warm_up = False
    cfg.train.update_part = None
    cfg.train.progress_log_path = ""
    cfg.train.save_dir = str(tmp_path / "ckpt")
    cfg.train.log_dir = str(tmp_path / "logs")
    cfg.finalize()
    trainer = Trainer(cfg, seed=0, device=CPU)
    state = trainer.init_state()
    loader = DataLoader(cfg.data.train_file, 3, cfg.anchors, 4, (96, 96),
                        mode="train", letterbox=True, use_mix_up=False,
                        use_color_distort=False, num_threads=2, seed=0)
    totals = []
    for step in range(15):
        batch = next(iter(loader.epoch(step)))
        state, metrics = trainer._train_step(
            state, torch.from_numpy(batch.images),
            tuple(torch.from_numpy(y) for y in batch.y_true))
        totals.append(metrics["total"].item())
    trainer.close()
    assert np.isfinite(totals).all()
    first, last = np.mean(totals[:3]), np.mean(totals[-3:])
    assert last < first / 2, f"loss did not learn: {first:.1f} -> {last:.1f}"


def test_cli_train_on_cpu(root, tmp_path, capsys):
    argv = ["--device", "cpu", "--seed", "1",
            f"data.train_file={root / 'train.txt'}",
            f"data.val_file={root / 'val.txt'}",
            "model.num_classes=2", "data.img_size=64,64",
            "data.multi_scale_train=false", "data.num_threads=2",
            "train.batch_size=3", "train.total_epochs=1",
            "train.train_evaluation_step=1", "train.warm_up_epoch=0",
            "train.lr_type=fixed", "train.restore_exclude=none",
            f"train.save_dir={tmp_path / 'ckpt'}",
            f"train.log_dir={tmp_path / 'logs'}",
            f"train.progress_log_path={tmp_path / 'progress.log'}",
            "eval.batch_size=1", "eval.pre_nms_topk=64", "eval.nms_topk=8"]
    assert cli_train.main(argv) == 0
    out = capsys.readouterr().out
    assert "Epoch: 0, global_step: 1 | loss: total:" in out
    assert "mAP:" in out
    assert any(n.startswith("best_model_")
               for n in os.listdir(tmp_path / "ckpt"))


def test_cli_train_refusals(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli_train.main(["--device", "cuda"])
    # a multi-process run needs every rank's id
    with pytest.raises(ValueError, match="--process_id"):
        cli_train.main(["--device", "cpu", "--coordinator_address",
                        "localhost:1234", "--num_processes", "2"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(Config().finalize(count_files=False))


@pytest.mark.parametrize("key,value,item", [
    ("data__device_augment", True, "item 9"),
    ("data__device_encode", True, "item 9"),
    ("train__num_data_parallel", 2, "item 11")])
def test_unported_modes_raise(root, key, value, item):
    """The device data path (item 9) and data parallelism (item 11),
    refused before they were ported, now build a trainer
    (tests/test_torch_trainer_device.py and tests/test_torch_multihost.py
    train with them); data parallelism over more devices than the run
    has processes is refused, naming how to launch them."""
    cfg = tiny(Config, root, **{key: value})
    if item == "item 9":
        Trainer(cfg, device=CPU).close()
        return
    with pytest.raises(ValueError, match="--num_processes 2"):
        Trainer(cfg, device=CPU)
