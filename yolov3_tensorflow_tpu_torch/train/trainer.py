"""The training loop: train and eval steps + orchestration (counterpart of
`yolov3_tensorflow_tpu/train/trainer.py`), in eager PyTorch.

One train step is the live-BN forward, the loss + L2, the backward (only
the unfrozen parameters take gradients), the per-leaf clip, the optimizer
and the new BN statistics. Its metrics stay on the device: they leave it as
one stacked tensor every `train.log_step` steps, where the NaN abort is
checked, so the step loop never waits on the device in between. The eval
step (in-train evaluation and validation) is the live-BN eval forward, the
loss, the decode and `ops.nms.batched_nms_auto`, which runs the per-group
NMS kernel (K2, `csrc/nms.cu`) on a CUDA device.

Multi-scale training needs no bucketing here: eager PyTorch runs every size.
Data-parallel training (`train.num_data_parallel > 1`) is not ported yet
(ROADMAP queue 1, item 11).
"""

from __future__ import annotations

import logging
import os
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from yolov3_tensorflow_tpu_torch.config import Config
from yolov3_tensorflow_tpu_torch.data.loader import (DataLoader,
                                                     refuse_device_data_path)
from yolov3_tensorflow_tpu_torch.evaluation.metrics import (
    AverageMeter, detections_to_pred_rows, evaluate_batch)
from yolov3_tensorflow_tpu_torch.evaluation.voc import (evaluate_map,
                                                        parse_gt_records)
from yolov3_tensorflow_tpu_torch.models.decode import predict_boxes
from yolov3_tensorflow_tpu_torch.models.yolov3 import (init_yolov3,
                                                       yolov3_forward)
from yolov3_tensorflow_tpu_torch.ops.losses import (LOSS_TERMS, compute_loss,
                                                    l2_regularization)
from yolov3_tensorflow_tpu_torch.ops.nms import batched_nms_auto
from yolov3_tensorflow_tpu_torch.train.checkpoint import (CheckpointStore,
                                                          partial_restore)
from yolov3_tensorflow_tpu_torch.train.optimizers import (Optimizer,
                                                          apply_updates,
                                                          build_optimizer,
                                                          flatten,
                                                          path_prefix_mask,
                                                          unflatten)
from yolov3_tensorflow_tpu_torch.train.schedules import build_schedule
from yolov3_tensorflow_tpu_torch.utils.profiling import StepTimer
from yolov3_tensorflow_tpu_torch.utils.summary import SummaryWriter

TrainState = Dict[str, Any]  # {"params", "batch_stats", "opt_state", "step"}


def compute_dtype_of(cfg: Config) -> torch.dtype:
    """model.compute_dtype ("bfloat16", "float32") as a torch dtype."""
    return getattr(torch, cfg.model.compute_dtype)


def make_train_step(cfg: Config, optimizer: Optimizer,
                    schedule: Optional[Callable[[int], float]] = None
                    ) -> Callable:
    """The train step: (state, images [N, H, W, 3], y_true (3 grids)) ->
    (new state, metrics). The metrics are 0-dim device tensors ("total",
    "xy", "wh", "conf", "class", "l2") and, with a schedule, "lr" =
    schedule(new step), a Python float. The input state is not modified."""
    anchors = np.asarray(cfg.anchors, np.float32)
    m = cfg.model
    compute_dtype = compute_dtype_of(cfg)

    def train_step(state: TrainState, images: torch.Tensor,
                   y_true: Tuple[torch.Tensor, ...]):
        img_size = (images.shape[1], images.shape[2])  # (h, w)
        flat = flatten(state["params"])
        live = {p: flat[p].detach().requires_grad_(True)
                for p in optimizer.trainable(state["params"])}
        with torch.enable_grad():
            params = unflatten({**flat, **live})
            fmaps, new_stats = yolov3_forward(
                {"params": params, "batch_stats": state["batch_stats"]},
                images, train=True, compute_dtype=compute_dtype,
                bn_momentum=m.batch_norm_decay, bn_eps=m.batch_norm_epsilon)
            losses = compute_loss(
                fmaps, y_true, anchors, m.num_classes, img_size,
                use_label_smooth=m.use_label_smooth,
                use_focal_loss=m.use_focal_loss,
                max_gt=cfg.data.max_boxes_per_image, box_loss=m.box_loss)
            l2 = l2_regularization(params, m.weight_decay)
            grads = (torch.autograd.grad(losses["total"] + l2,
                                         list(live.values()))
                     if live else ())
        updates, new_opt = optimizer.update(dict(zip(live, grads)),
                                            state["opt_state"])
        new_state = {"params": apply_updates(state["params"], updates),
                     "batch_stats": new_stats, "opt_state": new_opt,
                     "step": state["step"] + 1}
        metrics: Dict[str, Any] = {k: v.detach() for k, v in losses.items()}
        metrics["l2"] = l2.detach()
        if schedule is not None:
            metrics["lr"] = schedule(new_state["step"])
        return new_state, metrics

    return train_step


def make_eval_step(cfg: Config) -> Callable:
    """The eval step: (state, images, y_true) -> (losses, detections) with
    the live-BN eval forward (moving statistics), the loss, the decode and
    the per-class NMS at `cfg.eval` (K2 on a CUDA device)."""
    anchors = np.asarray(cfg.anchors, np.float32)
    m, e = cfg.model, cfg.eval
    compute_dtype = compute_dtype_of(cfg)

    @torch.no_grad()
    def eval_step(state: TrainState, images: torch.Tensor,
                  y_true: Tuple[torch.Tensor, ...]):
        img_size = (images.shape[1], images.shape[2])
        variables = {"params": state["params"],
                     "batch_stats": state["batch_stats"]}
        fmaps, _ = yolov3_forward(variables, images, train=False,
                                  compute_dtype=compute_dtype,
                                  bn_eps=m.batch_norm_epsilon)
        losses = compute_loss(fmaps, y_true, anchors, m.num_classes, img_size,
                              use_label_smooth=m.use_label_smooth,
                              use_focal_loss=m.use_focal_loss,
                              max_gt=cfg.data.max_boxes_per_image,
                              box_loss=m.box_loss)
        boxes, confs, probs = predict_boxes(fmaps, anchors, m.num_classes,
                                            img_size)
        dets = batched_nms_auto(boxes, confs * probs, max_out=e.nms_topk,
                                pre_topk=e.pre_nms_topk,
                                score_thresh=e.score_threshold,
                                iou_thresh=e.nms_threshold)
        return losses, dets

    return eval_step


def _numpy(tree: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.cpu().numpy() for k, v in tree.items()}


class Trainer:
    """End-to-end training: epochs, in-train evaluation, validation mAP,
    the loss-gated periodic checkpoint, the best-mAP checkpoint and
    auto-resume, on `device` (default: the first CUDA device)."""

    def __init__(self, cfg: Config, seed: int = 0,
                 device: Optional[torch.device] = None):
        device = torch.device("cuda") if device is None else device
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Trainer: no CUDA device is available (pass "
                               "device=torch.device('cpu') to train on the "
                               "CPU)")
        if cfg.train.num_data_parallel > 1:
            raise NotImplementedError(
                f"train.num_data_parallel={cfg.train.num_data_parallel}: "
                f"data-parallel training is not ported yet (ROADMAP queue "
                f"1, item 11); train on one device")
        refuse_device_data_path(cfg.data.device_augment,
                                cfg.data.device_encode)
        self.cfg = cfg
        self.seed = seed
        self.device = device
        # an unregistered logger: each trainer's progress file is its own
        self.log = logging.Logger("yolov3_tensorflow_tpu_torch.train")
        if cfg.train.progress_log_path:
            os.makedirs(os.path.dirname(cfg.train.progress_log_path) or ".",
                        exist_ok=True)
            handler = logging.FileHandler(cfg.train.progress_log_path, "w")
            handler.setFormatter(logging.Formatter(
                "%(asctime)s %(levelname)s %(message)s"))
            self.log.addHandler(handler)
        self.log.setLevel(logging.INFO)

        self.schedule = build_schedule(cfg)
        self.store = CheckpointStore(cfg.train.save_dir)
        self.writer = SummaryWriter(cfg.train.log_dir)
        self.best_map = -np.inf
        self._train_step = None  # built after params exist (freeze mask)

    def close(self) -> None:
        """Close the progress log and the summary writer."""
        for handler in list(self.log.handlers):
            handler.close()
            self.log.removeHandler(handler)
        self.writer.close()

    # ---------------- state management ----------------

    def init_state(self) -> TrainState:
        variables = init_yolov3(torch.Generator().manual_seed(self.seed),
                                self.cfg.model.num_classes,
                                device=self.device)
        t = self.cfg.train
        self.optimizer = build_optimizer(
            t.optimizer, self.schedule, momentum=t.momentum,
            rmsprop_decay=t.rmsprop_decay, grad_clip_norm=t.grad_clip_norm,
            update_mask=path_prefix_mask(variables["params"], t.update_part))
        self._train_step = make_train_step(self.cfg, self.optimizer,
                                           schedule=self.schedule)
        self._eval_step = make_eval_step(self.cfg)
        return {"params": variables["params"],
                "batch_stats": variables["batch_stats"],
                "opt_state": self.optimizer.init(variables["params"]),
                "step": int(t.global_step)}

    def _put(self, array: np.ndarray) -> torch.Tensor:
        """Host batch -> device: pinned, copied without blocking the host."""
        t = torch.from_numpy(array)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _put_batch(self, batch) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
        return self._put(batch.images), tuple(self._put(y)
                                              for y in batch.y_true)

    def restore_into(self, state: TrainState, path: str) -> TrainState:
        """Partial restore honoring train.restore_include/exclude."""
        restored = self.store.restore(path, device=self.device)
        t = self.cfg.train
        state = dict(state)
        state["params"] = partial_restore(
            state["params"], restored["params"],
            include=t.restore_include, exclude=t.restore_exclude)
        if "batch_stats" in restored:
            state["batch_stats"] = partial_restore(
                state["batch_stats"], restored["batch_stats"],
                include=t.restore_include, exclude=t.restore_exclude)
        if "opt_state" in restored and t.restore_include is None \
                and t.restore_exclude is None:
            state["opt_state"] = restored["opt_state"]
        if "step" in restored and t.global_step == 0:
            state["step"] = int(restored["step"])
        return state

    # ---------------- loops ----------------

    def train_epoch(self, state: TrainState, loader: DataLoader,
                    epoch: int) -> TrainState:
        """One epoch. Steps queue on the device back to back; their metric
        scalars stay there until a flush stacks them into one tensor and
        copies it to the host, every `train.log_step` steps and before an
        in-train evaluation."""
        cfg = self.cfg
        meters = {k: AverageMeter() for k in LOSS_TERMS}
        timer = StepTimer()
        step = int(state["step"])
        flush_every = max(1, cfg.train.log_step)
        pending: list = []  # [(step, batch_n, metrics)]
        last_lr = 0.0
        t_prev = time.perf_counter()

        def flush():
            nonlocal pending, last_lr, t_prev
            if not pending:
                return
            keys = sorted(k for k in pending[0][2] if k != "lr")
            packed = torch.stack([torch.stack([m[k] for _, _, m in pending])
                                  for k in keys])
            host = packed.cpu().numpy()     # one copy, one wait per flush
            now = time.perf_counter()
            per_step = (now - t_prev) / len(pending)
            t_prev = now
            cols = {k: host[i] for i, k in enumerate(keys)}
            for j, (s, n, m) in enumerate(pending):
                timer.record(per_step)
                for k in meters:
                    meters[k].update(float(cols[k][j]), n)
                for k in meters:
                    self.writer.scalar(f"train_batch_statistics/loss_{k}",
                                       float(cols[k][j]), s)
                self.writer.scalar("train_batch_statistics/loss_l2",
                                   float(cols["l2"][j]), s)
                if "lr" in m:
                    self.writer.scalar("learning_rate", m["lr"], s)
                    last_lr = m["lr"]
            pending = []
            if np.isnan(meters["total"].average):
                raise ArithmeticError(
                    "Gradient exploded! Please train again and you may "
                    "need modify some parameters.")

        for batch in loader.epoch(epoch):
            images, y_true = self._put_batch(batch)
            state, metrics = self._train_step(state, images, y_true)
            step += 1
            pending.append((step, batch.images.shape[0], metrics))
            eval_now = (cfg.train.train_evaluation_step and step > 0
                        and step % cfg.train.train_evaluation_step == 0)
            if len(pending) >= flush_every or eval_now:
                flush()
            if eval_now:
                _, dets = self._eval_step(state, images, y_true)
                recall, precision = evaluate_batch(
                    _numpy(dets), batch.y_true, cfg.model.num_classes,
                    cfg.eval.eval_threshold)
                info = (f"Epoch: {epoch}, global_step: {step} | "
                        f"loss: total: {meters['total'].average:.2f}, "
                        f"xy: {meters['xy'].average:.2f}, "
                        f"wh: {meters['wh'].average:.2f}, "
                        f"conf: {meters['conf'].average:.2f}, "
                        f"class: {meters['class'].average:.2f} | "
                        f"Last batch: rec: {recall:.3f}, "
                        f"prec: {precision:.3f} | lr: {last_lr:.5g}")
                print(info)
                self.log.info(info)
                self.writer.scalar("evaluation/train_batch_recall", recall,
                                   step)
                self.writer.scalar("evaluation/train_batch_precision",
                                   precision, step)
                t_prev = time.perf_counter()  # exclude eval from step timing
        flush()
        self._last_epoch_loss = meters["total"].average
        self._last_lr = last_lr or self.schedule(step)
        stats = timer.summary()
        if stats.get("count"):
            info = (f"Epoch {epoch} step time: p50 {stats['p50_ms']:.1f} ms, "
                    f"p95 {stats['p95_ms']:.1f} ms, "
                    f"mean {stats['mean_ms']:.1f} ms over {stats['count']} "
                    f"steps")
            self.log.info(info)
            self.writer.scalar("train_batch_statistics/step_time_ms",
                               stats["p50_ms"], step)
        self._last_step_stats = stats
        return state

    def validate(self, state: TrainState, val_loader: DataLoader,
                 epoch: int) -> Dict[str, Any]:
        """Full-dataset VOC mAP evaluation; one copy to the host per
        batch."""
        cfg = self.cfg
        val_meters = {k: AverageMeter() for k in LOSS_TERMS}
        rows = []
        for batch in val_loader.epoch(0):
            losses, dets = self._eval_step(state, *self._put_batch(batch))
            losses_np = _numpy(losses)
            rows.extend(detections_to_pred_rows(_numpy(dets),
                                                batch.image_ids))
            for k in val_meters:
                val_meters[k].update(float(losses_np[k]),
                                     batch.images.shape[0])

        gt = parse_gt_records(cfg.data.val_file,
                              cfg.data.img_size, cfg.data.letterbox_resize)
        result = evaluate_map(gt, rows, cfg.model.num_classes,
                              cfg.eval.eval_threshold,
                              cfg.eval.use_voc_07_metric)
        step = int(state["step"])
        info = [f"======> Epoch: {epoch}, global_step: {step} <======"]
        for c, r in result["per_class"].items():
            info.append(f"EVAL: Class {c}: Recall: {r['recall']:.4f}, "
                        f"Precision: {r['precision']:.4f}, AP: {r['ap']:.4f}")
        info.append(f"EVAL: Recall: {result['recall']:.4f}, "
                    f"Precison: {result['precision']:.4f}, "
                    f"mAP: {result['mAP']:.4f}")
        info.append(
            "EVAL: loss: total: {:.2f}, xy: {:.2f}, wh: {:.2f}, "
            "conf: {:.2f}, class: {:.2f}".format(
                *[val_meters[k].average for k in LOSS_TERMS]))
        text = "\n".join(info)
        print(text)
        self.log.info(text)
        self.writer.scalar("evaluation/val_mAP", result["mAP"], epoch)
        self.writer.scalar("evaluation/val_recall", result["recall"], epoch)
        self.writer.scalar("evaluation/val_precision", result["precision"],
                           epoch)
        for k in val_meters:
            self.writer.scalar(f"validation_statistics/loss_{k}",
                               val_meters[k].average, epoch)
        result["val_loss"] = val_meters["total"].average
        return result

    def fit(self, state: Optional[TrainState] = None) -> TrainState:
        """The full schedule: epochs, periodic checkpoints, best-mAP
        checkpoints. With train.auto_resume, a fresh state is replaced by
        the newest checkpoint in save_dir (params-only checkpoints restore
        what they have), and the epoch loop starts at the epoch of the
        restored step."""
        cfg = self.cfg
        if state is None:
            state = self.init_state()
            latest = self.store.latest() if cfg.train.auto_resume else None
            if latest is not None:
                raw = self.store.restore(latest, device=self.device)
                state = dict(state)
                state.update({k: raw[k] for k in state if k in raw})
                state["step"] = int(state["step"])
                self.log.info("auto-resumed from checkpoint %s (step %d)",
                              latest, state["step"])
                print(f"auto-resumed from {latest} at step {state['step']}")
            elif cfg.train.restore_path:
                state = self.restore_into(state, cfg.train.restore_path)

        train_loader = DataLoader(
            cfg.data.train_file, cfg.model.num_classes, cfg.anchors,
            cfg.train.batch_size, cfg.data.img_size, mode="train",
            letterbox=cfg.data.letterbox_resize,
            multi_scale=cfg.data.multi_scale_train,
            multi_scale_interval=cfg.data.multi_scale_interval,
            multi_scale_sizes=cfg.data.multi_scale_sizes,
            use_mix_up=cfg.data.use_mix_up,
            use_color_distort=cfg.data.use_color_distort,
            num_threads=cfg.data.num_threads,
            prefetch=cfg.data.prefetch_buffer, seed=self.seed)
        val_loader = DataLoader(
            cfg.data.val_file, cfg.model.num_classes, cfg.anchors,
            cfg.eval.batch_size, cfg.data.img_size, mode="val",
            letterbox=cfg.data.letterbox_resize,
            num_threads=cfg.data.num_threads,
            prefetch=cfg.data.prefetch_buffer, seed=self.seed)

        # after a resume, start from the epoch the restored step belongs to
        steps_per_epoch = max(1, len(train_loader))
        start_epoch = min(int(state["step"]) // steps_per_epoch,
                          cfg.train.total_epochs)
        if start_epoch:
            self.log.info("resuming epoch loop at epoch %d (step %d)",
                          start_epoch, int(state["step"]))

        for epoch in range(start_epoch, cfg.train.total_epochs):
            state = self.train_epoch(state, train_loader, epoch)
            step = int(state["step"])

            # periodic save, gated on the epoch's mean loss
            if (cfg.train.save_epoch and epoch % cfg.train.save_epoch == 0
                    and epoch > 0 and self._last_epoch_loss <= 2.0):
                name = (f"model-epoch_{epoch}_step_{step}"
                        f"_loss_{self._last_epoch_loss:.4f}"
                        f"_lr_{self._last_lr:.5g}")
                self.store.save(name, state,
                                include_opt=cfg.train.save_optimizer)

            # full validation + best checkpoint
            if (cfg.train.val_evaluation_epoch
                    and epoch % cfg.train.val_evaluation_epoch == 0
                    and epoch >= cfg.train.warm_up_epoch
                    and val_loader.num_examples() > 0):
                result = self.validate(state, val_loader, epoch)
                if result["mAP"] > self.best_map:
                    self.best_map = result["mAP"]
                    name = (f"best_model_Epoch_{epoch}_step_{step}"
                            f"_mAP_{self.best_map:.4f}"
                            f"_loss_{result['val_loss']:.4f}"
                            f"_lr_{self._last_lr:.7g}")
                    self.store.save(name, state,
                                    include_opt=cfg.train.save_optimizer)
        self.writer.flush()
        return state
