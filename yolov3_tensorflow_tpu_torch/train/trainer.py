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

With `data.device_augment` and `data.device_encode` the step begins with
a prologue on the device: the augmentation of the staged uint8 tiles
(`data/device_augment.py`) and the label grids from the padded ground
truth (`data/device_encode.py`).

Multi-scale training needs no bucketing here: eager PyTorch runs every
size, so the JAX trainer's cache of one compiled step per bucket
(`_train_step_cache`) has no counterpart, and where nothing in a device
batch carries the resolution the step takes it from the loader's
`batch.img_size`.

Data-parallel training (`train.num_data_parallel` ranks, one device each,
joined by `parallel.multihost.initialize_distributed`): every rank loads
its rows of each global batch, the batch norms sync their moments over
the process group, the gradients are averaged by one all-reduce before
the optimizer, and the metrics are averaged at each flush. Rank 0 alone
writes the log, the events and the checkpoints; validation gathers every
rank's prediction rows and loss sums, so all ranks compute the same mAP.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from yolov3_tensorflow_tpu_torch.config import Config
from yolov3_tensorflow_tpu_torch.data.device_augment import augment_batch
from yolov3_tensorflow_tpu_torch.data.device_encode import \
    encode_labels_device
from yolov3_tensorflow_tpu_torch.data.loader import Batch, DataLoader
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
from yolov3_tensorflow_tpu_torch.parallel.mesh import (make_data_mesh,
                                                       replicate)
from yolov3_tensorflow_tpu_torch.parallel.multihost import (
    barrier, gather_meter_sums, gather_prediction_rows, is_primary,
    process_count, process_index)
from yolov3_tensorflow_tpu_torch.train.checkpoint import (CheckpointStore,
                                                          partial_restore)
from yolov3_tensorflow_tpu_torch.train.optimizers import (Optimizer,
                                                          apply_updates,
                                                          build_optimizer,
                                                          flatten,
                                                          path_prefix_mask,
                                                          unflatten)
from yolov3_tensorflow_tpu_torch.train.schedules import build_schedule
from yolov3_tensorflow_tpu_torch.utils.profiling import StepTimer, annotate
from yolov3_tensorflow_tpu_torch.utils.summary import (NullSummaryWriter,
                                                       SummaryWriter)

TrainState = Dict[str, Any]  # {"params", "batch_stats", "opt_state", "step"}


def compute_dtype_of(cfg: Config) -> torch.dtype:
    """model.compute_dtype ("bfloat16", "float32") as a torch dtype."""
    return getattr(torch, cfg.model.compute_dtype)


def make_train_step(cfg: Config, optimizer: Optimizer,
                    schedule: Optional[Callable[[int], float]] = None,
                    device_augment: bool = False,
                    device_encode: bool = False, group=None) -> Callable:
    """The train step: (state, images [N, H, W, 3], y_true (3 grids)) ->
    (new state, metrics). The metrics are 0-dim device tensors ("total",
    "xy", "wh", "conf", "class", "l2") and, with a schedule, "lr" =
    schedule(new step), a Python float. The input state is not modified.

    With a process `group` (JAX's `axis_name`) the step is one rank's part
    of a data-parallel step on its own rows: sync batch norm over the
    group, and the gradients of the live leaves, flattened in one fixed
    order into one buffer, summed by one all-reduce and divided by the
    group's size before the optimizer (whose per-leaf clip so sees the
    averaged gradient, as JAX clips after its pmean). The metrics stay
    this rank's (`parallel.data_parallel.make_dp_train_step` averages
    them; the Trainer does at each flush). A group of one gives the
    single-device step's bits.

    device_augment=True changes the images argument to the loader's
    `(staged, staged2, params)` on the device: the augmentation runs first
    (data/device_augment.py). The resolution comes from the y_true grids.

    device_encode=True changes the y_true argument to the loader's padded
    `(gt_boxes, gt_labels, gt_mask)`: the grids are scattered on the device
    (data/device_encode.py). The resolution then comes from the images,
    or, with device_augment on too (nothing in the batch carries it), from
    the step's `out_size` argument (w, h), the batch's `img_size`, which
    that step then requires.

    Spans (`utils.profiling.annotate`): "train_step" holds the whole step,
    and inside it "train_step.encode" (the device label encoding),
    ".forward" (live BN), ".loss" (the loss and the L2 term), ".backward"
    (autograd) and ".update" (the optimizer with its clip, and the new
    params); the augmentation, the leaves' set-up and a group's all-reduce
    are the outer span's alone.
    """
    anchors = np.asarray(cfg.anchors, np.float32)
    m = cfg.model
    compute_dtype = compute_dtype_of(cfg)

    def train_step(state: TrainState, images, y_true,
                   out_size: Optional[Tuple[int, int]] = None):
        with annotate("train_step"):
            return step(state, images, y_true, out_size)

    def step(state: TrainState, images, y_true,
             out_size: Optional[Tuple[int, int]]):
        if device_augment:
            staged, staged2, aug = images
            if device_encode:
                if out_size is None:
                    raise ValueError(
                        "train step: device_augment + device_encode needs "
                        "out_size=(w, h), the batch's img_size (nothing in "
                        "the batch carries it)")
                out_w, out_h = out_size
            else:
                out_h, out_w = (y_true[2].shape[1] * 8,
                                y_true[2].shape[2] * 8)
            images = augment_batch(staged, staged2, aug, (out_w, out_h),
                                   mixup=cfg.data.use_mix_up,
                                   distort=cfg.data.use_color_distort)
        if device_encode:
            with annotate("train_step.encode"):
                y_true = tuple(encode_labels_device(
                    *y_true, (images.shape[2], images.shape[1]),
                    m.num_classes, anchors))
        img_size = (images.shape[1], images.shape[2])  # (h, w)
        flat = flatten(state["params"])
        live = {p: flat[p].detach().requires_grad_(True)
                for p in optimizer.trainable(state["params"])}
        with torch.enable_grad():
            params = unflatten({**flat, **live})
            with annotate("train_step.forward"):
                fmaps, new_stats = yolov3_forward(
                    {"params": params, "batch_stats": state["batch_stats"]},
                    images, train=True, compute_dtype=compute_dtype,
                    bn_momentum=m.batch_norm_decay,
                    bn_eps=m.batch_norm_epsilon, group=group)
            with annotate("train_step.loss"):
                losses = compute_loss(
                    fmaps, y_true, anchors, m.num_classes, img_size,
                    use_label_smooth=m.use_label_smooth,
                    use_focal_loss=m.use_focal_loss,
                    max_gt=cfg.data.max_boxes_per_image, box_loss=m.box_loss)
                l2 = l2_regularization(params, m.weight_decay)
            with annotate("train_step.backward"):
                grads = (torch.autograd.grad(losses["total"] + l2,
                                             list(live.values()))
                         if live else ())
        if group is not None and grads:
            flat_g = torch.cat([g.reshape(-1) for g in grads])
            dist.all_reduce(flat_g, group=group)
            flat_g /= dist.get_world_size(group)
            # back into the gradients themselves: their memory layout (some
            # conv kernels' are channels_last) decides the order in which
            # the clip's norms sum, so views of the buffer would move bits
            for g, part in zip(grads, flat_g.split([g.numel()
                                                    for g in grads])):
                g.copy_(part.view(g.shape))
        with annotate("train_step.update"):
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


def make_eval_forward(cfg: Config) -> Callable:
    """(state, images) -> (feature maps, detections): the live-BN eval
    forward (moving statistics), the decode and the per-class NMS at
    `cfg.eval` (K2 on a CUDA device)."""
    anchors = np.asarray(cfg.anchors, np.float32)
    m, e = cfg.model, cfg.eval
    compute_dtype = compute_dtype_of(cfg)

    @torch.no_grad()
    def forward(state: TrainState, images: torch.Tensor):
        variables = {"params": state["params"],
                     "batch_stats": state["batch_stats"]}
        fmaps, _ = yolov3_forward(variables, images, train=False,
                                  compute_dtype=compute_dtype,
                                  bn_eps=m.batch_norm_epsilon)
        boxes, confs, probs = predict_boxes(fmaps, anchors, m.num_classes,
                                            (images.shape[1], images.shape[2]))
        dets = batched_nms_auto(boxes, confs * probs, max_out=e.nms_topk,
                                pre_topk=e.pre_nms_topk,
                                score_thresh=e.score_threshold,
                                iou_thresh=e.nms_threshold)
        return fmaps, dets

    return forward


def make_eval_step(cfg: Config) -> Callable:
    """The eval step: (state, images, y_true) -> (losses, detections):
    `make_eval_forward` and the loss of its feature maps."""
    anchors = np.asarray(cfg.anchors, np.float32)
    m = cfg.model
    forward = make_eval_forward(cfg)

    @torch.no_grad()
    def eval_step(state: TrainState, images: torch.Tensor,
                  y_true: Tuple[torch.Tensor, ...]):
        fmaps, dets = forward(state, images)
        losses = compute_loss(fmaps, y_true, anchors, m.num_classes,
                              (images.shape[1], images.shape[2]),
                              use_label_smooth=m.use_label_smooth,
                              use_focal_loss=m.use_focal_loss,
                              max_gt=cfg.data.max_boxes_per_image,
                              box_loss=m.box_loss)
        return losses, dets

    return eval_step


def to_device(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> device: on a GPU pinned and copied without blocking
    the host (the caching host allocator keeps the pinned block until its
    copy has run)."""
    t = torch.from_numpy(array)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def to_host(*trees: Dict[str, torch.Tensor]) -> Tuple[Dict[str, np.ndarray],
                                                       ...]:
    """Dicts of device tensors -> dicts of numpy arrays through one copy
    and one wait: every tensor is packed into one float32 buffer, so the
    integer and boolean tensors must hold values float32 keeps exactly (an
    eval step's labels and valid flags, below 2^24)."""
    items = [(i, k, v) for i, tree in enumerate(trees)
             for k, v in tree.items()]
    flat = torch.cat([v.detach().reshape(-1).to(torch.float32)
                      for _, _, v in items]).cpu().numpy()
    out: Tuple[Dict[str, np.ndarray], ...] = tuple({} for _ in trees)
    offset = 0
    for i, k, v in items:
        dtype = torch.empty((), dtype=v.dtype).numpy().dtype
        out[i][k] = flat[offset:offset + v.numel()].reshape(
            tuple(v.shape)).astype(dtype)
        offset += v.numel()
    return out


def copied_arrays(batch: Batch) -> Dict[str, np.ndarray]:
    """The host arrays of a loader batch that `Trainer._train_args` copies
    to the device, by name: "images" or, in device-augment mode, "staged",
    "staged2" (absent when it is staged itself, as without mixup) and
    "params.<key>"; the "y_true.<i>" grids or, in device-encode mode,
    "gt_boxes", "gt_labels" and "gt_mask"."""
    if batch.images is None:
        arrays = {"staged": batch.staged}
        if batch.staged2 is not batch.staged:
            arrays["staged2"] = batch.staged2
        arrays.update({f"params.{k}": v for k, v in batch.params.items()})
    else:
        arrays = {"images": batch.images}
    if batch.y_true is None:
        arrays.update(gt_boxes=batch.gt_boxes, gt_labels=batch.gt_labels,
                      gt_mask=batch.gt_mask)
    else:
        arrays.update({f"y_true.{i}": y for i, y in enumerate(batch.y_true)})
    return arrays


class Trainer:
    """End-to-end training: epochs, in-train evaluation, validation mAP,
    the loss-gated periodic checkpoint, the best-mAP checkpoint and
    auto-resume, on `device` (default: the first CUDA device).

    With `train.num_data_parallel` > 1 the trainer is one rank of a
    data-parallel run (see the module docstring): the process group must
    be up (`parallel.multihost.initialize_distributed`) with that many
    ranks, and `device` is this rank's."""

    def __init__(self, cfg: Config, seed: int = 0,
                 device: Optional[torch.device] = None):
        device = torch.device("cuda") if device is None else device
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Trainer: no CUDA device is available (pass "
                               "device=torch.device('cpu') to train on the "
                               "CPU)")
        self.mesh = make_data_mesh(cfg.train.num_data_parallel)
        self.is_primary = is_primary()      # only rank 0 writes
        self.cfg = cfg
        self.seed = seed
        self.device = device
        # an unregistered logger: each trainer's progress file is its own
        self.log = logging.Logger("yolov3_tensorflow_tpu_torch.train")
        if cfg.train.progress_log_path and self.is_primary:
            os.makedirs(os.path.dirname(cfg.train.progress_log_path) or ".",
                        exist_ok=True)
            handler = logging.FileHandler(cfg.train.progress_log_path, "w")
            handler.setFormatter(logging.Formatter(
                "%(asctime)s %(levelname)s %(message)s"))
            self.log.addHandler(handler)
        self.log.setLevel(logging.INFO)

        self.schedule = build_schedule(cfg)
        self.store = CheckpointStore(cfg.train.save_dir)
        self.writer = (SummaryWriter(cfg.train.log_dir) if self.is_primary
                       else NullSummaryWriter())
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
        d = self.cfg.data
        self._train_step = make_train_step(
            self.cfg, self.optimizer, schedule=self.schedule,
            device_augment=d.device_augment, device_encode=d.device_encode,
            group=self.mesh)
        self._eval_step = make_eval_step(self.cfg)
        return {"params": variables["params"],
                "batch_stats": variables["batch_stats"],
                "opt_state": self.optimizer.init(variables["params"]),
                "step": int(t.global_step)}

    def _put(self, array: np.ndarray) -> torch.Tensor:
        return to_device(array, self.device)

    def _train_args(self, batch: Batch) -> Tuple[Any, Tuple[torch.Tensor,
                                                             ...]]:
        """A loader batch of either mode as the train or eval step's
        (images, y_true) arguments on the device: in device-augment mode the
        staged tiles and the plan parameters, in device-encode mode the
        padded ground truth. The arrays of `copied_arrays`, each copied
        once by `to_device`."""
        t = {k: self._put(v) for k, v in copied_arrays(batch).items()}
        if batch.images is None:
            images = (t["staged"], t.get("staged2", t["staged"]),
                      {k: t[f"params.{k}"] for k in batch.params})
        else:
            images = t["images"]
        if batch.y_true is None:
            y_true = (t["gt_boxes"], t["gt_labels"], t["gt_mask"])
        else:
            y_true = tuple(t[f"y_true.{i}"] for i in range(len(batch.y_true)))
        return images, y_true

    def _batch_images(self, batch: Batch, images) -> torch.Tensor:
        """The images of a loader batch, given its train-step argument:
        augmented on the device in device-augment mode."""
        if batch.images is not None:
            return images
        d = self.cfg.data
        return augment_batch(*images, tuple(batch.img_size),
                             mixup=d.use_mix_up, distort=d.use_color_distort)

    def _batch_y_true(self, batch: Batch, y_true) -> Tuple[torch.Tensor, ...]:
        """The label grids of a loader batch, given its train-step argument:
        scattered on the device in device-encode mode."""
        if batch.y_true is not None:
            return y_true
        return tuple(encode_labels_device(
            *y_true, tuple(batch.img_size), self.cfg.model.num_classes,
            np.asarray(self.cfg.anchors, np.float32)))

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
            if self.mesh is not None:       # the ranks' mean, as JAX's pmean
                dist.all_reduce(packed, group=self.mesh)
                packed = packed / dist.get_world_size(self.mesh)
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
            images, y_true = self._train_args(batch)
            state, metrics = self._train_step(state, images, y_true,
                                              out_size=batch.img_size)
            step += 1
            pending.append((step, len(batch.image_ids), metrics))
            eval_now = (cfg.train.train_evaluation_step and step > 0
                        and step % cfg.train.train_evaluation_step == 0
                        and process_count() == 1)
            if len(pending) >= flush_every or eval_now:
                flush()
            if eval_now:
                _, dets = self._eval_step(
                    state, self._batch_images(batch, images),
                    self._batch_y_true(batch, y_true))
                recall, precision = evaluate_batch(
                    to_host(dets)[0], batch.y_true, cfg.model.num_classes,
                    cfg.eval.eval_threshold,
                    gt=(None if batch.y_true is not None else
                        (batch.gt_boxes, batch.gt_labels, batch.gt_mask)))
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
        batch. In a multi-process run each rank evaluates its stride of the
        batches, and the prediction rows and loss sums are all-gathered, so
        every rank computes the same mAP (the best-checkpoint decision needs
        no broadcast)."""
        cfg = self.cfg
        val_meters = {k: AverageMeter() for k in LOSS_TERMS}
        rows = []
        for batch in val_loader.epoch(0):
            losses, dets = self._eval_step(state, *self._train_args(batch))
            losses_np, dets_np = to_host(losses, dets)
            rows.extend(detections_to_pred_rows(dets_np, batch.image_ids))
            for k in val_meters:
                val_meters[k].update(float(losses_np[k]),
                                     batch.images.shape[0])
        rows = gather_prediction_rows(rows)
        gather_meter_sums(val_meters)

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
        state = replicate(self.mesh, state)

        # each rank loads its rows of every train batch (batch_size stays
        # the global batch; plan, steps and multi-scale schedule are the
        # same on every rank) and its stride of the val batches
        rank = (process_index(), process_count())
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
            prefetch=cfg.data.prefetch_buffer, seed=self.seed,
            shard_within_batch=rank,
            device_augment=cfg.data.device_augment,
            staged_size=cfg.data.staged_size,
            device_encode=cfg.data.device_encode,
            max_boxes=cfg.data.max_boxes_per_image)
        val_loader = DataLoader(
            cfg.data.val_file, cfg.model.num_classes, cfg.anchors,
            cfg.eval.batch_size, cfg.data.img_size, mode="val",
            letterbox=cfg.data.letterbox_resize,
            num_threads=cfg.data.num_threads,
            prefetch=cfg.data.prefetch_buffer, seed=self.seed,
            shard_batches=rank)

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
                self._save(name, state)

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
                    self._save(name, state)
        self.writer.flush()
        return state

    def _save(self, name: str, state: TrainState) -> None:
        """A checkpoint, written by rank 0 alone; every rank then waits for
        it, so none reads a half-written one on auto-resume (every rank
        reaches each save: the gates are the same on all)."""
        if self.is_primary:
            self.store.save(name, state,
                            include_opt=self.cfg.train.save_optimizer)
        barrier()
