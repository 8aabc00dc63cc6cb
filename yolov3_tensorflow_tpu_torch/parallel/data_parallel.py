"""Data-parallel training and evaluation over the process group
(counterpart of `yolov3_tensorflow_tpu/parallel/data_parallel.py`).

Every rank holds a full replica of the state and its own rows of the
global batch (`parallel.mesh.shard_batch`, or a loader built with
`shard_within_batch=(rank, world)`):

- the batch norms take the global batch's moments (sync BN: the ranks'
  fp32 `mean` and `mean_sq` averaged by a differentiable all-reduce,
  `models.layers.batch_norm`);
- the gradients are averaged by one all-reduce before the optimizer, so
  the replicas stay equal;
- the metrics are averaged over the ranks.

The collectives are `torch.distributed` calls on the step's device
tensors: NCCL between cards, gloo where ranks share a card or run on the
CPU. In device-augment and device-encode mode the step's arguments are the
rank's rows of the loader's staged tiles, plan parameters and padded
ground truth, so every rank augments and encodes only its own rows, as
JAX's `aug_spec` shards them.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from yolov3_tensorflow_tpu_torch.config import Config
from yolov3_tensorflow_tpu_torch.parallel.mesh import Mesh
from yolov3_tensorflow_tpu_torch.train.optimizers import Optimizer
from yolov3_tensorflow_tpu_torch.train.trainer import (make_eval_forward,
                                                       make_train_step)


def make_dp_train_step(cfg: Config, optimizer: Optimizer, mesh: Mesh,
                       schedule: Optional[Callable[[int], float]] = None,
                       device_augment: bool = False,
                       device_encode: bool = False) -> Callable:
    """The data-parallel train step: (state, this rank's images, y_true,
    out_size=None) -> (new state, metrics), the arguments as
    `train.trainer.make_train_step` takes them. The new state is the same
    on every rank; the metrics are the ranks' mean, stacked into one
    all-reduce. Without a mesh (a single-process run) this is
    `make_train_step`."""
    step_fn = make_train_step(cfg, optimizer, schedule=schedule,
                              device_augment=device_augment,
                              device_encode=device_encode, group=mesh)
    if mesh is None:
        return step_fn
    world = dist.get_world_size(mesh)

    def dp_step(state, images, y_true, out_size=None):
        new_state, metrics = step_fn(state, images, y_true,
                                     out_size=out_size)
        keys = [k for k in metrics if k != "lr"]
        packed = torch.stack([metrics[k] for k in keys])
        dist.all_reduce(packed, group=mesh)
        metrics.update(zip(keys, (packed / world).unbind()))
        return new_state, metrics

    return dp_step


def make_dp_eval_forward(cfg: Config, mesh: Mesh) -> Callable:
    """The batched inference path of data-parallel evaluation: (state,
    this rank's images) -> this rank's detections, the eval forward, the
    decode and the per-class NMS at `cfg.eval` (K2 on a CUDA device), as
    the trainer's eval step computes them. Each rank handles its rows
    alone: no collective runs (`parallel.serving.make_sharded_detector`
    gathers a whole batch's detections)."""
    del mesh                      # every rank runs the same program
    forward = make_eval_forward(cfg)

    def dp_eval_forward(state, images: torch.Tensor):
        return forward(state, images)[1]

    return dp_eval_forward
