"""Multi-process bring-up and the validation gathers (counterpart of
`yolov3_tensorflow_tpu/parallel/multihost.py`).

`initialize_distributed` joins the `torch.distributed` process group of a
multi-process run; the gathers combine what every rank evaluated, so that
each computes the same VOC mAP. Everything here is a no-op in a
single-process run, so one training script runs on one device or many.
"""

from __future__ import annotations

import datetime
import os
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

# a collective that waits longer than this raises: a lost rank ends the run
# instead of hanging every other one
TIMEOUT = datetime.timedelta(minutes=10)


def _init_method(coordinator_address: Optional[str]) -> str:
    """host:port -> tcp://host:port; a URL (file://, tcp://) as it is;
    none -> env:// (torchrun's MASTER_ADDR and MASTER_PORT)."""
    if coordinator_address is None:
        return "env://"
    if "://" in coordinator_address:
        return coordinator_address
    return f"tcp://{coordinator_address}"


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device: Optional[torch.device] = None
                           ) -> torch.device:
    """Join the process group of a multi-process run; returns this rank's
    device (`device` itself, default CUDA, in a single-process run).

    The rendezvous is `coordinator_address` (host:port of rank 0, or a
    file:// URL that every rank can reach) with `num_processes` and
    `process_id`, or torchrun's environment (MASTER_ADDR, MASTER_PORT,
    RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE) for what is not given.
    One process with no coordinator is a no-op, as in the JAX package.

    The backend follows from the device type: NCCL for CUDA with one card
    per rank, gloo on the CPU and where this host has fewer cards than
    ranks (NCCL refuses two ranks on one card). A CUDA device without an
    index becomes cuda:{LOCAL_RANK mod cards}. Collectives time out after
    TIMEOUT."""
    device = torch.device("cuda" if device is None else device)
    env = os.environ
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if coordinator_address is None and num_processes in (None, 1):
        return device
    if num_processes is None or process_id is None:
        raise ValueError("a multi-process run needs --num_processes and "
                         "--process_id (or torchrun's WORLD_SIZE and RANK)")
    if coordinator_address is None and "MASTER_ADDR" not in env:
        raise ValueError("a multi-process run needs --coordinator_address "
                         "(host:port of rank 0, or a file:// URL) or "
                         "torchrun's MASTER_ADDR and MASTER_PORT")
    local_rank = int(env.get("LOCAL_RANK", process_id))
    local_ranks = int(env.get("LOCAL_WORLD_SIZE", num_processes))
    backend = "gloo"
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device}: no CUDA device is "
                               f"available")
        cards = torch.cuda.device_count()
        if device.index is None:
            device = torch.device("cuda", local_rank % cards)
        torch.cuda.set_device(device)
        if cards >= local_ranks:
            backend = "nccl"
    dist.init_process_group(backend,
                            init_method=_init_method(coordinator_address),
                            world_size=num_processes, rank=process_id,
                            timeout=TIMEOUT)
    return device


def process_count() -> int:
    """The number of ranks (1 without a process group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This rank (0 without a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    """Rank 0: the one that writes checkpoints, events and the log."""
    return process_index() == 0


def collective_device() -> torch.device:
    """Where the group's host-side collectives put their tensors: this
    rank's card under NCCL (which takes nothing else), the CPU under
    gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def barrier() -> None:
    """Wait for every rank (nothing without a process group)."""
    if process_count() == 1:
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group, in the forward and in the backward: the
    cotangent of every rank's input is the sum of every rank's output
    cotangent, as the JAX package's psum transposes."""

    @staticmethod
    def forward(ctx, tensor, group):
        ctx.group = group
        out = tensor.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad, ctx.group), None


def all_reduce_sum(tensor: torch.Tensor, group) -> torch.Tensor:
    """A differentiable all-reduce (sum) over `group`: what
    `torch.distributed.nn.functional.all_reduce` computes, which PyTorch
    2.13 deprecates."""
    return _AllReduceSum.apply(tensor, group)


def _all_gather(t: torch.Tensor) -> List[torch.Tensor]:
    out = [torch.empty_like(t) for _ in range(process_count())]
    dist.all_gather(out, t)
    return out


def gather_meter_sums(meters) -> None:
    """Combine AverageMeter sums and counts across ranks in place, with one
    all-gather of a [K, 2] float64 tensor, so that every rank reports the
    dataset's mean losses."""
    if process_count() == 1:
        return
    keys = sorted(meters)
    local = torch.tensor([[meters[k].sum, float(meters[k].count)]
                          for k in keys], dtype=torch.float64,
                         device=collective_device())
    total = torch.stack(_all_gather(local)).sum(dim=0).cpu().numpy()
    for i, k in enumerate(keys):
        m = meters[k]
        m.sum = float(total[i, 0])
        m.count = int(total[i, 1])
        m.average = m.sum / max(m.count, 1)


def gather_prediction_rows(rows: Sequence[Sequence[float]],
                           row_width: int = 7) -> List[List[float]]:
    """All-gather variable-length prediction rows to every rank, in rank
    order.

    rows: this rank's [img_id, x0, y0, x1, y1, score, label] lists
    (evaluation.metrics.detections_to_pred_rows, float32 values). Each rank
    contributes its row count, then a float32 block padded to the largest
    count (JAX's scheme)."""
    if process_count() == 1:
        return [list(r) for r in rows]
    dev = collective_device()
    local = torch.from_numpy(
        np.asarray(rows, np.float32).reshape(-1, row_width)).to(dev)
    counts = [int(c) for c in _all_gather(
        torch.tensor([local.shape[0]], dtype=torch.int64, device=dev))]
    padded = torch.zeros((max(max(counts), 1), row_width),
                         dtype=torch.float32, device=dev)
    padded[:local.shape[0]] = local
    out: List[List[float]] = []
    for block, count in zip(_all_gather(padded), counts):
        out.extend(block[:count].cpu().tolist())
    return out
