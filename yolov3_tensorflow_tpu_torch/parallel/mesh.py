"""The data-parallel "mesh" (counterpart of
`yolov3_tensorflow_tpu/parallel/mesh.py`).

The JAX package builds a 1-D device mesh inside one program and places
arrays on it. Here the mesh is the `torch.distributed` process group, with
one device per rank: a rank holds its own rows of a batch and a full
replica of the state. Driving several GPUs from one process is not the
PyTorch idiom (one process per device is), and is not offered; a machine
with one card runs two ranks on it over gloo (`initialize_distributed`).
Without a process group the mesh is None, and every function here is the
identity.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist

from yolov3_tensorflow_tpu_torch.parallel.multihost import (
    collective_device, process_count)

Mesh = Optional[dist.ProcessGroup]


def make_data_mesh(num_devices: Optional[int] = None) -> Mesh:
    """The process group of a data-parallel run over `num_devices` devices
    (default: every rank), or None in a single-process run. One device per
    rank, so `num_devices` must equal the number of ranks."""
    world = process_count()
    if num_devices is not None and num_devices != world:
        raise ValueError(
            f"{num_devices} data-parallel devices requested, but the run has "
            f"{world} process(es) of one device each: launch {num_devices} "
            f"processes (cli.train --num_processes {num_devices} "
            f"--process_id i --coordinator_address ..., or torchrun "
            f"--nproc_per_node {num_devices})")
    return dist.group.WORLD if dist.is_initialized() else None


def _map(fn: Callable, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(mesh: Mesh, tree: Any) -> Any:
    """This rank's rows of a global batch: the r-th of W equal contiguous
    slices of every array's leading dimension (tensors or numpy arrays, in
    nested dicts, tuples and lists)."""
    if mesh is None:
        return tree
    rank, world = dist.get_rank(mesh), dist.get_world_size(mesh)

    def take(x):
        if x.shape[0] % world:
            raise ValueError(f"global batch of {x.shape[0]} rows does not "
                             f"split over {world} ranks")
        n = x.shape[0] // world
        return x[rank * n:(rank + 1) * n]

    return _map(take, tree)


def replicate(mesh: Mesh, tree: Any) -> Any:
    """The tree as rank 0 holds it, on every rank: its tensors broadcast
    from rank 0 (one broadcast per dtype and device), its other leaves
    (steps, counts) with them. Ranks that initialize from the same seed, or
    restore the same checkpoint, already agree; this makes it so by
    construction."""
    if mesh is None:
        return tree
    leaves: List[Any] = []
    _map(leaves.append, tree)
    numbers = [[x for x in leaves if not isinstance(x, torch.Tensor)]]
    dist.broadcast_object_list(numbers, src=0, group=mesh,
                               device=collective_device())
    numbers = iter(numbers[0])
    groups = {}
    for i, x in enumerate(leaves):
        if isinstance(x, torch.Tensor):
            groups.setdefault((x.dtype, x.device), []).append(i)
    out = list(leaves)
    for idx in groups.values():
        flat = torch.cat([leaves[i].detach().reshape(-1) for i in idx])
        dist.broadcast(flat, src=0, group=mesh)
        for i, part in zip(idx, flat.split([leaves[i].numel()
                                            for i in idx])):
            out[i] = part.view(leaves[i].shape)
    for i, x in enumerate(leaves):
        if not isinstance(x, torch.Tensor):
            out[i] = next(numbers)
    it = iter(out)
    return _map(lambda _: next(it), tree)
