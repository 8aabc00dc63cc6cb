"""Checkpointing: named checkpoints with scope-prefix partial restore
(counterpart of `yolov3_tensorflow_tpu/train/checkpoint.py`).

A store is a directory with one directory per named checkpoint (names
encode epoch, step, loss and mAP, as the JAX trainer writes them), each
holding `state.pt`: `torch.save` of the {"params", "batch_stats",
"opt_state", "step"} tree with every tensor on the CPU, read back with
`torch.load(weights_only=True)`, which loads tensors, dicts and numbers and
runs no pickled code. (The JAX package's orbax format needs JAX to read; this
format is the port's own.)

- `partial_restore` / `scope_filter`: restore by parameter-path prefix,
  e.g. everything but the class-count-dependent detection convs
- `save(..., include_opt=False)` and `strip_optimizer`: checkpoints without
  optimizer slots
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Dict, Optional, Sequence

import torch

STATE_FILE = "state.pt"


def _to_cpu(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    return tree


class CheckpointStore:
    """Directory of named checkpoints, one directory each."""

    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)

    def path(self, name: str) -> str:
        return os.path.join(self.directory, name)

    def save(self, name: str, state: Dict[str, Any], *,
             include_opt: bool = True, overwrite: bool = True) -> str:
        """Save a {'params', 'batch_stats', 'opt_state', 'step', ...} tree.
        The file is written under a temporary name and renamed, so a
        checkpoint directory never holds a half-written state."""
        tree = dict(state)
        if not include_opt:
            tree.pop("opt_state", None)
        path = self.path(name)
        if os.path.exists(path):
            if not overwrite:
                raise FileExistsError(path)
            shutil.rmtree(path)
        os.makedirs(path)
        tmp = os.path.join(path, STATE_FILE + ".tmp")
        torch.save(_to_cpu(tree), tmp)
        os.replace(tmp, os.path.join(path, STATE_FILE))
        return path

    def restore(self, name_or_path: str,
                device: Optional[torch.device] = None) -> Dict[str, Any]:
        """The saved tree, its tensors on `device` (default: the CPU)."""
        path = (name_or_path if os.path.isabs(name_or_path)
                else self.path(name_or_path))
        return torch.load(os.path.join(path, STATE_FILE),
                          map_location=device or "cpu", weights_only=True)

    def list(self) -> Sequence[str]:
        return sorted(
            d for d in os.listdir(self.directory)
            if os.path.isfile(os.path.join(self.directory, d, STATE_FILE)))

    def latest(self) -> Optional[str]:
        """The most recently written checkpoint (by directory mtime): name
        order would put 'model-epoch_9...' after 'model-epoch_10...'."""
        names = self.list()
        if not names:
            return None
        return max(names, key=lambda n: os.path.getmtime(self.path(n)))


def _selected(key: str, include: Optional[Sequence[str]],
              exclude: Optional[Sequence[str]]) -> bool:
    if include is not None and not any(
            key.startswith(p) or f"/{p}" in key for p in include):
        return False
    if exclude is not None and any(
            key.startswith(p) or f"/{p}" in key for p in exclude):
        return False
    return True


def scope_filter(tree: Any, include: Optional[Sequence[str]],
                 exclude: Optional[Sequence[str]], prefix: str = "") -> Any:
    """Boolean tree selecting leaf paths ('/'-joined keys) by prefix:
    include=None selects everything; exclude wins over include."""
    if isinstance(tree, dict):
        return {k: scope_filter(v, include, exclude, f"{prefix}{k}/")
                for k, v in tree.items()}
    return _selected(prefix[:-1], include, exclude)


def partial_restore(current: Any, restored: Any,
                    include: Optional[Sequence[str]] = None,
                    exclude: Optional[Sequence[str]] = None) -> Any:
    """`current` with the selected leaves taken from `restored` (each
    moved to the device of the leaf it replaces); the others keep their
    current values, e.g. exclude=("head/conv_6", "head/conv_14",
    "head/conv_22") keeps fresh detection convs for a new class count."""
    mask = scope_filter(current, include, exclude)

    def merge(take, cur, res):
        if isinstance(take, dict):
            return {k: merge(take[k], cur[k], res[k]) for k in take}
        if not take:
            return cur
        return res.to(cur.device) if isinstance(cur, torch.Tensor) else res

    return merge(mask, current, restored)


def strip_optimizer(state: Dict[str, Any]) -> Dict[str, Any]:
    """A training checkpoint tree without its optimizer slots."""
    return {k: v for k, v in state.items() if k != "opt_state"}
