"""Shared CLI helpers: anchors, class names, the device, and model loading
(counterpart of `yolov3_tensorflow_tpu/cli/common.py`)."""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from yolov3_tensorflow_tpu_torch.config import (DEFAULT_ANCHORS,
                                                parse_anchors,
                                                read_class_names)
from yolov3_tensorflow_tpu_torch.utils.coco import COCO_CLASS_NAMES


def load_anchors(anchor_path: Optional[str]) -> np.ndarray:
    if anchor_path:
        return parse_anchors(anchor_path)
    return np.asarray(DEFAULT_ANCHORS, np.float32)


def load_classes(class_name_path: Optional[str]) -> Dict[int, str]:
    if class_name_path:
        return read_class_names(class_name_path)
    return dict(enumerate(COCO_CLASS_NAMES))


def resolve_device(name: str) -> torch.device:
    """The `--device` argument as a torch.device. Asking for CUDA where
    there is none exits with a message: the CLIs never fall back to the
    CPU on their own."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {name}: no CUDA device is available "
                         f"(pass --device cpu to run on the CPU)")
    return device


def device_name(device: torch.device) -> str:
    """What a measurement names its device by: the card's name
    (torch.cuda.get_device_name), or "cpu"."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def load_variables(restore_path: str, num_classes: int,
                   device: torch.device) -> Dict[str, Any]:
    """Model variables ({"params", "batch_stats"}) on `device`, from a
    darknet .weights file (chosen by its extension) or from a checkpoint
    directory written by this package's `train.checkpoint.CheckpointStore`
    (the trainer's checkpoints, `cli.convert_weights`,
    `cli.strip_checkpoint`). Anything else raises ValueError naming the two
    formats: the JAX package's orbax checkpoints are not read here."""
    from yolov3_tensorflow_tpu_torch.train.checkpoint import (STATE_FILE,
                                                              CheckpointStore)
    if restore_path.endswith(".weights"):
        from yolov3_tensorflow_tpu_torch.models.yolov3 import init_yolov3
        from yolov3_tensorflow_tpu_torch.utils.weights import \
            load_darknet_weights
        fresh = init_yolov3(torch.Generator().manual_seed(0), num_classes,
                            device=device)
        return load_darknet_weights(fresh, restore_path, num_classes)
    path = os.path.abspath(restore_path)
    if not os.path.isfile(os.path.join(path, STATE_FILE)):
        raise ValueError(
            f"{restore_path!r} is neither a darknet .weights file nor a "
            f"checkpoint directory of this package (a directory holding "
            f"{STATE_FILE}, written by train.checkpoint.CheckpointStore; "
            f"orbax checkpoints of the JAX package are not read)")
    tree = CheckpointStore(os.path.dirname(path)).restore(path, device=device)
    return {"params": tree["params"], "batch_stats": tree["batch_stats"]}


def str2bool(v: str) -> bool:
    return str(v).lower() in ("1", "true", "yes", "on")
