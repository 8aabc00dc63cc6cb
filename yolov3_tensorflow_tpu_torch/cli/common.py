"""Shared CLI helpers: anchors, class names, the device, and model loading
(counterpart of `yolov3_tensorflow_tpu/cli/common.py`)."""

from __future__ import annotations

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


def load_variables(restore_path: str, num_classes: int,
                   device: torch.device) -> Dict[str, Any]:
    """Model variables on `device` from a darknet .weights file (chosen by
    its extension). Checkpoint directories raise: the JAX package's orbax
    checkpoints have no counterpart here yet."""
    if not restore_path.endswith(".weights"):
        raise NotImplementedError(
            f"{restore_path!r} is not a .weights file: checkpoint "
            f"directories are not ported yet (ROADMAP queue 1, item 8: "
            f"checkpoints and the trainer)")
    from yolov3_tensorflow_tpu_torch.models.yolov3 import init_yolov3
    from yolov3_tensorflow_tpu_torch.utils.weights import load_darknet_weights
    fresh = init_yolov3(torch.Generator().manual_seed(0), num_classes,
                        device=device)
    return load_darknet_weights(fresh, restore_path, num_classes)


def str2bool(v: str) -> bool:
    return str(v).lower() in ("1", "true", "yes", "on")
