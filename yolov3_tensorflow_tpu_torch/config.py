"""Typed configuration, copied from the JAX package's `config.py`
(importing it would pull in the JAX package; tests hold the copy equal to
its original): the model constants, the anchor and class-name readers, and
the dataclass tree (`DataConfig`, `ModelConfig`, `TrainConfig`,
`EvalConfig`, `Config`) with `section.key=value` overrides and JSON config
files. Derived values (anchors, class names, image counts, epoch-to-step
conversions) are computed by `Config.finalize()`, never at import time.

Every field of the JAX package's tree is here, so that its config files
load; `train.num_data_parallel` counts ranks of one device each
(`parallel.mesh.make_data_mesh`).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

# Canonical COCO YOLOv3 anchors (w, h) at 416x416, from the YOLOv3 paper.
DEFAULT_ANCHORS: Tuple[Tuple[float, float], ...] = (
    (10, 13), (16, 30), (33, 23),
    (30, 61), (62, 45), (59, 119),
    (116, 90), (156, 198), (373, 326),
)


def parse_anchors(anchor_path: str) -> np.ndarray:
    """Parse a comma-separated anchor file into a float32 [N, 2] array."""
    with open(anchor_path) as f:
        vals = [float(v) for v in f.read().replace("\n", " ").split(",")
                if v.strip()]
    return np.asarray(vals, np.float32).reshape(-1, 2)


def read_class_names(class_name_path: str) -> Dict[int, str]:
    """Read a one-class-per-line names file into {id: name}."""
    names: Dict[int, str] = {}
    with open(class_name_path) as f:
        for idx, line in enumerate(f):
            names[idx] = line.strip("\n")
    return names


@dataclass
class DataConfig:
    """Dataset + augmentation settings."""

    train_file: str = "./data/my_data/train.txt"
    val_file: str = "./data/my_data/val.txt"
    anchor_path: str = ""            # empty -> DEFAULT_ANCHORS
    class_name_path: str = ""        # empty -> COCO-80 built-ins
    img_size: Tuple[int, int] = (416, 416)  # (width, height)
    letterbox_resize: bool = True
    # host loader parallelism: worker threads and batches prefetched
    num_threads: int = 10
    prefetch_buffer: int = 5
    # augmentation strategies
    multi_scale_train: bool = True
    multi_scale_interval: int = 10   # re-sample size every N batches
    # override the multi-scale bucket set (square sizes, e.g. "128,160,192");
    # None = the absolute {320..608} grid (sized for a 416 base)
    multi_scale_sizes: Optional[Tuple] = None
    use_mix_up: bool = True
    use_color_distort: bool = True
    # ground-truth boxes per image the loss ignore mask compares against
    max_boxes_per_image: int = 64
    # the device-resident data path: the host decodes and draws, the device
    # makes the pixels (data/device_augment.py; every image is staged into
    # a staged_size^2 uint8 tile, so set it to at least the dataset's
    # largest side) and the label grids from padded ground truth
    # (data/device_encode.py)
    device_augment: bool = False
    staged_size: int = 512
    device_encode: bool = False


@dataclass
class ModelConfig:
    """Network architecture and loss settings."""

    num_classes: int = 80
    use_static_shape: bool = True     # kept for config-file parity
    batch_norm_decay: float = 0.99    # moving-statistics decay
    batch_norm_epsilon: float = 1e-5
    weight_decay: float = 5e-4        # L2 added to the loss
    use_label_smooth: bool = True
    use_focal_loss: bool = True
    # compute dtype of the convs; decode and loss stay float32
    compute_dtype: str = "bfloat16"
    # box regression loss: "reference" (grid-space xy/wh MSE) or "giou"
    # (1 - GIoU on the decoded boxes)
    box_loss: str = "reference"


@dataclass
class TrainConfig:
    """Optimization, checkpoint and logging settings."""

    batch_size: int = 6
    total_epochs: int = 100
    train_evaluation_step: int = 100
    # flush the device-side metrics to the meters and TensorBoard every N
    # steps: one stacked [K, N] tensor leaves the device per flush, so the
    # step loop never waits on the device in between
    log_step: int = 10
    val_evaluation_epoch: int = 2
    save_epoch: int = 10
    global_step: int = 0              # resume offset

    optimizer: str = "momentum"       # sgd | momentum | adam | rmsprop
    momentum: float = 0.9
    rmsprop_decay: float = 0.9
    save_optimizer: bool = True
    learning_rate_init: float = 1e-4
    lr_type: str = "piecewise"        # fixed|exponential|cosine_decay|cosine_decay_restart|piecewise
    lr_decay_epoch: float = 5
    lr_decay_factor: float = 0.96
    lr_lower_bound: float = 1e-6
    pw_boundaries: Tuple[float, ...] = (30, 50)   # epoch-based
    pw_values: Tuple[float, ...] = (1e-4, 3e-5, 1e-5)
    use_warm_up: bool = True
    warm_up_epoch: int = 3
    grad_clip_norm: float = 100.0     # per-variable clip by norm

    # restore / freeze by parameter-path prefix ("head", "head/conv_6")
    restore_path: str = ""
    restore_include: Optional[Tuple[str, ...]] = None
    restore_exclude: Optional[Tuple[str, ...]] = (
        "head/conv_6", "head/conv_14", "head/conv_22",
    )
    update_part: Optional[Tuple[str, ...]] = ("head",)

    save_dir: str = "./checkpoint/"
    log_dir: str = "./data/logs/"
    progress_log_path: str = "./data/progress.log"
    # resume from the latest checkpoint in save_dir if one exists
    auto_resume: bool = False

    # data-parallel replicas: the number of processes of the run, one
    # device each (parallel.mesh.make_data_mesh)
    num_data_parallel: int = 1


@dataclass
class EvalConfig:
    """NMS + mAP settings of the in-train evaluation and validation."""

    nms_threshold: float = 0.45
    score_threshold: float = 0.01
    nms_topk: int = 150               # per-class cap of detections
    # per-class candidate pool entering NMS (a fixed shape), sized so that
    # at score_threshold=0.01 a crowded image keeps every above-threshold
    # candidate of a class
    pre_nms_topk: int = 1024
    eval_threshold: float = 0.5
    use_voc_07_metric: bool = False
    batch_size: int = 8


@dataclass
class Config:
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)

    # ---- derived (filled by finalize()) ----
    anchors: Optional[np.ndarray] = None          # [9, 2] float32
    classes: Optional[Dict[int, str]] = None
    train_img_cnt: int = 0
    val_img_cnt: int = 0
    train_batch_num: int = 0
    pw_boundaries_steps: Tuple[float, ...] = ()
    lr_decay_freq: int = 0

    def finalize(self, count_files: bool = True) -> "Config":
        """Compute the derived values."""
        if self.data.anchor_path:
            self.anchors = parse_anchors(self.data.anchor_path)
        elif self.anchors is None:
            self.anchors = np.asarray(DEFAULT_ANCHORS, np.float32)
        if self.data.class_name_path:
            self.classes = read_class_names(self.data.class_name_path)
            self.model.num_classes = len(self.classes)
        elif self.classes is None:
            from yolov3_tensorflow_tpu_torch.utils.coco import \
                COCO_CLASS_NAMES
            self.classes = dict(enumerate(COCO_CLASS_NAMES[: self.model.num_classes]))
        if count_files and os.path.exists(self.data.train_file):
            with open(self.data.train_file) as f:
                self.train_img_cnt = sum(1 for _ in f)
        if count_files and os.path.exists(self.data.val_file):
            with open(self.data.val_file) as f:
                self.val_img_cnt = sum(1 for _ in f)
        if self.train_img_cnt:
            self.train_batch_num = int(
                math.ceil(self.train_img_cnt / self.train.batch_size))
            self.lr_decay_freq = int(self.train_batch_num * self.train.lr_decay_epoch)
            self.pw_boundaries_steps = tuple(
                float(b) * self.train_batch_num + self.train.global_step
                for b in self.train.pw_boundaries)
        return self


def _coerce(value: str, target: Any) -> Any:
    """Coerce a CLI string into the type of the current config value."""
    if isinstance(target, bool):
        return str(value).lower() in ("1", "true", "yes", "on")
    if isinstance(target, int):
        return int(value)
    if isinstance(target, float):
        return float(value)
    if isinstance(target, (tuple, list)):
        parts = [p for p in str(value).replace("[", "").replace("]", "").split(",") if p]
        elem = target[0] if len(target) else float
        typ = type(elem) if not isinstance(elem, type) else elem
        return tuple(typ(p) for p in parts)
    if target is None:
        if str(value).lower() in ("none", "null", ""):
            return None
        return tuple(p.strip() for p in str(value).split(","))
    return value


def apply_overrides(cfg: Config, overrides: Sequence[str]) -> Config:
    """Apply `section.key=value` overrides, e.g. `train.batch_size=32`."""
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override must be key=value, got {ov!r}")
        key, value = ov.split("=", 1)
        parts = key.split(".")
        obj: Any = cfg
        for p in parts[:-1]:
            obj = getattr(obj, p)
        cur = getattr(obj, parts[-1])
        setattr(obj, parts[-1], _coerce(value, cur))
    return cfg


def load_config(path: Optional[str] = None,
                overrides: Sequence[str] = ()) -> Config:
    """Build a Config from an optional JSON file plus CLI overrides."""
    cfg = Config()
    if path:
        with open(path) as f:
            raw = json.load(f)
        for section, values in raw.items():
            if section.startswith("_"):
                continue  # "_comment" etc.
            obj = getattr(cfg, section)
            if dataclasses.is_dataclass(obj):
                for k, v in values.items():
                    cur = getattr(obj, k)
                    setattr(obj, k, tuple(v) if isinstance(v, list) and isinstance(cur, tuple) else v)
            else:
                setattr(cfg, section, values)
    apply_overrides(cfg, overrides)
    return cfg
