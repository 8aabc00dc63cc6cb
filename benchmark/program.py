"""What the benchmark hands the program beside its inputs: the program's
Config for a configuration file."""

from __future__ import annotations

import numpy as np


def program_config(cfg: dict):
    """The program's Config (`yolov3_tensorflow_tpu_torch.config.Config`)
    for a configuration file of the VOC kind: the model's recipe, the
    evaluation thresholds and the anchors."""
    from yolov3_tensorflow_tpu_torch.config import Config
    c = Config()
    m = c.model
    m.num_classes = cfg["num_classes"]
    m.use_label_smooth = cfg["use_label_smooth"]
    m.use_focal_loss = cfg["use_focal_loss"]
    m.batch_norm_decay = cfg["batch_norm_decay"]
    m.weight_decay = cfg["weight_decay"]
    m.compute_dtype = cfg["compute_dtype"]
    c.data.max_boxes_per_image = cfg["max_boxes_per_image"]
    c.eval.score_threshold = cfg["eval"]["score_thresh"]
    c.eval.nms_threshold = cfg["eval"]["iou_thresh"]
    c.eval.nms_topk = cfg["eval"]["max_out"]
    c.eval.pre_nms_topk = cfg["eval"]["pre_topk"]
    c.anchors = np.asarray(cfg["anchors"], np.float32)
    return c
