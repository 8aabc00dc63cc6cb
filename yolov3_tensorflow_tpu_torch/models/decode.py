"""Anchor-box decoding of raw feature maps.

Counterpart of `yolov3_tensorflow_tpu/models/decode.py`, same conventions:
anchors are (w, h) in input pixels, decoded centers and sizes are in input
pixels, and `predict_boxes` returns corner boxes (x_min, y_min, x_max,
y_max). Everything is fp32; feature maps are NHWC, as the JAX package's.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _constant(values: tuple, device: torch.device) -> torch.Tensor:
    """A small float32 constant on `device`, copied there once per
    (values, device): a blocking host-to-device copy made on every call
    would wait for all the work queued on the device (the train step made
    12 of them). Made outside inference mode, so that a constant first
    made by a serving call can enter a training step's autograd graph."""
    with torch.inference_mode(False):
        return torch.tensor(values, dtype=torch.float32, device=device)


def device_anchors(anchors: np.ndarray, device: torch.device) -> torch.Tensor:
    """anchors [..., 2] (w, h) as a float32 tensor on `device` (cached)."""
    return _constant(tuple(map(tuple, np.asarray(anchors, np.float32)
                               .reshape(-1, 2).tolist())), device)


def grid_ratio(img_size: Tuple[int, int], hg: int, wg: int,
               device: torch.device) -> torch.Tensor:
    """(img_w / wg, img_h / hg), input pixels per grid cell, on `device`."""
    img_h, img_w = img_size
    return _constant((float(img_w) / wg, float(img_h) / hg), device)


def decode_feature_map(feature_map: torch.Tensor, anchors: np.ndarray,
                       num_classes: int, img_size: Tuple[int, int]
                       ) -> Tuple[torch.Tensor, ...]:
    """Decode one scale's raw feature map into absolute boxes + logits.

    feature_map: [N, Hg, Wg, 3*(5+C)] raw conv output; anchors: [3, 2]
    (w, h) in input pixels for this scale; img_size: (height, width) of the
    network input.

    Returns (xy_offset [Hg, Wg, 1, 2], boxes [N, Hg, Wg, 3, 4] as (cx, cy,
    w, h) in input pixels, conf_logits [N, Hg, Wg, 3, 1], prob_logits
    [N, Hg, Wg, 3, C]).
    """
    n, hg, wg = feature_map.shape[:3]
    dev = feature_map.device
    ratio = grid_ratio(img_size, hg, wg, dev)
    fmap = feature_map.float().reshape(n, hg, wg, 3, 5 + num_classes)
    box_xy = fmap[..., 0:2]
    box_wh = fmap[..., 2:4]
    conf_logits = fmap[..., 4:5]
    prob_logits = fmap[..., 5:]

    y_off, x_off = torch.meshgrid(
        torch.arange(hg, dtype=torch.float32, device=dev),
        torch.arange(wg, dtype=torch.float32, device=dev), indexing="ij")
    xy_offset = torch.stack([x_off, y_off], dim=-1)[:, :, None, :]

    centers = (torch.sigmoid(box_xy) + xy_offset) * ratio
    # min(t, 60): exp overflows to inf above 88.7; e^60 px is already beyond
    # any box (the JAX package clamps for its backward pass; kept for parity)
    sizes = torch.exp(torch.clamp(box_wh, max=60.0)) * device_anchors(
        anchors, dev)
    boxes = torch.cat([centers, sizes], dim=-1)
    return xy_offset, boxes, conf_logits, prob_logits


def predict_boxes(feature_maps: Sequence[torch.Tensor], anchors: np.ndarray,
                  num_classes: int, img_size: Tuple[int, int]
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Decode all three scales into flat corner boxes + sigmoid scores.

    Anchor groups [6:9] / [3:6] / [0:3] go with strides 32 / 16 / 8; the
    scales are flattened and concatenated to [N, A, ...] with A =
    3*(H/32*W/32 + H/16*W/16 + H/8*W/8) (10647 at 416x416).

    Returns (boxes [N, A, 4] xyxy in input pixels, confs [N, A, 1],
    probs [N, A, C]), confs and probs already sigmoided.
    """
    anchors = np.asarray(anchors, np.float32)
    groups = [anchors[6:9], anchors[3:6], anchors[0:3]]
    boxes_list, confs_list, probs_list = [], [], []
    for fmap, group in zip(feature_maps, groups):
        n = fmap.shape[0]
        _, boxes, conf_logits, prob_logits = decode_feature_map(
            fmap, group, num_classes, img_size)
        boxes_list.append(boxes.reshape(n, -1, 4))
        confs_list.append(torch.sigmoid(conf_logits.reshape(n, -1, 1)))
        probs_list.append(torch.sigmoid(prob_logits.reshape(n, -1,
                                                            num_classes)))
    boxes = torch.cat(boxes_list, dim=1)
    center, size = boxes[..., 0:2], boxes[..., 2:4]
    half = size * 0.5
    return (torch.cat([center - half, center + half], dim=-1),
            torch.cat(confs_list, dim=1), torch.cat(probs_list, dim=1))
