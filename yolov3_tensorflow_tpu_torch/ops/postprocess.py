"""The serving detector and host-side helpers for its output.

Counterpart of `yolov3_tensorflow_tpu/ops/postprocess.py`. `build_detector`
folds BN into the conv kernels once, packs the detection head, moves the
decode tables to the device, and returns an `nn.Module` whose forward runs
the whole chain on the device: BN-folded Darknet-53 + FPN, packed output
convs, objectness prefilter, sparse decode and the CUDA shared-candidate NMS.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from yolov3_tensorflow_tpu_torch.models.yolov3 import fold_batch_norm
from yolov3_tensorflow_tpu_torch.ops.fast_postprocess import (
    decode_tables, pack_serving_head, postprocess_packed,
    yolov3_forward_packed)

# build_detector modes of the JAX package that this package does not have
# yet, with the ROADMAP item that ports each.
_DEFERRED_MODES = {
    "exact": "ROADMAP queue 1, item 5 (exact path and per-class NMS)",
    "prefilter": "ROADMAP queue 1, item 5 (exact path and per-class NMS)",
    "split": "ROADMAP queue 1, item 12 (split head, TPU layout experiment)",
    "stem8": "ROADMAP queue 1, item 10 (int8 serving)",
    "int8": "ROADMAP queue 1, item 10 (int8 serving)",
}


class PackedDetector(nn.Module):
    """images [B, H, W, 3] float in [0, 1] (NHWC, any device) -> detections
    dict of [B, C*max_out, ...] on the detector's device. Runs under
    torch.inference_mode()."""

    def __init__(self, packed: dict, tables: torch.Tensor, num_classes: int,
                 img_size: Tuple[int, int], *, max_out: int, box_topk: int,
                 score_thresh: float, iou_thresh: float,
                 compute_dtype: torch.dtype):
        super().__init__()
        self.packed = packed
        self.register_buffer("tables", tables)
        self.num_classes = num_classes
        self.img_size = (int(img_size[0]), int(img_size[1]))
        self.max_out = max_out
        self.box_topk = box_topk
        self.score_thresh = score_thresh
        self.iou_thresh = iou_thresh
        self.compute_dtype = compute_dtype

    @torch.inference_mode()
    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        if tuple(images.shape[1:3]) != self.img_size:
            raise ValueError(f"detector built for {self.img_size}, got "
                             f"images {tuple(images.shape)}")
        images = images.to(self.tables.device, non_blocking=True)
        outs = yolov3_forward_packed(self.packed, images,
                                     compute_dtype=self.compute_dtype)
        return postprocess_packed(
            outs, None, self.num_classes, self.img_size,
            max_out=self.max_out, box_topk=self.box_topk,
            score_thresh=self.score_thresh, iou_thresh=self.iou_thresh,
            tables=self.tables)


def build_detector(variables, anchors: np.ndarray, num_classes: int,
                   img_size: Tuple[int, int], *, device: torch.device,
                   max_out: int = 200, score_thresh: float = 0.3,
                   iou_thresh: float = 0.45,
                   compute_dtype: torch.dtype = torch.bfloat16,
                   box_topk: int = 256, mode: str = "packed") -> nn.Module:
    """Build the end-to-end serving detector on `device`.

    variables: this package's tree (see models.convert.from_jax_variables
    or models.yolov3.init_yolov3). Default thresholds are the demo
    scripts' (max 200 boxes per class, score 0.3, iou 0.45). Only
    mode="packed" exists in this package: one detection conv per scale
    with 128-wide per-anchor blocks, candidate selection by the
    class-lane-masked objectness, exact top-k, and the shared-candidate
    NMS. Detection rows come out in candidate order when max_out >=
    box_topk. Other modes raise NotImplementedError.
    """
    if mode != "packed":
        where = _DEFERRED_MODES.get(mode)
        if where is None:
            raise ValueError(f"unknown detector mode {mode!r}")
        raise NotImplementedError(f"mode={mode!r} is not ported yet: {where}")
    variables = {part: {scope: {name: {k: v.to(device) for k, v in p.items()}
                                for name, p in tree.items()}
                        for scope, tree in variables[part].items()}
                 for part in ("params", "batch_stats")}
    packed = pack_serving_head(fold_batch_norm(variables, dtype=compute_dtype),
                               num_classes)
    for tree in packed.values():
        for p in tree.values():
            p = p.get("packed", p)
            p["w"] = p["w"].contiguous(memory_format=torch.channels_last)
    tables = decode_tables(img_size, anchors, device=device)
    return PackedDetector(packed, tables, num_classes, img_size,
                          max_out=max_out, box_topk=box_topk,
                          score_thresh=score_thresh, iou_thresh=iou_thresh,
                          compute_dtype=compute_dtype).eval()


def detections_to_numpy(dets: Dict[str, torch.Tensor], batch_index: int = 0
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Strip padding: fixed-shape detector output -> ragged host arrays
    (boxes [N, 4], scores [N], labels [N]) for one image. Packed-mode rows
    come in candidate order; sort by score on the host for a top-N slice."""
    valid = dets["valid"][batch_index].bool().cpu().numpy()
    boxes = dets["boxes"][batch_index].float().cpu().numpy()[valid]
    scores = dets["scores"][batch_index].float().cpu().numpy()[valid]
    labels = dets["labels"][batch_index].cpu().numpy()[valid]
    return boxes, scores, labels


def pack_detections(dets: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Flatten a detection dict into ONE fp32 tensor [B, M, 7] (rows:
    x0 y0 x1 y1 score label valid), so a consumer copies one buffer to the
    host per batch."""
    return torch.cat([
        dets["boxes"].float(),
        dets["scores"][..., None].float(),
        dets["labels"][..., None].float(),
        dets["valid"][..., None].float(),
    ], dim=-1)


def unpack_detections(packed: np.ndarray, batch_index: int = 0
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host-side inverse of pack_detections -> (boxes, scores, labels),
    padding stripped (the detections_to_numpy contract)."""
    if isinstance(packed, torch.Tensor):
        packed = packed.cpu().numpy()
    rows = np.asarray(packed[batch_index], np.float32)
    valid = rows[:, 6] > 0.5
    rows = rows[valid]
    return rows[:, 0:4], rows[:, 4], rows[:, 5].astype(np.int64)
