"""The detectors, the exact postprocess, and host-side helpers for their
output.

Counterpart of `yolov3_tensorflow_tpu/ops/postprocess.py`. `build_detector`
folds BN into the conv kernels once, moves the weights and decode tables to
the device, and returns an `nn.Module` whose forward runs the whole chain
on the device: the BN-folded Darknet-53 + FPN, then one of three
postprocesses (see `build_detector`), each ending in a CUDA NMS kernel on
the GPU.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from yolov3_tensorflow_tpu_torch.models.decode import predict_boxes
from yolov3_tensorflow_tpu_torch.models.yolov3 import (fold_batch_norm,
                                                       yolov3_forward_folded)
from yolov3_tensorflow_tpu_torch.ops.fast_postprocess import (
    decode_tables, pack_serving_head, postprocess_packed,
    postprocess_prefilter, yolov3_forward_packed)
from yolov3_tensorflow_tpu_torch.ops.nms import batched_nms_auto

# build_detector modes of the JAX package that this package does not have
# yet, with the ROADMAP item that ports each.
_DEFERRED_MODES = {
    "split": "ROADMAP queue 1, item 12 (split head, TPU layout experiment)",
    "stem8": "ROADMAP queue 1, item 10 (int8 serving)",
    "int8": "ROADMAP queue 1, item 10 (int8 serving)",
}


def postprocess(feature_maps, anchors: np.ndarray, num_classes: int,
                img_size: Tuple[int, int], *, max_out: int = 50,
                pre_topk: int = 256, score_thresh: float = 0.5,
                iou_thresh: float = 0.5) -> Dict[str, torch.Tensor]:
    """Decode 3 raw feature maps and run per-class NMS over every class's
    min(pre_topk, A) best anchors: the exact path.

    Returns dict of [B, C*max_out, ...]: "boxes" (xyxy, input pixels),
    "scores", "labels", "valid". On CUDA tensors the suppression runs in
    the per-group NMS kernel, on CPU tensors in its plain version.
    """
    boxes, confs, probs = predict_boxes(feature_maps, anchors, num_classes,
                                        img_size)
    return batched_nms_auto(boxes, confs * probs, max_out=max_out,
                            pre_topk=pre_topk, score_thresh=score_thresh,
                            iou_thresh=iou_thresh)


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


class FoldedDetector(nn.Module):
    """The "exact" and "prefilter" modes: images [B, H, W, 3] float in
    [0, 1] (NHWC, any device) -> detections dict of [B, C*max_out, ...] on
    the detector's device, from the BN-folded forward's plain feature maps.
    Runs under torch.inference_mode()."""

    def __init__(self, folded: dict, tables: torch.Tensor, anchors: np.ndarray,
                 num_classes: int, img_size: Tuple[int, int], *, mode: str,
                 max_out: int, pre_topk: int, box_topk: int,
                 score_thresh: float, iou_thresh: float,
                 compute_dtype: torch.dtype):
        super().__init__()
        self.folded = folded
        self.register_buffer("tables", tables)
        self.anchors = np.asarray(anchors, np.float32)
        self.num_classes = num_classes
        self.img_size = (int(img_size[0]), int(img_size[1]))
        self.mode = mode
        self.max_out = max_out
        self.pre_topk = pre_topk
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
        fmaps = yolov3_forward_folded(self.folded, images,
                                      compute_dtype=self.compute_dtype)
        kw = dict(max_out=self.max_out, score_thresh=self.score_thresh,
                  iou_thresh=self.iou_thresh)
        if self.mode == "prefilter":
            return postprocess_prefilter(
                fmaps, self.anchors, self.num_classes, self.img_size,
                box_topk=self.box_topk,
                pre_topk=min(self.pre_topk, self.box_topk),
                tables=self.tables, **kw)
        return postprocess(fmaps, self.anchors, self.num_classes,
                           self.img_size, pre_topk=self.pre_topk, **kw)


def check_mode(mode: str) -> None:
    """Raise unless `build_detector` can build `mode`: NotImplementedError
    naming the ROADMAP item for a JAX mode not ported yet, ValueError for
    an unknown one. The CLIs call it before they load any weights."""
    if mode in ("packed", "exact", "prefilter"):
        return
    where = _DEFERRED_MODES.get(mode)
    if where is None:
        raise ValueError(f"unknown detector mode {mode!r}")
    raise NotImplementedError(f"mode={mode!r} is not ported yet: {where}")


def build_detector(variables, anchors: np.ndarray, num_classes: int,
                   img_size: Tuple[int, int], *, device: torch.device,
                   max_out: int = 200, pre_topk: int = 256,
                   score_thresh: float = 0.3, iou_thresh: float = 0.45,
                   compute_dtype: torch.dtype = torch.bfloat16,
                   box_topk: int = 256, mode: str = "prefilter") -> nn.Module:
    """Build the end-to-end detector on `device`.

    variables: this package's tree (see models.convert.from_jax_variables,
    models.yolov3.init_yolov3 or utils.weights.load_darknet_weights).
    Default thresholds are the demo scripts' (max 200 boxes per class,
    score 0.3, iou 0.45). Modes:

      "prefilter" (the default, as in the JAX package) the folded
                  forward's maps through the objectness prefilter over
                  box_topk candidates and the shared-candidate NMS
                  (pre_topk=min(pre_topk, box_topk) on the CPU route);
                  equal to "exact" whenever no more than box_topk boxes
                  pass the score threshold.
      "packed"    the serving path: one detection conv per scale with
                  128-wide per-anchor blocks, candidate selection by the
                  class-lane-masked objectness over box_topk candidates,
                  and the shared-candidate NMS kernel. Detection rows come
                  out in candidate order when max_out >= box_topk.
      "exact"     the exhaustive per-class path, for mAP evaluation at low
                  thresholds: decode of every anchor, each class's
                  pre_topk best, and the per-group NMS kernel. Rows are
                  score-descending within each class group.

    The JAX package's "split", "stem8" and "int8" modes raise
    NotImplementedError naming the ROADMAP item that ports them.
    """
    check_mode(mode)
    variables = {part: {scope: {name: {k: v.to(device) for k, v in p.items()}
                                for name, p in tree.items()}
                        for scope, tree in variables[part].items()}
                 for part in ("params", "batch_stats")}
    folded = fold_batch_norm(variables, dtype=compute_dtype)
    tables = decode_tables(img_size, anchors, device=device)
    if mode == "packed":
        folded = pack_serving_head(folded, num_classes)
    for tree in folded.values():
        for p in tree.values():
            p = p.get("packed", p)
            p["w"] = p["w"].contiguous(memory_format=torch.channels_last)
    if mode == "packed":
        return PackedDetector(folded, tables, num_classes, img_size,
                              max_out=max_out, box_topk=box_topk,
                              score_thresh=score_thresh,
                              iou_thresh=iou_thresh,
                              compute_dtype=compute_dtype).eval()
    return FoldedDetector(folded, tables, anchors, num_classes, img_size,
                          mode=mode, max_out=max_out, pre_topk=pre_topk,
                          box_topk=box_topk, score_thresh=score_thresh,
                          iou_thresh=iou_thresh,
                          compute_dtype=compute_dtype).eval()


def detections_to_numpy(dets: Dict[str, torch.Tensor], batch_index: int = 0
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Strip padding: fixed-shape detector output -> ragged host arrays
    (boxes [N, 4], scores [N], labels [N]) for one image. Row order depends
    on the mode: exact-mode rows are score-descending within each class
    group; packed-mode rows (and prefilter-mode rows on the GPU) come in
    candidate order when max_out >= box_topk. Sort by score on the host for
    a top-N slice."""
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
