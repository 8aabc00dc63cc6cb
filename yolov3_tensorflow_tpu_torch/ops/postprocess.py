"""The detectors, the exact postprocess, and host-side helpers for their
output.

Counterpart of `yolov3_tensorflow_tpu/ops/postprocess.py`. `build_detector`
folds BN into the conv kernels once, moves the weights and decode tables to
the device, and returns an `nn.Module` whose forward runs the whole chain
on the device: the BN-folded Darknet-53 + FPN (or, arch="yolov4" on the
packed path, CSPDarknet-53 + SPP + PANet), then one of the postprocesses
of `build_detector`'s modes, each ending in a CUDA NMS kernel on the
GPU. `select_serving_mode` and `build_auto_detector` pick a
mode, bf16 or int8 (ops.quantize), from a resolution, a quantization
budget and the device type.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from yolov3_tensorflow_tpu_torch.models import yolov4
from yolov3_tensorflow_tpu_torch.models.decode import predict_boxes
from yolov3_tensorflow_tpu_torch.models.yolov3 import (DETECTION_CONVS,
                                                       channels_last_weights,
                                                       fold_batch_norm,
                                                       yolov3_forward_folded)
from yolov3_tensorflow_tpu_torch.ops.fast_postprocess import (
    decode_tables, pack_serving_head, postprocess_packed,
    postprocess_prefilter, postprocess_split, split_serving_head,
    yolov3_forward_packed, yolov3_forward_split)
from yolov3_tensorflow_tpu_torch.ops.nms import batched_nms_auto
from yolov3_tensorflow_tpu_torch.ops.quantize import (
    QuantizedDetector, build_detector_int8, build_stem_int8_packed,
    calibrate_activation_scales, yolov3_forward_stem_int8_packed)
from yolov3_tensorflow_tpu_torch.utils.profiling import annotate

_MODES = ("packed", "split", "exact", "prefilter", "stem8")
# per architecture: its packed forward, its detection convs (strides 32,
# 16, 8) and each scale's scale_x_y
_ARCHS = {"yolov3": (yolov3_forward_packed, DETECTION_CONVS,
                     (1.0, 1.0, 1.0)),
          "yolov4": (yolov4.yolov4_forward_packed, yolov4.DETECTION_CONVS,
                     yolov4.SCALE_X_Y)}


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
    torch.inference_mode(). Spans (`utils.profiling.annotate`):
    "packed.forward" (the copy in and the packed forward, `packed_forward`:
    `yolov3_forward_packed`, or `models.yolov4.yolov4_forward_packed`
    with its own spans inside) and "packed.postprocess"
    (`postprocess_packed`: score, top-k, gather and decode, K1,
    compaction)."""

    def __init__(self, packed: dict, tables: torch.Tensor, num_classes: int,
                 img_size: Tuple[int, int], *, max_out: int, box_topk: int,
                 score_thresh: float, iou_thresh: float,
                 compute_dtype: torch.dtype,
                 packed_forward=yolov3_forward_packed):
        super().__init__()
        self.packed = packed
        self.packed_forward = packed_forward
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
        with annotate("packed.forward"):
            images = images.to(self.tables.device, non_blocking=True)
            outs = self.packed_forward(self.packed, images,
                                       compute_dtype=self.compute_dtype)
        with annotate("packed.postprocess"):
            return postprocess_packed(
                outs, None, self.num_classes, self.img_size,
                max_out=self.max_out, box_topk=self.box_topk,
                score_thresh=self.score_thresh, iou_thresh=self.iou_thresh,
                tables=self.tables)


class SplitDetector(nn.Module):
    """The "split" mode: images [B, H, W, 3] float in [0, 1] (NHWC, any
    device) -> detections dict of [B, C*max_out, ...] on the detector's
    device, from the split head's (boxconf, cls) outputs through
    `postprocess_split`. Runs under torch.inference_mode()."""

    def __init__(self, split: dict, tables: torch.Tensor, num_classes: int,
                 img_size: Tuple[int, int], *, max_out: int, box_topk: int,
                 score_thresh: float, iou_thresh: float,
                 compute_dtype: torch.dtype):
        super().__init__()
        self.split = split
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
        outs = yolov3_forward_split(self.split, images,
                                    compute_dtype=self.compute_dtype)
        return postprocess_split(
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


def variables_on(variables, device: torch.device) -> Dict[str, dict]:
    """The {"params", "batch_stats"} tree with every tensor on `device`."""
    return {part: {scope: {name: {k: v.to(device) for k, v in p.items()}
                           for name, p in tree.items()}
                   for scope, tree in variables[part].items()}
            for part in ("params", "batch_stats")}


def build_detector(variables, anchors: np.ndarray, num_classes: int,
                   img_size: Tuple[int, int], *, device: torch.device,
                   max_out: int = 200, pre_topk: int = 256,
                   score_thresh: float = 0.3, iou_thresh: float = 0.45,
                   compute_dtype: torch.dtype = torch.bfloat16,
                   box_topk: int = 256, mode: str = "prefilter",
                   approx_topk: bool = False,
                   calibration_images=None,
                   stem_int8_upto: int = 12,
                   activation_scales=None, arch: str = "yolov3"
                   ) -> nn.Module:
    """Build the end-to-end detector on `device`.

    variables: this package's tree (see models.convert.from_jax_variables,
    models.yolov3.init_yolov3 or utils.weights.load_darknet_weights; for
    arch="yolov4", models.yolov4.init_yolov4). arch "yolov3" (the default)
    serves YOLOv3 in every mode; "yolov4" serves YOLOv4 (CSPDarknet-53,
    SPP, PANet, `models.yolov4`) in mode "packed" only, with `anchors` its
    own (the cfg's nine, masks 0-2, 3-5, 6-8 for strides 8, 16, 32) and
    each scale's scale_x_y in the decode.
    Any other mode or arch raises ValueError.
    Default thresholds are the demo scripts' (max 200 boxes per class,
    score 0.3, iou 0.45). Modes:

      "prefilter" (the default, as in the JAX package) the folded
                  forward's maps through the objectness prefilter over
                  box_topk candidates and the shared-candidate NMS
                  (pre_topk=min(pre_topk, box_topk) on the CPU route);
                  equal to "exact" whenever no more than box_topk boxes
                  pass the score threshold.
      "split"     the split serving head: each detection conv as a
                  15-channel fp32 boxconf conv and a conv of 128-wide
                  class blocks in bf16 (ops.fast_postprocess.
                  split_serving_head), candidate selection over
                  box_topk candidates and the shared-candidate NMS kernel
                  (its plain version on the CPU); the prefilter's math,
                  rows in candidate order when max_out >= box_topk.
      "packed"    the serving path: one detection conv per scale with
                  128-wide per-anchor blocks, candidate selection by the
                  class-lane-masked objectness over box_topk candidates,
                  and the shared-candidate NMS kernel. Detection rows come
                  out in candidate order when max_out >= box_topk.
      "exact"     the exhaustive per-class path, for mAP evaluation at low
                  thresholds: decode of every anchor, each class's
                  pre_topk best, and the per-group NMS kernel. Rows are
                  score-descending within each class group.
      "stem8"     "packed" with the early backbone
                  (conv_0..conv_{stem_int8_upto-1}) int8-chained
                  (ops.quantize); needs `calibration_images` (a few
                  representative images, NHWC in [0, 1]) for the
                  activation scales, or the scales themselves
                  (`activation_scales`, as ops.quantize.
                  calibrate_activation_scales returns them). Runs in bf16
                  whatever compute_dtype says, as in the JAX package.

    Full int8 detectors come from ops.quantize.build_detector_int8 (or
    build_auto_detector); "int8" and any other mode raise ValueError.
    approx_topk is the JAX package's argument of the split and packed
    modes; either value selects the exact top-k (ops.fast_postprocess).
    """
    if mode not in _MODES:
        hint = (": full int8 detectors come from ops.quantize."
                "build_detector_int8 or build_auto_detector"
                if mode == "int8" else "")
        raise ValueError(f"unknown detector mode {mode!r}{hint}")
    if arch not in _ARCHS:
        raise ValueError(f"unknown architecture {arch!r}: one of "
                         f"{sorted(_ARCHS)}")
    if arch != "yolov3" and mode != "packed":
        raise ValueError(f"arch={arch!r} is served in mode 'packed' only, "
                         f"got mode {mode!r}")
    packed_forward, det_convs, scale_x_y = _ARCHS[arch]
    variables = variables_on(variables, device)
    tables = decode_tables(img_size, anchors, device=device,
                           scale_x_y=scale_x_y)
    if mode == "stem8":
        if activation_scales is None:
            if calibration_images is None:
                raise ValueError("mode='stem8' needs calibration_images")
            activation_scales = calibrate_activation_scales(
                variables, calibration_images)
        hp = build_stem_int8_packed(variables, activation_scales,
                                    num_classes, upto=stem_int8_upto)
        return QuantizedDetector(
            yolov3_forward_stem_int8_packed, hp, tables, anchors,
            num_classes, img_size, post="packed", max_out=max_out,
            box_topk=box_topk, score_thresh=score_thresh,
            iou_thresh=iou_thresh).eval()
    folded = fold_batch_norm(variables, dtype=compute_dtype)
    if mode == "packed":
        folded = pack_serving_head(folded, num_classes, names=det_convs)
    elif mode == "split":
        folded = split_serving_head(folded, num_classes)
    channels_last_weights(folded)
    if mode == "split":
        return SplitDetector(folded, tables, num_classes, img_size,
                             max_out=max_out, box_topk=box_topk,
                             score_thresh=score_thresh,
                             iou_thresh=iou_thresh,
                             compute_dtype=compute_dtype).eval()
    if mode == "packed":
        return PackedDetector(folded, tables, num_classes, img_size,
                              max_out=max_out, box_topk=box_topk,
                              score_thresh=score_thresh,
                              iou_thresh=iou_thresh,
                              compute_dtype=compute_dtype,
                              packed_forward=packed_forward).eval()
    return FoldedDetector(folded, tables, anchors, num_classes, img_size,
                          mode=mode, max_out=max_out, pre_topk=pre_topk,
                          box_topk=box_topk, score_thresh=score_thresh,
                          iou_thresh=iou_thresh,
                          compute_dtype=compute_dtype).eval()


# --------------------------------------------------------------------------
# Resolution-aware serving-mode selection, per device type
# --------------------------------------------------------------------------
# On the CPU: the JAX package's policy, unchanged. Its boundary is a TPU
# measurement: on a TPU v5e full int8 won at 416^2 and 608^2 and lost to
# bf16 at 896x1344 (yolov3_tensorflow_tpu/ops/postprocess.py,
# docs/BENCHMARKS.md), so full int8 is picked up to 700*700 pixels.
_INT8_MAX_AREA = 700 * 700

# On CUDA: the H100's measured table, img/s of each mode at the JAX
# package's benched sizes and batches (416^2 at 128, 608^2 at 80, 896x1344
# at 16), from chip_smoke.py phase 14 on an NVIDIA H100 80GB HBM3 at
# 700.00 W (PERF.md, the mode table). bf16 packed beat both int8 modes at
# every size, so every budget serves packed there.
_CUDA_MODE_TABLE = {
    (416, 416): {"packed": 2947.4, "stem8": 983.5, "int8": 574.0},
    (608, 608): {"packed": 1398.3, "stem8": 461.9, "int8": 269.9},
    (896, 1344): {"packed": 422.1, "stem8": 140.6, "int8": 82.2},
}
_BUDGET_MODES = {"none": ("packed",), "hybrid": ("packed", "stem8"),
                 "full": ("packed", "stem8", "int8")}
SERVING_TABLES = {
    "cpu": "the JAX package's TPU v5e table",
    "cuda": "the NVIDIA H100 80GB HBM3 table (chip_smoke.py phase 14)",
}


def select_serving_mode(img_size: Tuple[int, int], *,
                        device: torch.device,
                        quantize: str = "hybrid") -> str:
    """Pick the serving mode for an inference resolution on `device`'s
    type: the fastest mode the budget allows, as that device type measured
    it, so never one measured slower than bf16 packed. `device` is
    required: the policy follows the card the caller names, and a default
    would hand a CUDA caller the CPU's (JAX's TPU) policy.

    quantize declares how much numeric approximation the caller accepts:
      "none"    bf16 arithmetic only   -> "packed"
      "hybrid"  the stem-int8 hybrid   -> on the CPU "stem8" at every
                                          size (JAX's policy); on CUDA
                                          the faster of packed and stem8
      "full"    full int8 PTQ          -> on the CPU "int8" up to
                                          _INT8_MAX_AREA pixels, "stem8"
                                          beyond it; on CUDA the fastest
                                          of the three
    On CUDA the table's size nearest in area to `img_size` decides
    (_CUDA_MODE_TABLE: packed at every size).

    Returns one of "packed" / "stem8" / "int8". Callers route "int8" to
    ops.quantize.build_detector_int8 and the rest to build_detector, or
    call build_auto_detector, which does both.
    """
    if quantize not in _BUDGET_MODES:
        raise ValueError(f"quantize must be none|hybrid|full, got {quantize}")
    if quantize == "none":
        return "packed"
    area = img_size[0] * img_size[1]
    if torch.device(device).type == "cuda":
        size = min(_CUDA_MODE_TABLE,
                   key=lambda hw: abs(hw[0] * hw[1] - area))
        rates = _CUDA_MODE_TABLE[size]
        return max(_BUDGET_MODES[quantize], key=rates.get)
    if quantize == "full" and area <= _INT8_MAX_AREA:
        return "int8"
    return "stem8"


def build_auto_detector(variables, anchors: np.ndarray, num_classes: int,
                        img_size: Tuple[int, int], *,
                        quantize: str = "hybrid",
                        calibration_images=None,
                        **kwargs) -> nn.Module:
    """build_detector with the serving mode picked per resolution and
    device type (`select_serving_mode` on kwargs["device"]). stem8 and
    int8 need `calibration_images`; without them the selection falls back
    to the bf16 "packed" path. kwargs go to build_detector (`device` among
    them), or to build_detector_int8 for the ones it takes."""
    if calibration_images is None:
        quantize = "none"
    mode = select_serving_mode(img_size, quantize=quantize,
                               device=kwargs["device"])
    if mode == "int8":
        accepted = ("device", "max_out", "score_thresh", "iou_thresh",
                    "box_topk")
        detect, _ = build_detector_int8(
            variables, anchors, num_classes, img_size, mode="packed",
            calibration_images=calibration_images,
            **{k: v for k, v in kwargs.items() if k in accepted})
        return detect
    return build_detector(variables, anchors, num_classes, img_size,
                          mode=mode, calibration_images=calibration_images,
                          **kwargs)


def detections_to_numpy(dets: Dict[str, torch.Tensor], batch_index: int = 0
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Strip padding: fixed-shape detector output -> ragged host arrays
    (boxes [N, 4], scores [N], labels [N]) for one image. Row order depends
    on the mode: exact-mode rows are score-descending within each class
    group; packed- and split-mode rows (and prefilter-mode rows on the GPU)
    come in candidate order when max_out >= box_topk. Sort by score on the
    host for a top-N slice."""
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
