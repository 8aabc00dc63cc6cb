"""Device-side inference preprocessing: the letterbox of raw uint8 frames,
and the streaming detector that runs it in front of a detector.

Counterpart of `yolov3_tensorflow_tpu/ops/preprocess.py`. The host sends
raw uint8 frames (a quarter of the bytes of fp32 pixels), and the device
flips BGR to RGB, resizes, pads and normalizes them into the network input.
The source frame size is fixed per streaming detector, as it is for a video
stream, so the inverse transform of its boxes is fixed too.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from yolov3_tensorflow_tpu_torch.ops.postprocess import build_detector

# candidates per image of both streaming modes, as in the JAX package
STREAM_BOX_TOPK = 128


def letterbox_params(src_hw: Tuple[int, int], dst_hw: Tuple[int, int]
                     ) -> Tuple[float, int, int, int, int]:
    """(resize_ratio, resized_h, resized_w, dh, dw) for a letterbox fit —
    the same geometry as data.augment.letterbox_resize (gray-128 padding,
    centered), so host- and device-preprocessed boxes invert identically."""
    sh, sw = src_hw
    dh_, dw_ = dst_hw
    ratio = min(dw_ / sw, dh_ / sh)
    rw, rh = int(ratio * sw), int(ratio * sh)
    pad_h = (dh_ - rh) // 2
    pad_w = (dw_ - rw) // 2
    return ratio, rh, rw, pad_h, pad_w


def device_letterbox(frames_u8: torch.Tensor, dst_hw: Tuple[int, int]
                     ) -> torch.Tensor:
    """uint8 RGB frames [B, H, W, 3] -> letterboxed fp32 [B, dh, dw, 3] in
    [0, 1], on the frames' device.

    Bilinear resize with antialiasing (`jax.image.resize` antialiases when
    it downscales; without it a 480x640 -> 312x416 resize differs from
    JAX's by up to half the range), clip to [0, 255], gray-128 padding,
    /255. The result is a contiguous NHWC tensor, as the host path gives.
    """
    b, sh, sw, _ = frames_u8.shape
    ratio, rh, rw, pad_h, pad_w = letterbox_params((sh, sw), dst_hw)
    dh_, dw_ = dst_hw
    x = frames_u8.permute(0, 3, 1, 2).float()                   # NCHW view
    x = F.interpolate(x, size=(rh, rw), mode="bilinear", align_corners=False,
                      antialias=True)
    x = x.clamp(0.0, 255.0)
    x = F.pad(x, (pad_w, dw_ - rw - pad_w, pad_h, dh_ - rh - pad_h),
              value=128.0)
    return (x / 255.0).permute(0, 2, 3, 1).contiguous()


class StreamingDetector(nn.Module):
    """uint8 frames [B, H, W, 3] (any device; pinned host memory lets the
    copy overlap) -> detections dict of [B, C*max_out, ...] on the
    detector's device: the BGR flip, the letterbox and the wrapped
    detector in one call, under torch.inference_mode()."""

    def __init__(self, detector: nn.Module, src_hw: Tuple[int, int],
                 dst_hw: Tuple[int, int], bgr_input: bool):
        super().__init__()
        self.detector = detector
        self.src_hw = (int(src_hw[0]), int(src_hw[1]))
        self.dst_hw = (int(dst_hw[0]), int(dst_hw[1]))
        self.bgr_input = bgr_input

    @torch.inference_mode()
    def forward(self, frames_u8: torch.Tensor):
        if frames_u8.dtype != torch.uint8 or \
                tuple(frames_u8.shape[1:]) != self.src_hw + (3,):
            raise ValueError(f"streaming detector built for uint8 frames "
                             f"{self.src_hw + (3,)}, got {frames_u8.dtype} "
                             f"{tuple(frames_u8.shape)}")
        frames = frames_u8.to(self.detector.tables.device, non_blocking=True)
        if self.bgr_input:          # OpenCV frames: the flip runs on device
            frames = frames.flip(-1)
        return self.detector(device_letterbox(frames, self.dst_hw))


def build_streaming_detector(variables, anchors: np.ndarray,
                             num_classes: int, src_hw: Tuple[int, int],
                             dst_hw: Tuple[int, int] = (416, 416), *,
                             device: torch.device, max_out: int = 200,
                             score_thresh: float = 0.3,
                             iou_thresh: float = 0.45,
                             compute_dtype: torch.dtype = torch.bfloat16,
                             bgr_input: bool = False,
                             mode: str = "prefilter"):
    """End-to-end streaming detector on `device`: raw uint8 frames of size
    `src_hw` in, detections in `dst_hw` input pixels out.

    Returns (detect, invert): `detect` is a `StreamingDetector`, `invert`
    maps its boxes back to source-frame pixels on the host,
    (boxes - pad) / ratio. mode: "prefilter" (box_topk = pre_topk = 128)
    or "packed" (box_topk = 128); both take the exact top-k of the
    candidates, as the JAX streaming detector does.
    """
    if mode not in ("prefilter", "packed"):
        raise ValueError(f"unsupported streaming mode: {mode!r}")
    det = build_detector(variables, anchors, num_classes, dst_hw,
                         device=device, max_out=max_out,
                         pre_topk=STREAM_BOX_TOPK, score_thresh=score_thresh,
                         iou_thresh=iou_thresh, compute_dtype=compute_dtype,
                         box_topk=STREAM_BOX_TOPK, mode=mode)
    ratio, _, _, pad_h, pad_w = letterbox_params(src_hw, dst_hw)

    def invert(boxes) -> np.ndarray:
        boxes = np.array(boxes, np.float32)
        boxes[..., [0, 2]] = (boxes[..., [0, 2]] - pad_w) / ratio
        boxes[..., [1, 3]] = (boxes[..., [1, 3]] - pad_h) / ratio
        return boxes

    return StreamingDetector(det, src_hw, dst_hw, bgr_input).eval(), invert
