"""Batch-sharded inference over the process group (counterpart of
`yolov3_tensorflow_tpu/parallel/serving.py`).

Detection is independent per image, so a multi-device deployment splits a
batch over the ranks: each rank runs its rows through the single-device
detector (`ops.postprocess.build_detector`: forward, decode and the
shared-candidate NMS kernel on a GPU), and one all-gather collects the
fixed-shape outputs, in rank order. A rank's rows are bit for bit what the
single-device detector gives on them; against the whole batch run on one
device they can differ where cuDNN picks another convolution algorithm
for another batch size (the JAX package's sharded serving reproduces 693
of 695 detections).
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch
import torch.distributed as dist

from yolov3_tensorflow_tpu_torch.ops.postprocess import (build_detector,
                                                         pack_detections,
                                                         variables_on)
from yolov3_tensorflow_tpu_torch.ops.quantize import \
    calibrate_activation_scales
from yolov3_tensorflow_tpu_torch.parallel.mesh import Mesh, shard_batch
from yolov3_tensorflow_tpu_torch.parallel.multihost import (collective_device,
                                                            is_primary)


def make_sharded_detector(variables, anchors: np.ndarray, num_classes: int,
                          img_size: Tuple[int, int], mesh: Mesh, *,
                          device: torch.device, mode: str = "packed",
                          max_out: int = 128, box_topk: int = 64,
                          score_thresh: float = 0.3, iou_thresh: float = 0.45,
                          calibration_images=None,
                          stem_int8_upto: int = 12) -> Callable:
    """A detector whose batch is split over `mesh`'s ranks.

    images [B, H, W, 3] (the whole batch on every rank, B divisible by the
    number of ranks) -> the {"boxes", "scores", "labels", "valid"} dict of
    the whole batch on every rank, on `device` (this rank's).

    mode: "packed" (the serving path), "prefilter" (exact at demo
    thresholds, over max(box_topk, 128) candidates with each class's 128
    best) or "stem8" (packed with the early backbone int8; its activation
    scales are calibrated on `calibration_images` by rank 0 and broadcast,
    so every rank quantizes alike), as the JAX package's sharded detector
    configures them. Without a mesh it is the single-device detector."""
    if mode not in ("packed", "prefilter", "stem8"):
        raise ValueError(f"unsupported sharded serving mode: {mode!r}")
    kw = dict(device=device, mode=mode, max_out=max_out,
              score_thresh=score_thresh, iou_thresh=iou_thresh,
              stem_int8_upto=stem_int8_upto)
    if mode == "prefilter":
        kw.update(box_topk=max(box_topk, 128), pre_topk=128)
    else:
        kw.update(box_topk=box_topk)
    if mode == "stem8":
        if calibration_images is None:
            raise ValueError("mode='stem8' needs calibration_images")
        scales = [calibrate_activation_scales(
            variables_on(variables, device), calibration_images)
            if is_primary() else None]
        if mesh is not None:
            dist.broadcast_object_list(scales, src=0, group=mesh,
                                       device=collective_device())
        kw.update(activation_scales=scales[0])
    detect = build_detector(variables, anchors, num_classes, img_size, **kw)
    if mesh is None:
        return detect
    world = dist.get_world_size(mesh)

    def sharded(images: torch.Tensor) -> Dict[str, torch.Tensor]:
        local = detect(shard_batch(mesh, images))
        # one float32 block per rank: labels (< 2^24) and valid flags
        # survive float32 exactly
        packed = pack_detections(local)
        blocks = [torch.empty_like(packed) for _ in range(world)]
        dist.all_gather(blocks, packed)
        whole = torch.cat(blocks)
        return {"boxes": whole[..., 0:4].to(local["boxes"].dtype),
                "scores": whole[..., 4].to(local["scores"].dtype),
                "labels": whole[..., 5].to(local["labels"].dtype),
                "valid": (whole[..., 6] > 0.5).to(local["valid"].dtype)}

    return sharded
