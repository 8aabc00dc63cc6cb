"""Fixed-shape per-class NMS: the plain PyTorch path and the host oracles.

Counterpart of `yolov3_tensorflow_tpu/ops/nms.py`. Score threshold,
per-class greedy non-max suppression with a per-class output cap, all
classes concatenated, every stage a fixed-capacity selection plus a
validity mask:

  1. per class: the `pre_topk` best candidates by score (score < thresh ->
     invalid), `select_per_class`
  2. exact greedy suppression over the sorted candidates,
     `suppression_mask` (sequential in K, vectorized over image x class)
  3. per class: the `max_out` best survivors, `compact_per_class`
  4. classes flattened to [C * max_out] slots with a validity mask

Both sorts are stable and descending, so equal scores keep the lower index
first, as the JAX package's `lax.top_k` orders them (`torch.topk` promises
no tie order). `suppression_mask` is also the plain version of the CUDA
kernel in `ops/nms_cuda.py`; `py_nms` and `cpu_nms` are the numpy oracles,
copied because importing the JAX module pulls in jax.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from yolov3_tensorflow_tpu_torch.ops.boxes import iou_xyxy


def suppression_mask(boxes: torch.Tensor, valid: torch.Tensor,
                     iou_thresh: float) -> torch.Tensor:
    """Exact greedy NMS keep mask over score-descending sorted boxes.

    boxes [..., K, 4] xyxy, each row sorted by score descending; valid
    [..., K] bool. Returns keep [..., K] bool: a box is kept iff it is valid
    and no higher-ranked *kept* box has IoU > iou_thresh with it. Leading
    dimensions are independent groups.
    """
    k = boxes.shape[-2]
    ranks = torch.arange(k, device=boxes.device)
    # over[..., i, j]: candidate i, if kept, suppresses the later j
    over = (iou_xyxy(boxes, boxes) > iou_thresh) & (ranks[None, :]
                                                    > ranks[:, None])
    keep = valid.clone()
    for i in range(k):
        keep &= ~(keep[..., i:i + 1] & over[..., i, :])
    return keep


def select_per_class(boxes: torch.Tensor, scores: torch.Tensor,
                     pre_topk: int, score_thresh: float
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stage 1: boxes [B, A, 4], scores [B, A, C] -> (top_scores [B, C, K],
    top_boxes [B, C, K, 4], valid [B, C, K]) with K = min(pre_topk, A),
    each class's candidates score-descending, ties to the lower index."""
    b, a, _ = boxes.shape
    c = scores.shape[2]
    k = min(pre_topk, a)
    top_scores, top_idx = torch.sort(scores.transpose(1, 2), dim=-1,
                                     descending=True, stable=True)
    top_scores, top_idx = top_scores[..., :k], top_idx[..., :k]
    top_boxes = boxes[:, None].expand(b, c, a, 4).gather(
        2, top_idx[..., None].expand(b, c, k, 4))
    return top_scores, top_boxes, top_scores >= score_thresh


def compact_per_class(keep: torch.Tensor, top_scores: torch.Tensor,
                      top_boxes: torch.Tensor, max_out: int
                      ) -> Dict[str, torch.Tensor]:
    """Stages 3-4: keep masks [B, C, K] -> dict of [B, C*max_out, ...]
    ("boxes", "scores", "labels" int32, "valid" bool); class c fills rows
    [c*max_out, (c+1)*max_out), score-descending, padding invalid."""
    b, c, k = keep.shape
    m = min(max_out, k)
    out_scores = torch.where(keep, top_scores, float("-inf"))
    sel_scores, sel = torch.sort(out_scores, dim=-1, descending=True,
                                 stable=True)
    sel_scores, sel = sel_scores[..., :m], sel[..., :m]
    sel_boxes = top_boxes.gather(2, sel[..., None].expand(b, c, m, 4))
    sel_valid = torch.isfinite(sel_scores)
    sel_scores = torch.where(sel_valid, sel_scores, 0.0)
    if m < max_out:
        pad = max_out - m
        sel_boxes = torch.nn.functional.pad(sel_boxes, (0, 0, 0, pad))
        sel_scores = torch.nn.functional.pad(sel_scores, (0, pad))
        sel_valid = torch.nn.functional.pad(sel_valid, (0, pad))
    labels = torch.arange(c, dtype=torch.int32, device=keep.device)
    labels = labels.view(1, c, 1).expand(b, c, max_out)
    return {
        "boxes": sel_boxes.reshape(b, c * max_out, 4),
        "scores": sel_scores.reshape(b, c * max_out),
        "labels": labels.reshape(b, c * max_out),
        "valid": sel_valid.reshape(b, c * max_out),
    }


def batched_nms(boxes: torch.Tensor, scores: torch.Tensor, *,
                max_out: int = 50, pre_topk: int = 256,
                score_thresh: float = 0.5, iou_thresh: float = 0.5
                ) -> Dict[str, torch.Tensor]:
    """Per-class NMS in plain PyTorch: boxes [B, A, 4] xyxy, scores
    [B, A, C] (= conf * prob) -> dict of [B, C*max_out, ...]."""
    top_scores, top_boxes, valid = select_per_class(boxes, scores, pre_topk,
                                                    score_thresh)
    keep = suppression_mask(top_boxes, valid, iou_thresh)
    return compact_per_class(keep, top_scores, top_boxes, max_out)


def per_class_nms(boxes: torch.Tensor, scores: torch.Tensor, *,
                  max_out: int = 50, pre_topk: int = 256,
                  score_thresh: float = 0.5, iou_thresh: float = 0.5
                  ) -> Dict[str, torch.Tensor]:
    """`batched_nms` for one image: boxes [A, 4], scores [A, C] -> dict of
    [C*max_out, ...]."""
    out = batched_nms(boxes[None], scores[None], max_out=max_out,
                      pre_topk=pre_topk, score_thresh=score_thresh,
                      iou_thresh=iou_thresh)
    return {key: v[0] for key, v in out.items()}


def batched_nms_auto(boxes: torch.Tensor, scores: torch.Tensor, *,
                     max_out: int = 50, pre_topk: int = 256,
                     score_thresh: float = 0.5, iou_thresh: float = 0.5
                     ) -> Dict[str, torch.Tensor]:
    """`batched_nms` with the suppression on the tensors' device: CUDA
    tensors go through the hand-written kernel
    (`nms_cuda.batched_nms_kernel`), CPU tensors through the plain
    version."""
    kwargs = dict(max_out=max_out, pre_topk=pre_topk,
                  score_thresh=score_thresh, iou_thresh=iou_thresh)
    if boxes.device.type == "cuda":
        from yolov3_tensorflow_tpu_torch.ops.nms_cuda import \
            batched_nms_kernel
        return batched_nms_kernel(boxes, scores, **kwargs)
    return batched_nms(boxes, scores, **kwargs)


# ---------------------------------------------------------------------------
# Host oracles (copied from the JAX package's ops/nms.py)
# ---------------------------------------------------------------------------

def py_nms(boxes: np.ndarray, scores: np.ndarray, max_boxes: int = 50,
           iou_thresh: float = 0.5, offset: float = 0.0) -> list:
    """Trivially correct numpy greedy NMS (test oracle). `offset=0` is the
    tf.image.non_max_suppression convention; `offset=1.0` the legacy +1
    pixel one."""
    order = np.argsort(-scores, kind="stable")
    keep = []
    suppressed = np.zeros(len(scores), dtype=bool)
    areas = (boxes[:, 2] - boxes[:, 0] + offset) * (boxes[:, 3] - boxes[:, 1]
                                                    + offset)
    for i in order:
        if suppressed[i]:
            continue
        keep.append(int(i))
        if len(keep) >= max_boxes:
            break
        xx0 = np.maximum(boxes[i, 0], boxes[:, 0])
        yy0 = np.maximum(boxes[i, 1], boxes[:, 1])
        xx1 = np.minimum(boxes[i, 2], boxes[:, 2])
        yy1 = np.minimum(boxes[i, 3], boxes[:, 3])
        w = np.maximum(0.0, xx1 - xx0 + offset)
        h = np.maximum(0.0, yy1 - yy0 + offset)
        inter = w * h
        iou = inter / (areas[i] + areas - inter)
        suppressed |= iou > iou_thresh
        suppressed[i] = True  # already kept; never revisit
    return keep


def cpu_nms(boxes: np.ndarray, scores: np.ndarray, num_classes: int,
            max_boxes: int = 50, score_thresh: float = 0.5,
            iou_thresh: float = 0.5):
    """Host per-class NMS. boxes: [A, 4] or [1, A, 4]; scores: [A, C] or
    [1, A, C]. Returns (boxes [N, 4], scores [N], labels [N]) or (None,
    None, None)."""
    boxes = boxes.reshape(-1, 4)
    scores = scores.reshape(-1, num_classes)
    picked_b, picked_s, picked_l = [], [], []
    for c in range(num_classes):
        idx = np.where(scores[:, c] >= score_thresh)[0]
        if idx.size == 0:
            continue
        fb, fs = boxes[idx], scores[idx, c]
        keep = py_nms(fb, fs, max_boxes=max_boxes, iou_thresh=iou_thresh)
        picked_b.append(fb[keep])
        picked_s.append(fs[keep])
        picked_l.append(np.full(len(keep), c, np.int32))
    if not picked_b:
        return None, None, None
    return (np.concatenate(picked_b), np.concatenate(picked_s),
            np.concatenate(picked_l))
