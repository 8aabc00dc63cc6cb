"""CUDA NMS kernels: their wrappers and plain versions.

Two kernels, each the counterpart of a Pallas kernel of
`yolov3_tensorflow_tpu/ops/nms_pallas.py`:

- shared-candidate NMS (`nms_keep_mask_shared`, `batched_nms_shared`;
  `csrc/nms_shared.cu`), the packed serving path's. Every class of an image
  scores the same K candidate boxes. Per image the IoU>t mask is built
  once; per class, exact greedy NMS runs over the candidates whose score
  reaches the score threshold, in score-descending order with ties going
  to the lower candidate index.
- per-group NMS (`nms_keep_mask`, `batched_nms_kernel`; `csrc/nms.cu`), the
  exact path's. Each (image, class) group brings its own K candidates,
  already sorted by score, and a validity mask; the rank is the row index.

Each wrapper launches its CUDA kernel for CUDA tensors and runs its plain
PyTorch version (`*_reference`) only for CPU tensors. There is no fallback
from one to the other: anything else raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Dict, NamedTuple, Optional

import torch

from yolov3_tensorflow_tpu_torch.ops.boxes import iou_xyxy
from yolov3_tensorflow_tpu_torch.ops.nms import (compact_per_class,
                                                 select_per_class,
                                                 suppression_mask)

MAX_K = 1024   # K1 keeps K x K IoU>t bits in shared memory, K2 a row of
               # at most 32 words of 32 candidates
SMEM_LIMIT = 232448    # bytes of shared memory a CTA may opt into (227 KB)
FILL_CTAS = 64         # K1's grid, at least, where the batch allows
MAX_SLICES = 8         # K1's CTAs per image (the largest portable cluster)
WARPS = (32, 16)       # K1's warps per CTA up to K = 256, and above
REBUILD_K = 64         # up to this K each K1 CTA builds the whole mask


class SharedPlan(NamedTuple):
    """How K1 (`csrc/nms_shared.cu`) cuts one launch."""
    slices: int        # S: CTAs per image, each with its own classes
    shared: bool       # the S CTAs form a cluster and share one mask
    warps: int         # warps per CTA, one class each at a time
    classes: int       # Cs: classes per CTA, ceil(C / S)
    chunk: int         # Cc: classes staged into shared memory at a time
    pitch: int         # P: floats per staged score row, odd
    smem: int          # dynamic shared memory per CTA, bytes


@functools.lru_cache(maxsize=None)
def shared_plan(b: int, k: int, c: int) -> SharedPlan:
    """K1's plan for boxes [b, k, 4] and scores [b, k, c].

    S is the smallest power of two (at most MAX_SLICES) that gives at least
    FILL_CTAS CTAs: a batch of 8 spreads over 64 SMs, a batch of 64 or more
    takes one CTA per image. Each CTA owns ceil(c / S) classes, a warp per
    class at a time, with 32 warps up to K = 256 (16 above, where a lane's
    32 candidates need more registers). Up to K = REBUILD_K each CTA builds
    the image's whole IoU>t mask (2,016 IoU tests at K = 64); above, the S
    CTAs form a cluster and each builds 1/S of it. On an H100, at the
    serving candidates, S = 1 beat 2, 4 and 8 at B = 128, 32 warps beat
    16, and a mask shared by a cluster lost to one rebuilt per CTA at
    K = 64 and won at K = 256 (PERF.md).

    A CTA's shared memory holds the boxes and areas (20 bytes a candidate),
    the whole mask (4 * ceil(k / 32) bytes a candidate) and its staged
    scores (4 * pitch bytes a candidate); the staged classes are cut down to
    a chunk until that fits in 227 KB. The pitch is odd so that a warp
    reading one class column from 32 consecutive candidates hits 32
    different banks."""
    t = -(-k // 32)
    s = 1
    while s < MAX_SLICES and b * s < FILL_CTAS:
        s *= 2
    cs = -(-c // s)
    warps = WARPS[0] if k <= 256 else WARPS[1]
    fixed = 4 * (5 * k + k * t)
    chunk = cs
    while fixed + 4 * k * (chunk | 1) > SMEM_LIMIT:
        chunk -= 1
    pitch = chunk | 1
    return SharedPlan(s, s > 1 and k > REBUILD_K, warps, cs, chunk, pitch,
                      fixed + 4 * k * pitch)


def nms_keep_mask_shared_reference(boxes: torch.Tensor, scores: torch.Tensor,
                                   score_thresh: float, iou_thresh: float
                                   ) -> torch.Tensor:
    """Plain PyTorch keep masks. boxes [B, K, 4], scores [B, K, C] fp32 ->
    keep [B, C, K] bool.

    A sequential greedy over each (image, class)'s candidates in
    score-descending order (stable sort: ties to the lower index),
    vectorized over images and classes: a candidate is kept when it is
    valid (score >= score_thresh) and no kept candidate before it has
    IoU > iou_thresh with it.
    """
    b, k, _ = boxes.shape
    c = scores.shape[2]
    over = iou_xyxy(boxes, boxes) > iou_thresh                  # [B, K, K]
    s = scores.transpose(1, 2)                                  # [B, C, K]
    valid = s >= score_thresh
    order = torch.sort(s, dim=-1, descending=True, stable=True).indices
    keep = torch.zeros_like(valid)
    suppressed = torch.zeros_like(valid)
    rows = torch.arange(b, device=boxes.device)[:, None].expand(b, c)
    for step in range(k):
        i = order[..., step:step + 1]                           # [B, C, 1]
        take = (valid.gather(-1, i) & ~suppressed.gather(-1, i))
        keep.scatter_(-1, i, take)
        suppressed |= over[rows, i[..., 0]] & take              # [B, C, K]
    return keep


def nms_keep_mask_shared(boxes: torch.Tensor, scores: torch.Tensor,
                         score_thresh: float, iou_thresh: float
                         ) -> torch.Tensor:
    """All-class keep masks over a shared candidate set.

    boxes [B, K, 4] xyxy fp32, scores [B, K, C] fp32 -> keep [B, C, K] bool.
    CUDA tensors go to the hand-written kernel (K <= 1024, contiguous
    inputs), cut as `shared_plan` says; CPU tensors to
    `nms_keep_mask_shared_reference`. Each kernel launch adds one to
    `nms_keep_mask_shared.launches`.
    """
    if boxes.device.type == "cpu" and scores.device.type == "cpu":
        return nms_keep_mask_shared_reference(boxes, scores, score_thresh,
                                              iou_thresh)
    if boxes.device.type != "cuda" or scores.device != boxes.device:
        raise ValueError(f"boxes on {boxes.device} and scores on "
                         f"{scores.device}: need both on one CUDA device "
                         f"(or both on the CPU)")
    if boxes.dtype != torch.float32 or scores.dtype != torch.float32:
        raise TypeError(f"nms_shared takes float32, got {boxes.dtype} / "
                        f"{scores.dtype}")
    if boxes.ndim != 3 or boxes.shape[2] != 4 or scores.ndim != 3 \
            or scores.shape[:2] != boxes.shape[:2]:
        raise ValueError(f"need boxes [B, K, 4] and scores [B, K, C], got "
                         f"{tuple(boxes.shape)} and {tuple(scores.shape)}")
    if not (boxes.is_contiguous() and scores.is_contiguous()):
        raise ValueError("nms_shared takes contiguous boxes and scores")
    if boxes.data_ptr() % 16:
        raise ValueError("nms_shared reads boxes as float4: need a 16-byte "
                         "aligned boxes tensor")
    b, k, _ = boxes.shape
    c = scores.shape[2]
    if k > MAX_K:
        raise ValueError(f"nms_shared takes K <= {MAX_K}, got {k}")
    keep = torch.empty((b, c, k), dtype=torch.bool, device=boxes.device)
    if keep.numel() == 0:
        return keep
    plan = shared_plan(b, k, c)
    stream = torch.cuda.current_stream(boxes.device).cuda_stream
    err = _shared_launcher()(boxes.data_ptr(), scores.data_ptr(),
                             keep.data_ptr(), b, k, c, float(iou_thresh),
                             float(score_thresh), plan.slices,
                             int(plan.shared), plan.warps, plan.classes,
                             plan.chunk, plan.pitch, stream)
    if err != 0:
        raise RuntimeError(f"nms_shared kernel launch failed: CUDA error {err}")
    nms_keep_mask_shared.launches += 1
    return keep


nms_keep_mask_shared.launches = 0

# the serving path's kernels, K1 and the conv epilogue: the first load of
# either builds both, in one `build_kernels` call
SERVING_KERNELS = ("nms_shared", "conv_epilogue")


@functools.lru_cache(maxsize=None)
def _shared_launcher():
    """Build (at first use, with the conv epilogue) and bind the C entry
    point of nms_shared.cu."""
    from yolov3_tensorflow_tpu_torch.utils.kernels import load_kernel
    return bind_shared(load_kernel("nms_shared", SERVING_KERNELS))


def bind_shared(lib: ctypes.CDLL):
    """nms_shared.cu's C entry point in a loaded library, with its argument
    types: pointers and the stream are c_void_p so ctypes does not cut them
    to 32 bits."""
    fn = lib.nms_shared_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_float, ctypes.c_float, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def batched_nms_shared(boxes: torch.Tensor, scores: torch.Tensor, *,
                       max_out: int = 50, score_thresh: float = 0.5,
                       iou_thresh: float = 0.5,
                       keep_mask: Optional[Callable[..., torch.Tensor]] = None
                       ) -> Dict[str, torch.Tensor]:
    """Per-class NMS where every class scores the SAME candidate boxes.

    boxes [B, K, 4], scores [B, K, C] -> dict of [B, C*max_out, ...]
    ("boxes", "scores", "labels" int32, "valid" bool); the slots of class c
    are rows [c*max_out, (c+1)*max_out). When max_out >= K every kept
    candidate is emitted in candidate order; otherwise each class keeps its
    max_out best (score-descending, ties to the lower index). keep_mask
    computes the keep masks (default `nms_keep_mask_shared`; a reference
    passes `nms_keep_mask_shared_reference` to stay off the kernel).
    """
    b, k, _ = boxes.shape
    c = scores.shape[2]
    keep = (keep_mask or nms_keep_mask_shared)(boxes, scores, score_thresh,
                                               iou_thresh)
    scores_ck = scores.transpose(1, 2)                          # [B, C, K]
    all_boxes = boxes[:, None].expand(b, c, k, 4)
    labels = torch.arange(c, dtype=torch.int32, device=boxes.device)
    labels = labels.view(1, c, 1).expand(b, c, max_out)

    if max_out >= k:
        sel_boxes = boxes.new_zeros((b, c, max_out, 4))
        sel_scores = scores.new_zeros((b, c, max_out))
        sel_valid = keep.new_zeros((b, c, max_out))
        sel_boxes[:, :, :k] = all_boxes
        sel_scores[:, :, :k] = torch.where(keep, scores_ck, 0.0)
        sel_valid[:, :, :k] = keep
    else:
        out_scores = torch.where(keep, scores_ck, float("-inf"))
        sel_scores, sel = torch.sort(out_scores, dim=-1, descending=True,
                                     stable=True)
        sel_scores, sel = sel_scores[..., :max_out], sel[..., :max_out]
        sel_boxes = all_boxes.gather(2, sel[..., None].expand(b, c, max_out, 4))
        sel_valid = torch.isfinite(sel_scores)
        sel_scores = torch.where(sel_valid, sel_scores, 0.0)
    return {
        "boxes": sel_boxes.reshape(b, c * max_out, 4),
        "scores": sel_scores.reshape(b, c * max_out),
        "labels": labels.reshape(b, c * max_out),
        "valid": sel_valid.reshape(b, c * max_out),
    }


def nms_keep_mask_reference(boxes: torch.Tensor, valid: torch.Tensor,
                            iou_thresh: float) -> torch.Tensor:
    """Plain PyTorch keep masks. boxes [G, K, 4] fp32, each row sorted by
    score descending; valid [G, K] bool -> keep [G, K] bool.

    `ops.nms.suppression_mask` over the groups: a sequential greedy over
    the K ranks, vectorized over groups.
    """
    return suppression_mask(boxes, valid, iou_thresh)


def keep_mask_by_blocks(boxes: torch.Tensor, valid: torch.Tensor,
                        iou_thresh: float, block: int = 32) -> torch.Tensor:
    """The per-group kernel's decision order (`csrc/nms.cu`) in plain
    PyTorch, over the same IoU>t bits: boxes [G, K, 4], valid [G, K] ->
    keep [G, K] bool.

    Candidates are taken `block` at a time. Within a block the rows are
    decided in order, each kept row removing the later rows of its block it
    overlaps (its diagonal word); then the block's kept rows, and only
    they, remove the candidates of every later block they overlap. Equal
    to `suppression_mask`; the tests hold it there, as the only rehearsal
    of the kernel's logic without a card."""
    k = boxes.shape[-2]
    over = iou_xyxy(boxes, boxes) > iou_thresh                  # [G, K, K]
    removed = ~valid
    keep = torch.zeros_like(valid)
    for i0 in range(0, k, block):
        i1 = min(i0 + block, k)
        for i in range(i0, i1):
            take = ~removed[:, i]
            keep[:, i] = take
            removed[:, i + 1:i1] |= take[:, None] & over[:, i, i + 1:i1]
        later = (keep[:, i0:i1, None] & over[:, i0:i1, i1:]).any(dim=1)
        removed[:, i1:] |= later
    return keep


def nms_keep_mask(boxes: torch.Tensor, valid: torch.Tensor,
                  iou_thresh: float) -> torch.Tensor:
    """Per-group greedy keep masks over score-sorted candidates.

    boxes [G, K, 4] xyxy fp32, valid [G, K] bool -> keep [G, K] bool:
    candidate j is kept when valid and no kept i < j has IoU > iou_thresh
    with it. CUDA tensors go to the hand-written kernel (1 <= K <= 1024,
    contiguous inputs); CPU tensors to `nms_keep_mask_reference`. Each
    kernel launch adds one to `nms_keep_mask.launches`.
    """
    if boxes.device.type == "cpu" and valid.device.type == "cpu":
        return nms_keep_mask_reference(boxes, valid, iou_thresh)
    if boxes.device.type != "cuda" or valid.device != boxes.device:
        raise ValueError(f"boxes on {boxes.device} and valid on "
                         f"{valid.device}: need both on one CUDA device "
                         f"(or both on the CPU)")
    if boxes.dtype != torch.float32 or valid.dtype != torch.bool:
        raise TypeError(f"nms takes float32 boxes and bool valid, got "
                        f"{boxes.dtype} / {valid.dtype}")
    if boxes.ndim != 3 or boxes.shape[2] != 4 or valid.shape != boxes.shape[:2]:
        raise ValueError(f"need boxes [G, K, 4] and valid [G, K], got "
                         f"{tuple(boxes.shape)} and {tuple(valid.shape)}")
    if not (boxes.is_contiguous() and valid.is_contiguous()):
        raise ValueError("nms takes contiguous boxes and valid")
    if boxes.data_ptr() % 16:
        raise ValueError("nms reads boxes as float4: need a 16-byte aligned "
                         "boxes tensor")
    g, k, _ = boxes.shape
    if k > MAX_K:
        raise ValueError(f"nms takes K <= {MAX_K} candidates per group, got "
                         f"{k}: lower pre_topk")
    keep = torch.empty((g, k), dtype=torch.bool, device=boxes.device)
    if keep.numel() == 0:
        return keep
    stream = torch.cuda.current_stream(boxes.device).cuda_stream
    err = _per_group_launcher()(boxes.data_ptr(), valid.data_ptr(),
                                keep.data_ptr(), g, k, float(iou_thresh),
                                stream)
    if err != 0:
        raise RuntimeError(f"nms kernel launch failed: CUDA error {err}")
    nms_keep_mask.launches += 1
    return keep


nms_keep_mask.launches = 0


@functools.lru_cache(maxsize=None)
def _per_group_launcher():
    """Build (at first use) and bind the C entry point of nms.cu."""
    from yolov3_tensorflow_tpu_torch.utils.kernels import load_kernel
    fn = load_kernel("nms").nms_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_float,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def batched_nms_kernel(boxes: torch.Tensor, scores: torch.Tensor, *,
                       max_out: int = 50, pre_topk: int = 256,
                       score_thresh: float = 0.5, iou_thresh: float = 0.5
                       ) -> Dict[str, torch.Tensor]:
    """`ops.nms.batched_nms` with the suppression in `nms_keep_mask`: the
    per-class stable top-k, the box gather, one kernel launch for all
    B * C groups, the compaction top-k and the padding to max_out.

    boxes [B, A, 4], scores [B, A, C] -> dict of [B, C*max_out, ...].
    """
    b = boxes.shape[0]
    c = scores.shape[2]
    top_scores, top_boxes, valid = select_per_class(boxes, scores, pre_topk,
                                                    score_thresh)
    k = top_scores.shape[-1]
    # at B=1 the reshape of the sliced sort is a strided view, and the
    # kernel takes contiguous rows
    keep = nms_keep_mask(top_boxes.reshape(b * c, k, 4).contiguous(),
                         valid.reshape(b * c, k).contiguous(), iou_thresh)
    return compact_per_class(keep.view(b, c, k), top_scores, top_boxes,
                             max_out)
