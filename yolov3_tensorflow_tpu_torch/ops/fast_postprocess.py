"""Candidate-prefilter postprocess: the packed serving head, and the
prefilter over the folded forward's feature maps.

Counterpart of the packed and prefilter paths of
`yolov3_tensorflow_tpu/ops/fast_postprocess.py`. Both score every anchor by
sigmoid(conf) * sigmoid(max class logit), take the exact top K per image,
decode only those candidates from flat per-anchor tables, and run per-class
NMS over the K candidates.

Packed head: each scale's single 1x1 detection conv emits 3 anchor blocks
of `row` (=128) channels, laid out as

    [0:C)      class logits
    [C]        objectness logit
    [C+1:C+5)  box logits tx, ty, tw, th
    [C+5:row)  padding, bias -30 (sigmoid ~ 0)

so [B, Hg, Wg, 3*row] -> [B, Hg*Wg*3, row] is a free view whose index is
the global anchor index (scale-major, then y, x, anchor).

Prefilter (`postprocess_prefilter`): the same selection over the plain
[B, Hg, Wg, 3*(5+C)] maps of `models.yolov3.yolov3_forward_folded`. It
equals the exact path (`ops.postprocess.postprocess`) whenever every box
that passes the score threshold in any class ranks in the top box_topk,
which holds when no more than box_topk boxes pass.

Left out on purpose: the one-hot MXU gather and the `cell_major` layout
(TPU DMA-latency workarounds; a torch.gather per scale does the job here),
approximate top-k, the aligned head, the score-dtype knob, and padding K to
a multiple of 8 (a TPU sublane rule; the CUDA kernel takes any K <= 1024).
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from yolov3_tensorflow_tpu_torch.models.layers import conv2d
from yolov3_tensorflow_tpu_torch.models.yolov3 import (DETECTION_CONVS,
                                                       folded_body)
from yolov3_tensorflow_tpu_torch.ops.nms import batched_nms
from yolov3_tensorflow_tpu_torch.ops.nms_cuda import batched_nms_shared

_LANE = 128


@functools.lru_cache(maxsize=32)
def _decode_tables(img_h: int, img_w: int, anchors_key: Tuple[float, ...]
                   ) -> Tuple[np.ndarray, ...]:
    """Flat per-anchor decode constants in global anchor order
    (scale 32 -> 16 -> 8; row-major y, x, anchor within each scale):
    grid x, grid y, stride x, stride y, anchor w, anchor h."""
    anchors = np.asarray(anchors_key, np.float32).reshape(9, 2)
    groups = [anchors[6:9], anchors[3:6], anchors[0:3]]
    xs, ys, rws, rhs, aws, ahs = [], [], [], [], [], []
    for stride, group in zip((32, 16, 8), groups):
        hg, wg = img_h // stride, img_w // stride
        yy, xx = np.mgrid[0:hg, 0:wg]
        for arr, val in ((xs, np.repeat(xx[..., None], 3, -1)),
                         (ys, np.repeat(yy[..., None], 3, -1))):
            arr.append(val.reshape(-1).astype(np.float32))
        n = hg * wg * 3
        rws.append(np.full(n, img_w / wg, np.float32))
        rhs.append(np.full(n, img_h / hg, np.float32))
        aws.append(np.tile(group[:, 0], hg * wg).astype(np.float32))
        ahs.append(np.tile(group[:, 1], hg * wg).astype(np.float32))
    return tuple(np.concatenate(v) for v in (xs, ys, rws, rhs, aws, ahs))


def decode_tables(img_size: Tuple[int, int], anchors: np.ndarray, *,
                  device: torch.device) -> torch.Tensor:
    """`_decode_tables` stacked into one [6, A] fp32 tensor on `device`."""
    tabs = _decode_tables(int(img_size[0]), int(img_size[1]),
                          tuple(np.asarray(anchors, np.float32)
                                .reshape(-1).tolist()))
    return torch.from_numpy(np.stack(tabs)).to(device)


def head_row_width(num_classes: int) -> int:
    """Per-anchor channel block, padded to a multiple of 128."""
    need = 5 + num_classes
    return ((need + _LANE - 1) // _LANE) * _LANE


def pack_serving_head(folded: dict, num_classes: int,
                      out_dtype: torch.dtype = torch.bfloat16) -> dict:
    """Rewrite the folded detection convs (head conv_6/14/22) for
    `yolov3_forward_packed`: each becomes {"packed": {w [3*row, cin, 1, 1],
    b [3*row] out_dtype}} with the block layout in the module docstring.
    The kernel keeps its dtype; the bias is rounded to `out_dtype` here,
    as the JAX package does."""
    row = head_row_width(num_classes)
    need = 5 + num_classes
    out = {scope: dict(v) for scope, v in folded.items()}
    for name in DETECTION_CONVS:
        p = folded["head"][name]
        w, b = p["w"].float(), p["b"].float()         # [3*need, cin, 1, 1]
        wp = w.new_zeros((3 * row,) + tuple(w.shape[1:]))
        bp = torch.full((3 * row,), -30.0, device=b.device)   # pad lanes ~ 0
        for a in range(3):
            src, dst = a * need, a * row
            # classes first, then conf, then tx ty tw th
            wp[dst:dst + num_classes] = w[src + 5:src + need]
            bp[dst:dst + num_classes] = b[src + 5:src + need]
            wp[dst + num_classes] = w[src + 4]
            bp[dst + num_classes] = b[src + 4]
            wp[dst + num_classes + 1:dst + num_classes + 5] = w[src:src + 4]
            bp[dst + num_classes + 1:dst + num_classes + 5] = b[src:src + 4]
        out["head"][name] = {"packed": {"w": wp.to(p["w"].dtype),
                                        "b": bp.to(out_dtype)}}
    return out


def apply_packed_output_conv(p: dict, x: torch.Tensor, *,
                             compute_dtype: torch.dtype = torch.bfloat16,
                             out_dtype: torch.dtype = torch.bfloat16
                             ) -> torch.Tensor:
    """One packed detection conv: NCHW logits in `out_dtype`, the bias added
    in the conv's dtype."""
    y = conv2d(x, p["packed"]["w"], compute_dtype=compute_dtype)
    return (y + p["packed"]["b"].to(y.dtype).view(1, -1, 1, 1)).to(out_dtype)


def yolov3_forward_packed(packed: dict, images: torch.Tensor, *,
                          compute_dtype: torch.dtype = torch.bfloat16,
                          out_dtype: torch.dtype = torch.bfloat16
                          ) -> List[torch.Tensor]:
    """Forward pass emitting packed head outputs: 3 tensors [N, Hg, Wg,
    3*row] in `out_dtype`, strides (32, 16, 8). images: [N, H, W, 3] float.
    Params come from `pack_serving_head`. (The JAX `_serving_body` is
    `models.yolov3.folded_body` here.)"""

    def out_packed(i, x):
        return apply_packed_output_conv(
            packed["head"][f"conv_{i}"], x, compute_dtype=compute_dtype,
            out_dtype=out_dtype)

    return folded_body(packed, images, out_packed, compute_dtype=compute_dtype)


def packed_candidates(packed_outs: Sequence[torch.Tensor], num_classes: int,
                      tables: torch.Tensor, box_topk: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prefilter and decode: packed head outputs -> (boxes [B, K, 4] xyxy in
    input pixels, scores [B, K, C] = conf * class prob), both fp32, for the
    K = min(box_topk, A) best anchors of each image.

    The selection score is sigmoid(conf) * sigmoid(max over the class
    lanes [0, C)), so conf/box/padding lanes never inflate a candidate's
    rank. Ties in it go to the lower anchor index (a stable sort), as the
    JAX package's lax.top_k orders them.
    """
    c = num_classes
    row = head_row_width(c)
    views, objs, offsets = [], [], []
    off = 0
    for p in packed_outs:
        b, hg, wg, _ = p.shape
        pr = p.reshape(b, hg * wg * 3, row)
        obj = torch.sigmoid(pr[..., c].float()) * torch.sigmoid(
            pr[..., :c].amax(dim=-1).float())
        views.append(pr)
        objs.append(obj)
        offsets.append(off)
        off += pr.shape[1]
    obj = torch.cat(objs, dim=1)                                # [B, A]
    k = min(box_topk, off)
    cand = torch.sort(obj, dim=1, descending=True, stable=True).indices[:, :k]

    rows = None
    for pr, ofs in zip(views, offsets):
        na = pr.shape[1]
        local = (cand - ofs).clamp(0, na - 1)
        g = pr.gather(1, local[..., None].expand(-1, -1, row))  # [B, K, row]
        in_scale = ((cand >= ofs) & (cand < ofs + na))[..., None]
        rows = g if rows is None else torch.where(in_scale, g, rows)

    gx, gy, grw, grh, gaw, gah = tables[:, cand]                # [B, K] each
    box = rows[..., c + 1:c + 5].float()                        # tx ty tw th
    cx = (torch.sigmoid(box[..., 0]) + gx) * grw
    cy = (torch.sigmoid(box[..., 1]) + gy) * grh
    w = torch.exp(box[..., 2]) * gaw
    h = torch.exp(box[..., 3]) * gah
    boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                        dim=-1)
    conf = torch.sigmoid(rows[..., c:c + 1].float())
    scores = conf * torch.sigmoid(rows[..., :c].float())
    return boxes, scores


def postprocess_packed(packed_outs: Sequence[torch.Tensor],
                       anchors: np.ndarray, num_classes: int,
                       img_size: Tuple[int, int], *,
                       max_out: int = 128, box_topk: int = 128,
                       score_thresh: float = 0.3, iou_thresh: float = 0.45,
                       tables: Optional[torch.Tensor] = None
                       ) -> Dict[str, torch.Tensor]:
    """Batched detection from packed head outputs (`yolov3_forward_packed`).

    Returns dict of [B, C*max_out, ...]: "boxes" (xyxy, input pixels),
    "scores", "labels", "valid" — the JAX package's contract. `tables` is
    `decode_tables(img_size, anchors)` on the outputs' device; a detector
    passes the copy it made once, otherwise it is built here. On CUDA
    tensors the NMS runs in the hand-written kernel.
    """
    if tables is None:
        tables = decode_tables(img_size, anchors, device=packed_outs[0].device)
    boxes, scores = packed_candidates(packed_outs, num_classes, tables,
                                      box_topk)
    return batched_nms_shared(boxes, scores, max_out=max_out,
                              score_thresh=score_thresh,
                              iou_thresh=iou_thresh)


def flatten_feature_maps(feature_maps: Sequence[torch.Tensor],
                         num_classes: int) -> torch.Tensor:
    """[N, Hg, Wg, 3*(5+C)] x3 -> [N, A, 5+C] raw rows, predict_boxes
    order."""
    return torch.cat([f.reshape(f.shape[0], -1, 5 + num_classes)
                      for f in feature_maps], dim=1)


def prefilter_candidates(feature_maps: Sequence[torch.Tensor],
                         num_classes: int, tables: torch.Tensor,
                         box_topk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The prefilter's selection and decode: the folded forward's raw maps
    -> (boxes [B, K, 4] xyxy in input pixels, scores [B, K, C]), both fp32,
    for the K = min(box_topk, A) best anchors of each image (ties to the
    lower anchor index). Unlike the exact path's decode, the box sizes are
    exp(tw) with no clamp, as in the JAX prefilter."""
    c = num_classes
    raw = flatten_feature_maps(feature_maps, c)                 # [B, A, 5+C]
    k_box = min(box_topk, raw.shape[1])

    obj = torch.sigmoid(raw[..., 4].float()) * torch.sigmoid(
        raw[..., 5:5 + c].amax(dim=-1).float())
    cand = torch.sort(obj, dim=1, descending=True, stable=True).indices
    cand = cand[:, :k_box]
    rows = raw.float().gather(1, cand[..., None].expand(-1, -1, 5 + c))

    gx, gy, grw, grh, gaw, gah = tables[:, cand]                # [B, K] each
    cx = (torch.sigmoid(rows[..., 0]) + gx) * grw
    cy = (torch.sigmoid(rows[..., 1]) + gy) * grh
    w = torch.exp(rows[..., 2]) * gaw
    h = torch.exp(rows[..., 3]) * gah
    boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                        dim=-1)
    scores = torch.sigmoid(rows[..., 4:5]) * torch.sigmoid(rows[..., 5:5 + c])
    return boxes, scores


def postprocess_prefilter(feature_maps: Sequence[torch.Tensor],
                          anchors: np.ndarray, num_classes: int,
                          img_size: Tuple[int, int], *,
                          max_out: int = 50, box_topk: int = 256,
                          pre_topk: int = 128, score_thresh: float = 0.3,
                          iou_thresh: float = 0.45,
                          tables: Optional[torch.Tensor] = None
                          ) -> Dict[str, torch.Tensor]:
    """Batched detection from the folded forward's raw feature maps through
    the objectness prefilter (see the module docstring and
    `prefilter_candidates`).

    Returns dict of [B, C*max_out, ...], the `ops.postprocess` contract.
    `tables` is `decode_tables(img_size, anchors)` on the maps' device, built
    here when not given. The NMS follows the JAX package's routes: on CUDA
    tensors the shared-candidate kernel over all K candidates (rows in
    candidate order when max_out >= K), on CPU tensors the plain per-class
    `batched_nms` over each class's min(pre_topk, K) best.
    """
    device = feature_maps[0].device
    if tables is None:
        tables = decode_tables(img_size, anchors, device=device)
    boxes, scores = prefilter_candidates(feature_maps, num_classes, tables,
                                         box_topk)
    k_box = boxes.shape[1]

    if device.type == "cuda":
        return batched_nms_shared(boxes, scores, max_out=max_out,
                                  score_thresh=score_thresh,
                                  iou_thresh=iou_thresh)
    return batched_nms(boxes, scores, max_out=max_out,
                       pre_topk=min(pre_topk, k_box),
                       score_thresh=score_thresh, iou_thresh=iou_thresh)
