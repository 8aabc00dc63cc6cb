"""Candidate-prefilter postprocess: the packed and split serving heads,
and the prefilter over the folded forward's feature maps.

Counterpart of `yolov3_tensorflow_tpu/ops/fast_postprocess.py`. Every path
scores each anchor by sigmoid(conf) * sigmoid(max class logit), takes the
exact top K per image, decodes only those candidates from flat per-anchor
tables, and runs per-class NMS over the K candidates.

Packed head: each scale's single 1x1 detection conv emits 3 anchor blocks
of `row` (=128) channels, laid out as

    [0:C)      class logits
    [C]        objectness logit
    [C+1:C+5)  box logits tx, ty, tw, th
    [C+5:row)  padding, bias -30 (sigmoid ~ 0)

so [B, Hg, Wg, 3*row] -> [B, Hg*Wg*3, row] is a free view whose index is
the global anchor index (scale-major, then y, x, anchor).

Split head (`split_serving_head`): each detection conv becomes two, the
same matmul split along its output channels: `boxconf`, 15 fp32 channels
(per anchor a: a*5+0..3 box logits, a*5+4 the objectness logit), and
`cls`, 3 anchor blocks of `row` class logits (pad classes at bias -30) in
`cls_dtype`. `postprocess_split` reads both in their native cell layout
[B, Hg*Wg, channels] and fetches candidate rows by cell and anchor block.
Its selection max runs over the whole class block, pad lanes included,
as JAX's does.

Prefilter (`postprocess_prefilter`): the same selection over the plain
[B, Hg, Wg, 3*(5+C)] maps of `models.yolov3.yolov3_forward_folded`, or
over the aligned head's [B, Hg, Wg, 3*row] (`pad_output_convs_aligned`).
It equals the exact path (`ops.postprocess.postprocess`) whenever every box
that passes the score threshold in any class ranks in the top box_topk,
which holds when no more than box_topk boxes pass.

The JAX package's TPU-only knobs are taken and mean here what they compute
off the TPU. `approx_topk=True` selects by `lax.approx_max_k`, which XLA
computes on any backend but the TPU as a full sort: the exact top-k
values, equal values in no fixed order (an unstable sort). The port takes
the exact top-k, ties to the lower index, for either value. `cell_major`
changes how the JAX packed path reads its rows, not which rows; in
PyTorch the per-anchor view is free, so both values take the one gather.
The one-hot MXU gather and padding K to a multiple of 8 (a TPU sublane
rule; the CUDA kernel takes any K <= 1024) have no counterpart.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from yolov3_tensorflow_tpu_torch.models.layers import conv2d
from yolov3_tensorflow_tpu_torch.models.yolov3 import (DETECTION_CONVS,
                                                       folded_body)
from yolov3_tensorflow_tpu_torch.ops.conv_epilogue import conv_epilogue
from yolov3_tensorflow_tpu_torch.ops.nms import batched_nms
from yolov3_tensorflow_tpu_torch.ops.nms_cuda import batched_nms_shared

_LANE = 128


@functools.lru_cache(maxsize=32)
def _decode_tables(img_h: int, img_w: int, anchors_key: Tuple[float, ...],
                   scale_key: Tuple[float, ...]) -> Tuple[np.ndarray, ...]:
    """Flat per-anchor decode constants in global anchor order
    (scale 32 -> 16 -> 8, anchors 6-8, 3-5, 0-2; row-major y, x, anchor
    within each scale): grid x and grid y, each shifted by -(s - 1) / 2,
    stride x, stride y, anchor w, anchor h, and s, with s each scale's
    scale_x_y (`scale_key`, strides 32, 16, 8; darknet's grid
    sensitivity). At s = 1 the shift is -0 and the grid rows are exact."""
    anchors = np.asarray(anchors_key, np.float32).reshape(9, 2)
    groups = [anchors[6:9], anchors[3:6], anchors[0:3]]
    xs, ys, rws, rhs, aws, ahs, ss = [], [], [], [], [], [], []
    for i, (stride, group) in enumerate(zip((32, 16, 8), groups)):
        hg, wg = img_h // stride, img_w // stride
        yy, xx = np.mgrid[0:hg, 0:wg]
        s = np.float32(scale_key[i])
        shift = np.float32(-0.5) * (s - 1)
        for arr, val in ((xs, np.repeat(xx[..., None], 3, -1)),
                         (ys, np.repeat(yy[..., None], 3, -1))):
            arr.append(val.reshape(-1).astype(np.float32) + shift)
        n = hg * wg * 3
        rws.append(np.full(n, img_w / wg, np.float32))
        rhs.append(np.full(n, img_h / hg, np.float32))
        aws.append(np.tile(group[:, 0], hg * wg).astype(np.float32))
        ahs.append(np.tile(group[:, 1], hg * wg).astype(np.float32))
        ss.append(np.full(n, s, np.float32))
    return tuple(np.concatenate(v) for v in (xs, ys, rws, rhs, aws, ahs, ss))


def decode_tables(img_size: Tuple[int, int], anchors: np.ndarray, *,
                  device: torch.device,
                  scale_x_y: Sequence[float] = (1.0, 1.0, 1.0)
                  ) -> torch.Tensor:
    """`_decode_tables` stacked into one [7, A] fp32 tensor on `device`,
    with each scale's `scale_x_y` (strides 32, 16, 8; YOLOv3's are 1,
    where the centre comes out bit for bit as sigmoid(t) + cell)."""
    tabs = _decode_tables(int(img_size[0]), int(img_size[1]),
                          tuple(np.asarray(anchors, np.float32)
                                .reshape(-1).tolist()),
                          tuple(float(s) for s in scale_x_y))
    return torch.from_numpy(np.stack(tabs)).to(device)


def head_row_width(num_classes: int) -> int:
    """Per-anchor channel block, padded to a multiple of 128."""
    need = 5 + num_classes
    return ((need + _LANE - 1) // _LANE) * _LANE


def top_candidates(obj: torch.Tensor, k: int) -> torch.Tensor:
    """Indices [B, k] of the k largest scores of each row of obj [B, A],
    ties to the lower index (a stable sort), as JAX's lax.top_k orders
    them (its approx_max_k, off the TPU, gives the same values with ties
    in no fixed order)."""
    return torch.sort(obj, dim=1, descending=True, stable=True).indices[:, :k]


def _score_dtype(score_dtype) -> torch.dtype:
    """JAX's `score_dtype` argument: None is fp32, "bf16" bfloat16."""
    if score_dtype is None:
        return torch.float32
    if score_dtype in ("bf16", torch.bfloat16):
        return torch.bfloat16
    return score_dtype


def _score_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """sigmoid for the selection score. fp32: `torch.sigmoid`. Below fp32
    the JAX package's value: XLA expands the logistic as
    1 / (1 + exp(-x)) and rounds each step to x's dtype, which differs
    from a correctly rounded bf16 sigmoid on ~1.7% of bf16 inputs (near
    0.5: sigmoid(-0.0039) is 0.5 there, 0.498 rounded once)."""
    if x.dtype == torch.float32:
        return torch.sigmoid(x)
    return 1.0 / (1.0 + torch.exp(-x))


def _decode(rows_box: torch.Tensor, cand: torch.Tensor, tables: torch.Tensor
            ) -> torch.Tensor:
    """Candidate box logits [B, K, 4] (tx ty tw th, fp32) at global anchor
    indices cand [B, K] -> xyxy boxes [B, K, 4] in input pixels, through
    the flat decode tables (exp(tw) unclamped, as the JAX fast paths).
    The centre is darknet's yolo layer's: (sigmoid(t) * s - (s - 1) / 2 +
    cell) * stride, with s the scale's scale_x_y, in YOLOv3's three
    kernels a coordinate (at s = 1, (sigmoid(t) + cell) * stride)."""
    gx, gy, grw, grh, gaw, gah, scale = tables[:, cand]         # [B, K] each
    cx = torch.addcmul(gx, torch.sigmoid(rows_box[..., 0]), scale) * grw
    cy = torch.addcmul(gy, torch.sigmoid(rows_box[..., 1]), scale) * grh
    w = torch.exp(rows_box[..., 2]) * gaw
    h = torch.exp(rows_box[..., 3]) * gah
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                       dim=-1)


# ---------------------------------------------------------------------------
# Lane-aligned head (the plain layout, each anchor block padded to `row`)
# ---------------------------------------------------------------------------

def pad_output_convs_aligned(head_params: dict, num_classes: int) -> dict:
    """Pad the 3 detection convs of a folded head (`folded["head"]`) from
    3*(5+C) to 3*row output channels: each anchor's (5+C) block starts at
    a multiple of row, zero weights and bias elsewhere (JAX
    `pad_output_convs_aligned`). The folded forward then emits
    [N, Hg, Wg, 3*row] maps for `postprocess_prefilter(aligned_head=True)`.
    The kernels keep their dtype, the biases are fp32."""
    row = head_row_width(num_classes)
    need = 5 + num_classes
    out = dict(head_params)
    for name in DETECTION_CONVS:
        p = head_params[name]
        w, b = p["w"].float(), p["b"].float()         # [3*need, cin, 1, 1]
        w2 = w.new_zeros((3 * row,) + tuple(w.shape[1:]))
        b2 = b.new_zeros(3 * row)
        for a in range(3):
            w2[a * row:a * row + need] = w[a * need:(a + 1) * need]
            b2[a * row:a * row + need] = b[a * need:(a + 1) * need]
        out[name] = {"w": w2.to(p["w"].dtype), "b": b2}
    return out


def flatten_feature_maps_aligned(feature_maps: Sequence[torch.Tensor],
                                 num_classes: int) -> torch.Tensor:
    """Aligned-head maps [N, Hg, Wg, 3*row] x3 -> [N, A, row] rows,
    predict_boxes order."""
    row = head_row_width(num_classes)
    return torch.cat([f.reshape(f.shape[0], -1, row) for f in feature_maps],
                     dim=1)


# ---------------------------------------------------------------------------
# Split head: boxconf + lane-aligned class convs
# ---------------------------------------------------------------------------

def split_serving_head(folded: dict, num_classes: int,
                       cls_dtype: torch.dtype = torch.bfloat16) -> dict:
    """Rewrite the folded detection convs (head conv_6/14/22) for
    `yolov3_forward_split` (JAX `split_serving_head`): each becomes
    {"boxconf": {w [15, cin, 1, 1], b [15] fp32}, "cls": {w [3*row, cin,
    1, 1], b [3*row] cls_dtype}}, boxconf anchor-major (a*5+0..3 box
    logits, a*5+4 conf), cls one row-wide block of class logits per
    anchor, pad classes at bias -30 (sigmoid ~ 0). The kernels keep their
    dtype. Takes a folded or a quantized tree (whose detection convs are
    plain {w, b}); the other convs are shared, not copied."""
    row = head_row_width(num_classes)
    need = 5 + num_classes
    out = {scope: dict(v) for scope, v in folded.items()}
    for name in DETECTION_CONVS:
        p = folded["head"][name]
        w, b = p["w"].float(), p["b"].float()         # [3*need, cin, 1, 1]
        wbc = w.new_zeros((15,) + tuple(w.shape[1:]))
        bbc = b.new_zeros(15)
        wcl = w.new_zeros((3 * row,) + tuple(w.shape[1:]))
        bcl = torch.full((3 * row,), -30.0, device=b.device)   # pad ~ 0
        for a in range(3):
            src = a * need
            wbc[a * 5:a * 5 + 5] = w[src:src + 5]
            bbc[a * 5:a * 5 + 5] = b[src:src + 5]
            wcl[a * row:a * row + num_classes] = w[src + 5:src + need]
            bcl[a * row:a * row + num_classes] = b[src + 5:src + need]
        out["head"][name] = {
            "boxconf": {"w": wbc.to(p["w"].dtype), "b": bbc},
            "cls": {"w": wcl.to(p["w"].dtype), "b": bcl.to(cls_dtype)}}
    return out


def apply_split_output_conv(p: dict, x: torch.Tensor, *,
                            compute_dtype: torch.dtype = torch.bfloat16,
                            cls_dtype: torch.dtype = torch.bfloat16
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One split detection conv (see `split_serving_head`) on NCHW x.
    Returns (boxconf [N, 15, Hg, Wg] fp32, cls [N, 3*row, Hg, Wg]
    cls_dtype), rounded in JAX's order: boxconf's conv output cast to fp32
    before its fp32 bias is added, cls's bias cast to the conv's dtype and
    added before the cast to cls_dtype. Shared by the bf16 and int8
    forwards."""
    bc = conv2d(x, p["boxconf"]["w"], compute_dtype=compute_dtype)
    bc = bc.float() + p["boxconf"]["b"].view(1, -1, 1, 1)
    cl = conv2d(x, p["cls"]["w"], compute_dtype=compute_dtype)
    cl = conv_epilogue(cl, p["cls"]["b"], leaky=False).to(cls_dtype)
    return bc, cl


def yolov3_forward_split(split: dict, images: torch.Tensor, *,
                         compute_dtype: torch.dtype = torch.bfloat16,
                         stem_s2d: bool = False,
                         cls_dtype: torch.dtype = torch.bfloat16
                         ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Forward pass emitting split head outputs: 3 (boxconf, cls) pairs,
    strides (32, 16, 8), boxconf [N, Hg, Wg, 15] fp32 and cls [N, Hg, Wg,
    3*row] cls_dtype (NHWC views). Params come from `split_serving_head`
    (and `models.yolov3.space_to_depth_stem` when stem_s2d=True)."""

    def out_split(i, x):
        return apply_split_output_conv(
            split["head"][f"conv_{i}"], x, compute_dtype=compute_dtype,
            cls_dtype=cls_dtype)

    return folded_body(split, images, out_split, compute_dtype=compute_dtype,
                       stem_s2d=stem_s2d)


def _select_anchor_block(rows: torch.Tensor, a_l: torch.Tensor, block: int,
                         nblocks: int) -> torch.Tensor:
    """rows [B, K, nblocks*block] -> [B, K, block], each row's block a_l
    [B, K]: static slices and selects."""
    out = None
    for a in range(nblocks):
        blk = rows[..., a * block:(a + 1) * block]
        out = blk if out is None else torch.where((a_l == a)[..., None], blk,
                                                  out)
    return out


def _gather_cells_per_scale(cell_ops: Sequence[torch.Tensor],
                            cand: torch.Tensor, offsets: Sequence[int],
                            cells: Sequence[int], block: int) -> torch.Tensor:
    """Per-anchor blocks [B, K, block] by global anchor index cand [B, K]
    from per-scale cell operands [B, Hg*Wg, 3*block] (the conv output's
    own layout, a free view): each candidate's cell row, then its anchor's
    block, from the scale it falls in."""
    out = None
    for op, off, nc in zip(cell_ops, offsets, cells):
        local = (cand - off).clamp(0, nc * 3 - 1)
        g = op.gather(1, (local // 3)[..., None].expand(-1, -1, op.shape[2]))
        g = _select_anchor_block(g, local % 3, block, 3)
        in_scale = ((cand >= off) & (cand < off + nc * 3))[..., None]
        out = g if out is None else torch.where(in_scale, g, out)
    return out


def split_candidates(split_outs, num_classes: int, tables: torch.Tensor,
                     box_topk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prefilter and decode: split head outputs -> (boxes [B, K, 4] xyxy in
    input pixels, scores [B, K, C] = conf * class prob), both fp32, for the
    K = min(box_topk, A) best anchors of each image, ties to the lower
    anchor index.

    The selection score is sigmoid(conf) * sigmoid(max over the anchor's
    whole class block), pad lanes (bias -30) included, as JAX computes it:
    unlike the packed path's, this max is not masked to the class lanes.
    """
    row = head_row_width(num_classes)
    bc_cells, cls_cells, objs, offsets, cells = [], [], [], [], []
    off = 0
    for bc, cl in split_outs:
        b, hg, wg, _ = bc.shape
        nc = hg * wg
        bcc = bc.reshape(b, nc, 15)                         # free views
        clc = cl.reshape(b, nc, 3 * row)
        cmax = clc.view(b, nc, 3, row).amax(dim=-1).float()  # [B, nc, 3]
        obj = torch.sigmoid(bcc[..., 4::5]) * torch.sigmoid(cmax)
        objs.append(obj.reshape(b, nc * 3))
        bc_cells.append(bcc)
        cls_cells.append(clc)
        offsets.append(off)
        cells.append(nc)
        off += nc * 3
    cand = top_candidates(torch.cat(objs, dim=1), min(box_topk, off))

    bc_rows = _gather_cells_per_scale(bc_cells, cand, offsets, cells, 5)
    cls_rows = _gather_cells_per_scale(cls_cells, cand, offsets, cells, row)
    boxes = _decode(bc_rows[..., :4], cand, tables)
    scores = torch.sigmoid(bc_rows[..., 4:5]) * torch.sigmoid(
        cls_rows[..., :num_classes].float())
    return boxes, scores


def postprocess_split(split_outs, anchors: np.ndarray, num_classes: int,
                      img_size: Tuple[int, int], *, max_out: int = 50,
                      box_topk: int = 128, score_thresh: float = 0.3,
                      iou_thresh: float = 0.45, approx_topk: bool = True,
                      tables: Optional[torch.Tensor] = None
                      ) -> Dict[str, torch.Tensor]:
    """Batched detection from split head outputs (`yolov3_forward_split`):
    the prefilter's math over the split layout (`split_candidates`), then
    the shared-candidate NMS: on CUDA tensors the hand-written kernel, on
    CPU tensors its plain version, so both order rows alike (candidate
    order when max_out >= K). Returns dict of [B, C*max_out, ...], the
    `ops.postprocess` contract. `tables` is `decode_tables(img_size,
    anchors)` on the outputs' device, built here when not given.
    approx_topk is JAX's argument; either value takes the exact top-k (see
    the module docstring)."""
    if tables is None:
        tables = decode_tables(img_size, anchors,
                               device=split_outs[0][0].device)
    boxes, scores = split_candidates(split_outs, num_classes, tables,
                                     box_topk)
    return batched_nms_shared(boxes, scores, max_out=max_out,
                              score_thresh=score_thresh,
                              iou_thresh=iou_thresh)


# ---------------------------------------------------------------------------
# Packed head
# ---------------------------------------------------------------------------

def pack_serving_head(folded: dict, num_classes: int,
                      out_dtype: torch.dtype = torch.bfloat16,
                      names: Sequence[str] = DETECTION_CONVS) -> dict:
    """Rewrite the folded detection convs `names` of the head (YOLOv3's
    conv_6/14/22 by default; `models.yolov4.DETECTION_CONVS` for YOLOv4)
    for the packed forwards: each becomes {"packed": {w [3*row, cin, 1,
    1], b [3*row] out_dtype}} with the block layout in the module
    docstring. The kernel keeps its dtype; the bias is rounded to
    `out_dtype` here, as the JAX package does."""
    row = head_row_width(num_classes)
    need = 5 + num_classes
    out = {scope: dict(v) for scope, v in folded.items()}
    for name in names:
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
    in the conv's dtype (`ops.conv_epilogue`, in place on the card)."""
    y = conv2d(x, p["packed"]["w"], compute_dtype=compute_dtype)
    return conv_epilogue(y, p["packed"]["b"], leaky=False).to(out_dtype)


def yolov3_forward_packed(packed: dict, images: torch.Tensor, *,
                          compute_dtype: torch.dtype = torch.bfloat16,
                          stem_s2d: bool = False,
                          out_dtype: torch.dtype = torch.bfloat16
                          ) -> List[torch.Tensor]:
    """Forward pass emitting packed head outputs: 3 tensors [N, Hg, Wg,
    3*row] in `out_dtype`, strides (32, 16, 8). images: [N, H, W, 3] float.
    Params come from `pack_serving_head` (and `models.yolov3.
    space_to_depth_stem` when stem_s2d=True). (The JAX `_serving_body` is
    `models.yolov3.folded_body` here.)"""

    def out_packed(i, x):
        return apply_packed_output_conv(
            packed["head"][f"conv_{i}"], x, compute_dtype=compute_dtype,
            out_dtype=out_dtype)

    return folded_body(packed, images, out_packed, compute_dtype=compute_dtype,
                       stem_s2d=stem_s2d)


def packed_scores(packed_outs: Sequence[torch.Tensor], num_classes: int,
                  score_dtype=None) -> torch.Tensor:
    """The packed path's selection score [B, A] of every anchor, in global
    anchor order: sigmoid(conf) * sigmoid(max over the class lanes [0, C)),
    so conf/box/padding lanes never inflate a candidate's rank, computed in
    `score_dtype` (fp32 by default; "bf16" as JAX's `score_dtype`)."""
    c = num_classes
    row = head_row_width(c)
    sdt = _score_dtype(score_dtype)
    objs = []
    for p in packed_outs:
        b, hg, wg, _ = p.shape
        pr = p.reshape(b, hg * wg * 3, row)
        objs.append(_score_sigmoid(pr[..., c].to(sdt)) * _score_sigmoid(
            pr[..., :c].amax(dim=-1).to(sdt)))
    return torch.cat(objs, dim=1)


def packed_decode(packed_outs: Sequence[torch.Tensor], cand: torch.Tensor,
                  num_classes: int, tables: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The rows of the candidates at global anchor indices cand [B, K],
    gathered from the packed head outputs and decoded -> (boxes [B, K, 4]
    xyxy in input pixels, scores [B, K, C] = conf * class prob), both
    fp32."""
    c = num_classes
    row = head_row_width(c)
    rows = None
    ofs = 0
    for p in packed_outs:
        b, hg, wg, _ = p.shape
        pr = p.reshape(b, hg * wg * 3, row)
        na = pr.shape[1]
        local = (cand - ofs).clamp(0, na - 1)
        g = pr.gather(1, local[..., None].expand(-1, -1, row))  # [B, K, row]
        in_scale = ((cand >= ofs) & (cand < ofs + na))[..., None]
        rows = g if rows is None else torch.where(in_scale, g, rows)
        ofs += na

    boxes = _decode(rows[..., c + 1:c + 5].float(), cand, tables)
    conf = torch.sigmoid(rows[..., c:c + 1].float())
    scores = conf * torch.sigmoid(rows[..., :c].float())
    return boxes, scores


def packed_candidates(packed_outs: Sequence[torch.Tensor], num_classes: int,
                      tables: torch.Tensor, box_topk: int,
                      score_dtype=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prefilter and decode: packed head outputs -> (boxes [B, K, 4] xyxy in
    input pixels, scores [B, K, C] = conf * class prob), both fp32, for the
    K = min(box_topk, A) best anchors of each image: `packed_scores` (in
    `score_dtype`; the scores returned stay fp32), `top_candidates` (ties
    to the lower anchor index), `packed_decode`.
    """
    obj = packed_scores(packed_outs, num_classes, score_dtype)
    cand = top_candidates(obj, min(box_topk, obj.shape[1]))
    return packed_decode(packed_outs, cand, num_classes, tables)


def postprocess_packed(packed_outs: Sequence[torch.Tensor],
                       anchors: np.ndarray, num_classes: int,
                       img_size: Tuple[int, int], *,
                       max_out: int = 128, box_topk: int = 128,
                       score_thresh: float = 0.3, iou_thresh: float = 0.45,
                       approx_topk: bool = True, cell_major: bool = True,
                       score_dtype=None,
                       tables: Optional[torch.Tensor] = None
                       ) -> Dict[str, torch.Tensor]:
    """Batched detection from packed head outputs (`yolov3_forward_packed`).

    Returns dict of [B, C*max_out, ...]: "boxes" (xyxy, input pixels),
    "scores", "labels", "valid" — the JAX package's contract. `tables` is
    `decode_tables(img_size, anchors)` on the outputs' device; a detector
    passes the copy it made once, otherwise it is built here. On CUDA
    tensors the NMS runs in the hand-written kernel. score_dtype ranks
    the candidates in that dtype (`packed_candidates`); approx_topk and
    cell_major are JAX's arguments, and either value of each gives the
    same detections (the module docstring says why).
    """
    if tables is None:
        tables = decode_tables(img_size, anchors, device=packed_outs[0].device)
    boxes, scores = packed_candidates(packed_outs, num_classes, tables,
                                      box_topk, score_dtype=score_dtype)
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
                         box_topk: int, aligned_head: bool = False
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The prefilter's selection and decode: the folded forward's raw maps
    -> (boxes [B, K, 4] xyxy in input pixels, scores [B, K, C]), both fp32,
    for the K = min(box_topk, A) best anchors of each image (ties to the
    lower anchor index). aligned_head=True reads the aligned head's maps
    (`pad_output_convs_aligned`: rows of `row` channels, the first 5+C
    used). Unlike the exact path's decode, the box sizes are exp(tw) with
    no clamp, as in the JAX prefilter."""
    c = num_classes
    if aligned_head:
        raw = flatten_feature_maps_aligned(feature_maps, c)[..., :5 + c]
    else:
        raw = flatten_feature_maps(feature_maps, c)             # [B, A, 5+C]
    obj = torch.sigmoid(raw[..., 4].float()) * torch.sigmoid(
        raw[..., 5:5 + c].amax(dim=-1).float())
    cand = top_candidates(obj, min(box_topk, raw.shape[1]))
    rows = raw.float().gather(1, cand[..., None].expand(-1, -1, 5 + c))
    boxes = _decode(rows[..., :4], cand, tables)
    scores = torch.sigmoid(rows[..., 4:5]) * torch.sigmoid(rows[..., 5:5 + c])
    return boxes, scores


def postprocess_prefilter(feature_maps: Sequence[torch.Tensor],
                          anchors: np.ndarray, num_classes: int,
                          img_size: Tuple[int, int], *,
                          max_out: int = 50, box_topk: int = 256,
                          pre_topk: int = 128, score_thresh: float = 0.3,
                          iou_thresh: float = 0.45,
                          aligned_head: bool = False,
                          approx_topk: bool = False,
                          tables: Optional[torch.Tensor] = None
                          ) -> Dict[str, torch.Tensor]:
    """Batched detection from the folded forward's raw feature maps through
    the objectness prefilter (see the module docstring and
    `prefilter_candidates`; aligned_head=True for the aligned head's maps,
    approx_topk as in `postprocess_packed`).

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
                                         box_topk, aligned_head=aligned_head)
    k_box = boxes.shape[1]

    if device.type == "cuda":
        return batched_nms_shared(boxes, scores, max_out=max_out,
                                  score_thresh=score_thresh,
                                  iou_thresh=iou_thresh)
    return batched_nms(boxes, scores, max_out=max_out,
                       pre_topk=min(pre_topk, k_box),
                       score_thresh=score_thresh, iou_thresh=iou_thresh)
