"""Post-training int8 quantization for inference serving.

Counterpart of `yolov3_tensorflow_tpu/ops/quantize.py`, with its names,
trees and arithmetic:

- weights: per-output-channel symmetric int8 scales of the BN-folded fp32
  kernels, computed on the host in numpy exactly as the JAX package does;
- activations: per-tensor scales from a calibration pass (bf16 fold, the
  literal FPN junctions) that records each conv input's abs-max;
- execution: each int8 conv is an integer GEMM over patches
  (`ops.int8_conv`: `torch._int_mm`, cuBLASLt on the card), followed by
  the epilogue `acc * eff + b` -> LeakyReLU(0.1) in fp32 -> bf16.

Three forwards share the weights:

- `yolov3_forward_int8` / `_int8_packed` / `_int8_split`: bf16
  activations between layers; each conv quantizes its input (the images
  are cast to bf16 first);
- `yolov3_forward_int8_chained`: int8 activations between layers, each at
  its consumer's calibrated scale; residual adds in the closing conv's
  epilogue; the FPN concats replaced by two GEMMs summed in the epilogue
  (`_concat_split_conv`); the fp32 images quantized directly;
- `yolov3_forward_stem_int8_packed`: conv_0..conv_{upto-1} int8-chained,
  the rest the bf16 packed forward (split-neck junctions).

The three detection output convs stay bf16. Python scales are carried as
float32 values and every product with one is a float32 product, as JAX
computes it: `_scale_of` is a float64, and `_requant` multiplies by the
float64 reciprocal taken to float32 (no division on the device: CUDA
divides by a scalar through its reciprocal).

`build_detector_int8` has no `approx_topk`: off the TPU JAX's
approx_max_k is a full sort, and the port's postprocesses take the exact
top-k (ops.fast_postprocess).

Tensors are NCHW in channels_last memory inside the forwards, as in
`models.layers`; the public forwards take NHWC images and return NHWC
maps. Quantized trees hold, per int8 conv, "w8" (int8 OHWI [cout, k, k,
cin]: JAX's HWIO kernel with the output axis first) and "wt" (its GEMM
operand, `int8_conv.gemm_weight`).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from yolov3_tensorflow_tpu_torch.models.layers import (conv_bias,
                                                       conv_folded,
                                                       leaky_relu,
                                                       neck_split_folded,
                                                       upsample_nearest_2x)
from yolov3_tensorflow_tpu_torch.models.yolov3 import (BACKBONE_PLAN,
                                                       DETECTION_CONVS,
                                                       _backbone_forward,
                                                       _head_forward,
                                                       channels_last_weights,
                                                       fold_batch_norm, nhwc)
from yolov3_tensorflow_tpu_torch.ops import int8_conv as I8
from yolov3_tensorflow_tpu_torch.ops.fast_postprocess import (
    apply_packed_output_conv, apply_split_output_conv, decode_tables,
    pack_serving_head, postprocess_packed, postprocess_prefilter)

Params = Dict[str, Any]
CPU = torch.device("cpu")


def _tree_to(tree, device: torch.device):
    return {k: _tree_to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def _device_of(variables: Params) -> torch.device:
    return variables["params"]["backbone"]["conv_0"]["w"].device


def _f32(x: float) -> float:
    """A Python number rounded to float32 (JAX's weak-typed scalar in a
    float32 operation), as a Python float that holds it exactly."""
    return float(np.float32(x))


def _nchw(y: torch.Tensor) -> torch.Tensor:
    """NHWC result -> the NCHW (channels_last) view the forwards carry."""
    return y.permute(0, 3, 1, 2)


# ---------------------------------------------------------------------------
# Calibration
# ---------------------------------------------------------------------------

@torch.inference_mode()
def calibrate_activation_scales(variables: Params, images,
                                compute_dtype: torch.dtype = torch.bfloat16
                                ) -> Params:
    """Record per-conv-input abs-max over a calibration batch.

    images: [N, H, W, 3] float in [0, 1] (numpy or tensor), run on the
    variables' device. Returns {scope: {conv_name: abs-max as a Python
    float}}, the detection output convs included (observed, unused). The
    forward is the BN-folded one in `compute_dtype` with the literal FPN
    junctions, so `head/conv_8` and `head/conv_16` observe the concat."""
    device = _device_of(variables)
    folded = channels_last_weights(fold_batch_norm(variables,
                                                   dtype=compute_dtype))
    maxes: Params = {"backbone": {}, "head": {}}

    def observe(scope, idx, x):
        m = x.float().abs().amax()
        prev = maxes[scope].get(f"conv_{idx}")
        maxes[scope][f"conv_{idx}"] = m if prev is None else \
            torch.maximum(prev, m)

    def bn_conv(scope, idx, x, stride=1):
        observe(scope, idx, x)
        return conv_folded(x, folded[scope][f"conv_{idx}"], stride=stride,
                           compute_dtype=compute_dtype)

    images = torch.as_tensor(images, device=device)
    x = images.permute(0, 3, 1, 2).to(compute_dtype)
    routes = _backbone_forward(lambda i, x, s: bn_conv("backbone", i, x, s),
                               x)
    # the output convs' results are unused: observe their inputs only
    _head_forward(lambda i, x: bn_conv("head", i, x),
                  lambda i, x: observe("head", i, x), routes)
    names = [(scope, name) for scope in maxes for name in maxes[scope]]
    values = torch.stack([maxes[s][n] for s, n in names]).tolist()
    out: Params = {"backbone": {}, "head": {}}
    for (scope, name), v in zip(names, values):
        out[scope][name] = v
    return out


# ---------------------------------------------------------------------------
# Quantization
# ---------------------------------------------------------------------------

def _quantize_kernel(w: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """fp32 OIHW kernel -> (int8 OHWI kernel, per-output-channel fp32
    scale), the JAX package's numpy arithmetic."""
    w_absmax = np.maximum(np.abs(w).max(axis=(1, 2, 3)), 1e-12)
    w_scale = w_absmax / 127.0                              # [co]
    w8 = np.clip(np.round(w / w_scale[:, None, None, None]), -127, 127
                 ).astype(np.int8)
    return np.ascontiguousarray(w8.transpose(0, 2, 3, 1)), w_scale


def _quantize_tree(variables: Params, int8_entry) -> Params:
    """Fold BN in fp32 on the host and int8-quantize every conv but the
    detection output convs, which keep {"w" bf16, "b" fp32}. Each int8
    conv's entry is {"w8", "wt", "b"} plus what `int8_entry(scope, name,
    w_scale)` returns (numpy arrays become tensors). Everything lands on
    the variables' device."""
    device = _device_of(variables)
    folded = fold_batch_norm(_tree_to(variables, CPU), dtype=torch.float32)
    q: Params = {}
    for scope, convs in folded.items():
        q[scope] = {}
        for name, p in convs.items():
            if scope == "head" and name in DETECTION_CONVS:
                q[scope][name] = {"w": p["w"].to(device, torch.bfloat16),
                                  "b": p["b"].to(device)}
                continue
            w8, w_scale = _quantize_kernel(p["w"].numpy())
            w8 = torch.from_numpy(w8).to(device)
            entry = int8_entry(scope, name, w_scale)
            q[scope][name] = {"w8": w8, "wt": I8.gemm_weight(w8),
                              "b": p["b"].to(device),
                              **{k: torch.from_numpy(v).to(device)
                                 if isinstance(v, np.ndarray) else v
                                 for k, v in entry.items()}}
    return channels_last_weights(q)


def quantize_model(variables: Params, act_scales: Params) -> Params:
    """BN-fold then int8-quantize every backbone/head conv except the three
    detection output convs.

    Returns qparams: per conv {"w8", "wt", "eff_scale" fp32 [cout]
    (= w_scale * in_scale, the dequant multiplier), "b" fp32 [cout],
    "in_scale" (a float32 value), "inv_scale" (its float32 reciprocal)};
    output convs keep {"w" bf16, "b" fp32}."""

    def entry(scope, name, w_scale):
        in_scale = max(float(act_scales[scope][name]), 1e-12) / 127.0
        s32 = np.float32(in_scale)
        return {"eff_scale": w_scale * in_scale, "in_scale": float(s32),
                "inv_scale": float(np.float32(1.0) / s32)}

    return _quantize_tree(variables, entry)


def _conv_int8(x: torch.Tensor, qp: Params, stride: int) -> torch.Tensor:
    """Quantize input -> int8 conv (int32 accum) -> dequant + bias + leaky
    -> bf16."""
    acc = I8.conv_int8(I8.quantize(x, qp["inv_scale"]), qp["wt"],
                       qp["w8"].shape[1], stride)
    y = acc.float() * qp["eff_scale"] + qp["b"]
    return _nchw(leaky_relu(y).to(torch.bfloat16))


def _int8_body(qparams: Params, images: torch.Tensor, out_fn):
    """The bf16-linked int8 forward with the detection convs applied by
    `out_fn(i, x)`; literal FPN junctions. Returns NHWC maps."""

    def bn_conv(scope, idx, x, stride=1):
        return _conv_int8(x, qparams[scope][f"conv_{idx}"], stride)

    x = images.permute(0, 3, 1, 2).to(torch.bfloat16)
    routes = _backbone_forward(lambda i, x, s: bn_conv("backbone", i, x, s),
                               x)
    fmaps = _head_forward(lambda i, x: bn_conv("head", i, x), out_fn, routes)
    return [nhwc(f) for f in fmaps]


def yolov3_forward_int8(qparams: Params, images: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Quantized inference forward, the `yolov3_forward_folded` contract:
    images [N, H, W, 3] -> 3 fp32 maps [N, H/s, W/s, 3*(5+C)]."""
    return tuple(_int8_body(
        qparams, images,
        lambda i, x: conv_bias(x, qparams["head"][f"conv_{i}"],
                               compute_dtype=torch.bfloat16)))


def yolov3_forward_int8_packed(qparams_packed: Params, images: torch.Tensor):
    """Quantized forward emitting packed head outputs. qparams_packed =
    pack_serving_head(quantize_model(...), C); returns the
    `yolov3_forward_packed` contract, for postprocess_packed."""
    return _int8_body(
        qparams_packed, images,
        lambda i, x: apply_packed_output_conv(
            qparams_packed["head"][f"conv_{i}"], x))


def yolov3_forward_int8_split(qparams_split: Params, images: torch.Tensor):
    """Quantized forward emitting split head outputs. qparams_split =
    split_serving_head(quantize_model(...), C): its bf16 detection convs
    are plain {w, b}, as in a folded tree, so the same rewrite applies.
    Returns the `yolov3_forward_split` contract (bf16 compute and class
    logits), for postprocess_split."""
    return _int8_body(
        qparams_split, images,
        lambda i, x: apply_split_output_conv(
            qparams_split["head"][f"conv_{i}"], x))


# ---------------------------------------------------------------------------
# int8-chained forward: activations stay int8 between layers
# ---------------------------------------------------------------------------
#
# Every activation is int8 at a static scale: a conv's emission scale is
# its consumer conv's calibrated input scale, so a conv consuming (x8, s)
# dequantizes with w_scale * s and no requantization is needed in between.
# Residual adds happen in the closing conv's epilogue in the dequantized
# domain (`_backbone_forward(fused_residual=True)`); the FPN concats are
# replaced by `_concat_split_conv`; conv_5/13/21 emit bf16 for the bf16
# detection convs. One int8 rounding more per activation edge than
# `yolov3_forward_int8`.

def _scale_of(act_scales: Params, scope: str, name: str) -> float:
    return max(float(act_scales[scope][name]), 1e-12) / 127.0


def _requant(y: torch.Tensor, s_out: float) -> torch.Tensor:
    return I8.quantize(y, _f32(1.0 / s_out))


def _conv_int8_chained(x8: torch.Tensor, s_in: float, qp: Params,
                       stride: int, *, shortcut=None,
                       s_out: Optional[float] = None) -> torch.Tensor:
    """int8 conv + dequant/bias/leaky[/residual add][/requant] epilogue.

    x8 int8 at scale s_in; shortcut (t8, st) is added after the activation
    (darknet's residual order); s_out None emits bf16, else int8 at
    s_out."""
    acc = I8.conv_int8(x8, qp["wt"], qp["w8"].shape[1], stride)
    y = acc.float() * (qp["w_scale"] * _f32(s_in)) + qp["b"]
    y = leaky_relu(y)
    if shortcut is not None:
        t8, st = shortcut
        y = y + t8.permute(0, 2, 3, 1).float() * _f32(st)
    if s_out is None:
        return _nchw(y.to(torch.bfloat16))
    return _nchw(_requant(y, s_out))


def quantize_model_chained(variables: Params, act_scales: Params) -> Params:
    """Like quantize_model but each conv keeps its per-channel `w_scale`
    (the chained forward multiplies in its input scale), plus the
    activation-scale table under "act"."""
    q = _quantize_tree(variables, lambda scope, name, w_scale:
                       {"w_scale": w_scale})
    q["act"] = {scope: {name: float(v) for name, v in convs.items()}
                for scope, convs in act_scales.items()}
    return q


def _output_conv(qc: Params, i: int, x: torch.Tensor, head: str):
    p = qc["head"][f"conv_{i}"]
    if head == "packed":
        return apply_packed_output_conv(p, x)
    return conv_bias(x, p, compute_dtype=torch.bfloat16)


def yolov3_forward_int8_chained(qc: Params, images: torch.Tensor,
                                head: str = "packed"):
    """int8-chained inference forward (see the note above).

    qc = pack_serving_head(quantize_model_chained(...), C) for
    head="packed", quantize_model_chained(...) for head="plain". Returns
    the `yolov3_forward_packed` contract ("packed") or the 3 fp32 feature
    maps ("plain"), NHWC."""
    act = qc["act"]

    def s_in_b(idx):
        return _scale_of(act, "backbone", f"conv_{idx}")

    def s_in_h(idx):
        return _scale_of(act, "head", f"conv_{idx}")

    n_backbone = sum(1 for op in BACKBONE_PLAN if op[0] == "conv")

    def backbone_conv(idx, x8, stride, shortcut=None):
        s_out = s_in_b(idx + 1) if idx + 1 < n_backbone else s_in_h(0)
        return _conv_int8_chained(
            x8, s_in_b(idx), qc["backbone"][f"conv_{idx}"], stride,
            shortcut=None if shortcut is None else (shortcut, s_in_b(idx - 1)),
            s_out=s_out)

    x8 = _requant(images.permute(0, 3, 1, 2).float(), s_in_b(0))
    r1_8, r2_8, r3_8 = _backbone_forward(backbone_conv, x8,
                                         fused_residual=True)
    # route tensors carry the scale of the backbone conv that consumes them
    # next: route_1 -> conv_26, route_2 -> conv_43; route_3 is emitted at
    # head conv_0's input scale
    s_r1, s_r2 = s_in_b(26), s_in_b(43)

    def hconv(i, x8, s_in, s_out):
        return _conv_int8_chained(x8, s_in, qc["head"][f"conv_{i}"], 1,
                                  s_out=s_out)

    def branch(x, first, last):
        """head convs first..last-1 int8-chained from x at first's scale;
        returns (x, its scale) at conv `last`'s input."""
        for i in range(first, last):
            x = hconv(i, x, s_in_h(i), s_in_h(i + 1))
        return x, s_in_h(last)

    inter1, s_inter1 = branch(r3_8, 0, 5)             # at conv_5's scale
    fmap_1 = _output_conv(qc, 6, hconv(5, inter1, s_inter1, None), head)

    a8 = upsample_nearest_2x(hconv(7, inter1, s_inter1, s_in_h(8)))
    x = _concat_split_conv(qc["head"]["conv_8"], a8, s_in_h(8), r2_8, s_r2,
                           s_out=s_in_h(9))
    inter2, s_inter2 = branch(x, 9, 13)
    fmap_2 = _output_conv(qc, 14, hconv(13, inter2, s_inter2, None), head)

    a8 = upsample_nearest_2x(hconv(15, inter2, s_inter2, s_in_h(16)))
    x = _concat_split_conv(qc["head"]["conv_16"], a8, s_in_h(16), r1_8,
                           s_r1, s_out=s_in_h(17))
    x, s = branch(x, 17, 21)
    fmap_3 = _output_conv(qc, 22, hconv(21, x, s, None), head)
    return [f.permute(0, 2, 3, 1) for f in (fmap_1, fmap_2, fmap_3)]


def _concat_split_conv(qp: Params, a8: torch.Tensor, sa: float,
                       b8: torch.Tensor, sb: float, *, s_out: float
                       ) -> torch.Tensor:
    """conv(concat([a, b])) of a 1x1 conv as two int8 GEMMs with per-part
    input scales, summed in the epilogue: the concat tensor never exists.
    The kernel is split along its input channels; w_scale (per output
    channel) is shared by both parts."""
    ca = a8.shape[1]
    wt = qp["wt"]
    pa = I8.conv_int8(a8, wt[:, :ca].contiguous(), 1, 1).float()
    pb = I8.conv_int8(b8, wt[:, ca:].contiguous(), 1, 1).float()
    y = (pa * _f32(sa) + pb * _f32(sb)) * qp["w_scale"] + qp["b"]
    return _nchw(_requant(leaky_relu(y), s_out))


# ---------------------------------------------------------------------------
# Hybrid stem-int8 forward: int8-chained early backbone, bf16 rest
# ---------------------------------------------------------------------------
#
# conv_0..conv_{upto-1} run int8-chained (int8 activations halve the wide
# early stages' bytes), and the handoff conv emits bf16 for the bf16 packed
# remainder. The decode and NMS are the packed path's; the only
# approximation is one int8 rounding per early activation edge.

def stem_int8_safe_boundaries() -> Tuple[int, ...]:
    """Backbone conv indices at which the int8 region may hand off to bf16:
    a handoff is safe when the preceding conv is not inside an open
    residual block (the shortcut and its closing conv must share a
    domain)."""
    safe = []
    idx = 0
    depth = 0
    for op in BACKBONE_PLAN:
        if op[0] == "conv":
            if depth == 0:
                safe.append(idx)
            idx += 1
        elif op[0] == "res_begin":
            depth += 1
        elif op[0] == "res_end":
            depth -= 1
            safe.append(idx)
    return tuple(sorted(set(safe + [idx])))


def build_stem_int8_packed(variables: Params, act_scales: Params,
                           num_classes: int, *, upto: int = 9) -> Params:
    """Parameter tree for `yolov3_forward_stem_int8_packed`, on the
    variables' device.

    upto=9 covers the 416^2/208^2/104^2 region (conv_0..conv_8), ending at
    the stride-2 transition into the 52^2 stage. Raises ValueError on an
    `upto` that splits a residual block."""
    if upto not in stem_int8_safe_boundaries():
        raise ValueError(
            f"upto={upto} splits a residual block; safe boundaries: "
            f"{stem_int8_safe_boundaries()}")
    qc = quantize_model_chained(variables, act_scales)
    packed = channels_last_weights(pack_serving_head(
        fold_batch_norm(variables, dtype=torch.bfloat16), num_classes))
    stem = {f"conv_{i}": qc["backbone"][f"conv_{i}"] for i in range(upto)}
    return {"stem": stem, "act": qc["act"], "packed": packed,
            "upto": int(upto)}


def yolov3_forward_stem_int8_packed(hp: Params, images: torch.Tensor):
    """Packed serving forward, int8-chained conv_0..conv_{upto-1}, bf16
    rest. hp = build_stem_int8_packed(...). Returns the
    `yolov3_forward_packed` contract (3 packed logit maps, strides 32, 16,
    8, NHWC)."""
    act, packed, upto = hp["act"], hp["packed"], hp["upto"]

    def s_in_b(idx):
        return _scale_of(act, "backbone", f"conv_{idx}")

    def backbone_conv(idx, x, stride, shortcut=None):
        if idx < upto:
            # int8 at the next conv's calibrated input scale; the handoff
            # conv emits bf16 for the folded region
            s_out = s_in_b(idx + 1) if idx + 1 < upto else None
            return _conv_int8_chained(
                x, s_in_b(idx), hp["stem"][f"conv_{idx}"], stride,
                shortcut=None if shortcut is None
                else (shortcut, s_in_b(idx - 1)),
                s_out=s_out)
        return conv_folded(x, packed["backbone"][f"conv_{idx}"],
                           stride=stride, shortcut=shortcut)

    x = images.permute(0, 3, 1, 2)
    x0 = _requant(x.float(), s_in_b(0)) if upto > 0 else \
        x.to(torch.bfloat16)
    routes = _backbone_forward(backbone_conv, x0, fused_residual=True)
    fmaps = _head_forward(
        lambda i, x: conv_folded(x, packed["head"][f"conv_{i}"]),
        lambda i, x: apply_packed_output_conv(packed["head"][f"conv_{i}"],
                                              x),
        routes,
        lambda li, fi, inter, route: neck_split_folded(
            inter, route, packed["head"][f"conv_{li}"],
            packed["head"][f"conv_{fi}"]))
    return [f.permute(0, 2, 3, 1) for f in fmaps]


# ---------------------------------------------------------------------------
# Detectors
# ---------------------------------------------------------------------------

class QuantizedDetector(nn.Module):
    """An int8, int8-chained or stem-int8 detector: images [B, H, W, 3]
    float in [0, 1] (NHWC, any device) -> detections dict of
    [B, C*max_out, ...] on the detector's device, through
    `forward_fn(params, images)` and the packed or the prefilter
    postprocess (the shared-candidate NMS kernel on the GPU). Runs under
    torch.inference_mode()."""

    def __init__(self, forward_fn, params: Params, tables: torch.Tensor,
                 anchors: np.ndarray, num_classes: int,
                 img_size: Tuple[int, int], *, post: str, max_out: int,
                 box_topk: int, score_thresh: float, iou_thresh: float):
        super().__init__()
        self.forward_fn = forward_fn
        self.params = params
        self.register_buffer("tables", tables)
        self.anchors = np.asarray(anchors, np.float32)
        self.num_classes = num_classes
        self.img_size = (int(img_size[0]), int(img_size[1]))
        self.post = post
        self.max_out = max_out
        self.box_topk = box_topk
        self.score_thresh = score_thresh
        self.iou_thresh = iou_thresh

    @torch.inference_mode()
    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        if tuple(images.shape[1:3]) != self.img_size:
            raise ValueError(f"detector built for {self.img_size}, got "
                             f"images {tuple(images.shape)}")
        images = images.to(self.tables.device, non_blocking=True)
        outs = self.forward_fn(self.params, images)
        kw = dict(max_out=self.max_out, box_topk=self.box_topk,
                  score_thresh=self.score_thresh,
                  iou_thresh=self.iou_thresh, tables=self.tables)
        if self.post == "packed":
            return postprocess_packed(outs, None, self.num_classes,
                                      self.img_size, **kw)
        return postprocess_prefilter(outs, self.anchors, self.num_classes,
                                     self.img_size, pre_topk=self.box_topk,
                                     **kw)


def build_detector_int8(variables: Params, anchors, num_classes: int,
                        img_size: Tuple[int, int], *, calibration_images,
                        device: torch.device, max_out: int = 200,
                        score_thresh: float = 0.3, iou_thresh: float = 0.45,
                        box_topk: int = 128, mode: str = "prefilter"):
    """Calibrate + quantize + build an int8 detector on `device`. Returns
    (detector, qparams).

    Same output contract and mode semantics as ops.postprocess.
    build_detector; modes:
      "prefilter"  bf16-linked int8 forward + prefilter postprocess
      "packed"     packed serving head (the serving configuration)
      "chained"    int8-chained forward (int8 activations end to end) +
                   packed postprocess
    """
    if mode not in ("prefilter", "packed", "chained"):
        raise ValueError(f"unsupported int8 detector mode: {mode!r}")
    variables = _tree_to({k: variables[k] for k in ("params", "batch_stats")},
                         device)
    scales = calibrate_activation_scales(variables, calibration_images)
    if mode == "chained":
        qparams = pack_serving_head(quantize_model_chained(variables, scales),
                                    num_classes)
        forward_fn = yolov3_forward_int8_chained
    elif mode == "packed":
        qparams = pack_serving_head(quantize_model(variables, scales),
                                    num_classes)
        forward_fn = yolov3_forward_int8_packed
    else:
        qparams = quantize_model(variables, scales)
        forward_fn = yolov3_forward_int8
    channels_last_weights(qparams)
    det = QuantizedDetector(
        forward_fn, qparams, decode_tables(img_size, anchors, device=device),
        anchors, num_classes, img_size,
        post="prefilter" if mode == "prefilter" else "packed",
        max_out=max_out, box_topk=box_topk, score_thresh=score_thresh,
        iou_thresh=iou_thresh)
    return det.eval(), qparams
