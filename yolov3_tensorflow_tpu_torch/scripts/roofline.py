"""Per-layer roofline of the bf16 serving forward, from measured constants.

Counterpart of `scripts/roofline.py`, derived from this package's model
plan (`models.yolov3.BACKBONE_PLAN`, `head_plan` and the head's input
channels), so it stays right if the plan changes. Per conv layer i the
time lower bound is

    t_i = max(FLOPs_i / peak, bytes_i / bandwidth)

with bytes counted optimistically (perfect fusion: one read of the input,
one write of the output, weights once per batch; the bias, LeakyReLU and
residual add ride the conv epilogue for free; the split-neck junction never
materializes a concat). Summing t_i assumes perfect overlap between layers
and no scheduling cost, so sum(t_i) is a lower bound per batch and
batch / sum(t_i) a throughput ceiling for this dtype on this card.

The two constants have no defaults: pass numbers measured on the card the
bound is for (`exp_mxu_shapes.matmul_peak` for the bf16 matmul rate, the
copy probe of `profile_stages` for the bandwidth). Two differences from the
JAX script: the lateral 1x1 conv of the 13->26 junction reads the
512-channel output of head conv_4, not the 1024-channel block output; and
the constants are flags in TF/s and GB/s. The detection convs are counted
at 3 * (5 + C) output channels, as the JAX script counts them.

The `bound_*` functions give each hand-written kernel's bound at its
shapes: the larger of the bytes it must move (each input read once, each
output written once) over the card's memory rate and the operations it
does over the card's peak rate for their type. They use the published
H100 SXM peaks (`H100_PEAKS`, NVIDIA's data sheet, dense, at the full
700 W), not measured constants, so a share of them is a share of what the
card is sold to do.

Usage:

    python -m yolov3_tensorflow_tpu_torch.scripts.roofline \\
        --peak_tflops 790 --hbm_gbs 2900 [--batch 128] [--size 416 416] \\
        [--measured_ms 43.5] [--train]
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Tuple

import torch

from yolov3_tensorflow_tpu_torch.models.yolov3 import (BACKBONE_PLAN,
                                                       _head_input_channels,
                                                       head_plan)

BYTES = 2               # bf16
Row = Tuple[str, float, float]      # (label, flops, bytes)

# published dense peaks of one H100 SXM: operations/s by type, bytes/s
H100_PEAKS = {"bf16": 989e12, "fp32": 67e12, "hbm": 3.35e12}
# fp32 operations of one IoU>t test in iou_xyxy's order: 2 min, 2 max,
# 2 subtractions, 2 clamps at 0, the product, area_i + area_j, - inter,
# + 1e-10, the division and the comparison
IOU_OPS = 14


def kernel_bound(ops: float, bytes_: float, kind: str) -> Tuple[float, str]:
    """(ms, "bytes" or "operations"): the least time one H100 SXM takes to
    move `bytes_` through device memory and do `ops` operations of `kind`
    ("bf16" or "fp32"), and which of the two sets it."""
    t_ops = ops / H100_PEAKS[kind]
    t_bytes = bytes_ / H100_PEAKS["hbm"]
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def bound_mma_chain(m: int, k: int, n: int, reps: int) -> Tuple[float, str]:
    """K3: reps products a [m, k] . b [k, n] in bf16 (FLOPs at the true k),
    a and b read once, the fp32 o [m, n] written once."""
    return kernel_bound(2.0 * m * k * n * reps,
                        2.0 * (m * k + k * n) + 4.0 * m * n, "bf16")


def bound_patch_build(m: int, c: int, taps: int = 9, mt: int = 1024
                      ) -> Tuple[float, str]:
    """K4: x [m, c] bf16 read once, the [m / mt * (mt - 16), taps * c]
    patches written once."""
    return kernel_bound(0.0, 2.0 * m * c + 2.0 * (m // mt) * (mt - 16)
                        * taps * c, "fp32")


def nms_pairs(valid: torch.Tensor, keep: torch.Tensor) -> int:
    """The IoU tests a greedy NMS over these inputs needs: for every kept
    candidate, one test against each valid candidate ranked after it.
    valid, keep [..., K] bool, rows in rank order."""
    v = valid.to(torch.int64)
    later = v.flip(-1).cumsum(-1).flip(-1) - v        # valid j > i
    return int((later * keep.to(torch.int64)).sum())


def bound_nms(g: int, k: int, pairs: int) -> Tuple[float, str]:
    """K2: boxes [g, k, 4] fp32 and valid [g, k] read once, keep [g, k]
    written once; `pairs` IoU tests (`nms_pairs`) of IOU_OPS fp32 ops."""
    return kernel_bound(float(pairs) * IOU_OPS, g * k * (16.0 + 1 + 1),
                        "fp32")


def bound_nms_shared(b: int, k: int, c: int) -> Tuple[float, str]:
    """K1: boxes [b, k, 4] and scores [b, k, c] fp32 read once, keep
    [b, c, k] written once; one IoU test per candidate pair of an image."""
    return kernel_bound(b * k * (k - 1) / 2.0 * IOU_OPS,
                        b * k * 16.0 + b * k * c * 4.0 + b * c * k, "fp32")


def bound_conv_epilogue(numel: int, itemsize: int, extra_numel: int = 0
                        ) -> Tuple[float, str]:
    """E1 on one conv's output of `numel` elements of `itemsize` bytes: y
    read once and written once, the shortcut or the junction's lateral half
    (`extra_numel` elements of y's dtype) read once, the bias's C values
    left out; at most 4 fp32 operations an element (the bias add, the
    LeakyReLU's compare and product, the shortcut's add)."""
    return kernel_bound(4.0 * numel, float(itemsize)
                        * (2 * numel + extra_numel), "fp32")


def shared_counts(scores: torch.Tensor, keep: torch.Tensor,
                  score_thresh: float) -> Dict[str, float]:
    """What K1's inputs ask of it, per (image, class): valid candidates
    (score >= score_thresh; mean, max), kept candidates (mean, max), and
    how many classes have no valid candidate at all. scores [B, K, C],
    keep [B, C, K] bool."""
    nv = (scores >= score_thresh).sum(1).float()                # [B, C]
    nk = keep.sum(-1).float()
    return {"valid_mean": float(nv.mean()), "valid_max": int(nv.max()),
            "kept_mean": float(nk.mean()), "kept_max": int(nk.max()),
            "empty_classes": int((nv == 0).sum()), "classes": nv.numel()}

# the JAX script's names for the three scales (strides 32, 16, 8)
_SCALES = ("13", "26", "52")


def conv_cost(h, w, cin, cout, k, stride, batch, extra_read_c=0):
    """(flops, bytes) for one fused conv(+bias+leaky[+residual-add]) layer.

    extra_read_c: channels of an extra full-resolution operand the epilogue
    must read (residual shortcut).
    """
    ho, wo = h // stride, w // stride
    flops = 2.0 * batch * ho * wo * cin * cout * k * k
    bytes_ = BYTES * batch * (h * w * cin            # read input
                              + ho * wo * cout       # write output
                              + ho * wo * extra_read_c)
    bytes_ += BYTES * k * k * cin * cout             # weights, once per batch
    return flops, bytes_


def walk(batch: int, img_h: int, img_w: int, num_classes: int = 80
         ) -> List[Row]:
    """One row per conv of the forward (52 backbone, 23 head) plus one per
    upsample, in execution order."""
    rows: List[Row] = []
    h, w, cin = img_h, img_w, 3
    routes = []
    in_res = False
    res_in_c = 0
    for op in BACKBONE_PLAN:
        if op[0] == "conv":
            _, cout, k, stride = op
            # closing conv of a residual block also reads the shortcut
            extra = res_in_c if (in_res and k == 3) else 0
            f, b = conv_cost(h, w, cin, cout, k, stride, batch,
                             extra_read_c=extra)
            rows.append((f"bb {h//stride}^2x{cout} k{k}", f, b))
            h, w, cin = h // stride, w // stride, cout
            if in_res and k == 3:
                in_res = False
        elif op[0] == "res_begin":
            in_res, res_in_c = True, cin
        elif op[0] == "route":
            routes.append((h, w))

    # head, in head_plan order: each scale's 6-conv block and detection
    # conv, then (but for the last scale) the lateral 1x1 conv at this
    # scale and the upsample of its output, modeled as one write and one
    # read at the next scale (the junction reads the 2x map).
    grids = routes[::-1]                      # strides 32, 16, 8
    head_cin = _head_input_channels(num_classes)
    scale, lateral_next = 0, False
    for idx, cout, k, has_bn in head_plan(num_classes):
        h, w = grids[scale]
        f, b = conv_cost(h, w, head_cin[idx], cout, k, 1, batch)
        here = _SCALES[scale]
        if lateral_next:
            nxt = _SCALES[scale + 1]
            h2, w2 = grids[scale + 1]
            rows.append((f"lat{here}->{nxt}", f, b))
            rows.append((f"upsample {nxt}^2x{cout}", 0.0,
                         BYTES * batch * h2 * w2 * cout * 2))
            scale, lateral_next = scale + 1, False
        elif not has_bn:                      # detection conv
            rows.append((f"head{here} det {h}x{w}", f, b))
            lateral_next = True
        else:
            rows.append((f"head{here} {h}x{w} k{k}x{cout}", f, b))
    return rows


def train_cost(rows: List[Row]) -> List[Row]:
    """Map forward (flops, bytes) rows to training-step lower bounds.

    Per conv layer the train step does 3 matmul-shaped passes (forward,
    input-cotangent, weight-gradient), each the same FLOPs as forward;
    optimistic byte count: forward reads X + writes Y; backward reads dY,
    re-reads the saved X (weight grad), writes dX: 3*in + 2*out activation
    traffic, <= 2.5x the forward's, used as the optimistic midpoint. BN
    train-mode passes, the loss and the optimizer are excluded, so this is
    a true ceiling.
    """
    return [(label, 3.0 * f, 2.5 * b) for label, f, b in rows]


def roofline(batch: int, size: Tuple[int, int], peak_tflops: float,
             hbm_gbs: float, *, train: bool = False) -> Dict:
    """Totals and times of the forward's rows (with train, the training
    step's) at this batch and size against peak_tflops (TF/s) and hbm_gbs
    (GB/s): FLOPs, bytes, the pure-FLOP, pure-HBM and per-layer bound
    seconds, the count of HBM-bound rows, and "top", the 8 rows furthest
    over their FLOP time as (label, hbm seconds, flop seconds)."""
    rows = walk(batch, size[0], size[1])
    if train:
        rows = train_cost(rows)
    peak, bandwidth = peak_tflops * 1e12, hbm_gbs * 1e9
    top = sorted(rows, key=lambda r: -(r[2] / bandwidth - r[1] / peak))
    return {
        "flops": sum(r[1] for r in rows),
        "bytes": sum(r[2] for r in rows),
        "t_flop": sum(r[1] / peak for r in rows),
        "t_hbm": sum(r[2] / bandwidth for r in rows),
        "t_bound": sum(max(r[1] / peak, r[2] / bandwidth) for r in rows),
        "n_hbm": sum(1 for r in rows if r[2] / bandwidth > r[1] / peak),
        "n_rows": len(rows),
        "top": [(label, b / bandwidth, f / peak) for label, f, b in top[:8]],
    }


def report(s: Dict, batch: int, size: Tuple[int, int],
           measured_ms: float = 0.0) -> List[str]:
    """The lines `main` prints for a `roofline` result."""
    lines = [
        f"batch {batch} @ {size[0]}x{size[1]} bf16",
        f"  total FLOPs/img: {s['flops'] / batch / 1e9:.1f} GF; "
        f"HBM bytes/img (perfect fusion): {s['bytes'] / batch / 1e6:.0f} MB",
        f"  pure-FLOP time:  {s['t_flop'] * 1e3:7.2f} ms/batch "
        f"({batch / s['t_flop']:7.0f} img/s)",
        f"  pure-HBM time:   {s['t_hbm'] * 1e3:7.2f} ms/batch "
        f"({batch / s['t_hbm']:7.0f} img/s)",
        f"  per-layer max(F,B) bound: {s['t_bound'] * 1e3:.2f} ms/batch "
        f"-> CEILING {batch / s['t_bound']:.0f} img/s "
        f"({s['n_hbm']}/{s['n_rows']} stages HBM-bound)",
    ]
    if measured_ms:
        lines.append(f"  measured: {measured_ms:.2f} ms/batch = "
                     f"{batch / measured_ms * 1e3:.0f} img/s = "
                     f"{s['t_bound'] * 1e3 / measured_ms * 100:.0f}% of the "
                     f"bound")
    lines.append("  top HBM-bound stages (bound_ms, flop_ms):")
    for label, t_b, t_f in s["top"]:
        lines.append(f"    {label:24s} hbm {t_b * 1e3:6.2f} ms  "
                     f"flop {t_f * 1e3:6.2f} ms")
    return lines


def main(argv=None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--peak_tflops", type=float, required=True,
                   help="bf16 matmul rate measured on the card, TF/s")
    p.add_argument("--hbm_gbs", type=float, required=True,
                   help="device-memory bandwidth measured on the card "
                        "(read + write), GB/s")
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--size", type=int, nargs=2, default=[416, 416])
    p.add_argument("--train", action="store_true",
                   help="bound the training step (fwd+bwd) instead of "
                        "inference")
    p.add_argument("--measured_ms", type=float, default=0.0,
                   help="measured ms/batch to compare against")
    args = p.parse_args(argv)
    s = roofline(args.batch, tuple(args.size), args.peak_tflops, args.hbm_gbs,
                 train=args.train)
    for line in report(s, args.batch, tuple(args.size), args.measured_ms):
        print(line)
    return s


if __name__ == "__main__":
    main()
