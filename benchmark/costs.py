"""Operations and bytes of the model and of the NMS kernels, and the card's
published peaks: a frozen copy of the program's
`scripts/roofline.py` (`walk`, `train_cost`, `kernel_bound`,
`bound_nms_shared`, `bound_nms`, `nms_pairs`, `H100_PEAKS`), over the
reference's own layer table, so that a later change to the program cannot
move the yardstick.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from benchmark.reference.model import conv_table

BYTES = 2               # bf16
Row = Tuple[str, float, float]      # (label, flops, bytes)

# published dense peaks of one H100 SXM (NVIDIA's data sheet, 700 W):
# operations/s by type, bytes/s
H100_PEAKS = {"bf16": 989e12, "fp32": 67e12, "hbm": 3.35e12}
# fp32 operations of one IoU>t test: 2 min, 2 max, 2 subtractions, 2
# clamps at 0, the product, area_i + area_j, - inter, + 1e-10, the
# division and the comparison
IOU_OPS = 14


def kernel_bound(ops: float, bytes_: float, kind: str) -> Tuple[float, str]:
    """(ms, "bytes" or "operations"): the least time one H100 SXM takes to
    move `bytes_` through device memory and do `ops` operations of `kind`,
    and which of the two sets it."""
    t_ops = ops / H100_PEAKS[kind]
    t_bytes = bytes_ / H100_PEAKS["hbm"]
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def nms_pairs(valid: torch.Tensor, keep: torch.Tensor) -> int:
    """The IoU tests a greedy NMS over these inputs needs: for every kept
    candidate, one test against each valid candidate ranked after it.
    valid, keep [..., K] bool, rows in rank order."""
    v = valid.to(torch.int64)
    later = v.flip(-1).cumsum(-1).flip(-1) - v
    return int((later * keep.to(torch.int64)).sum())


def bound_nms(g: int, k: int, pairs: int) -> Tuple[float, str]:
    """K2: boxes [g, k, 4] fp32 and valid [g, k] read once, keep [g, k]
    written once; `pairs` IoU tests of IOU_OPS fp32 ops."""
    return kernel_bound(float(pairs) * IOU_OPS, g * k * (16.0 + 1 + 1),
                        "fp32")


def bound_nms_shared(b: int, k: int, c: int) -> Tuple[float, str]:
    """K1: boxes [b, k, 4] and scores [b, k, c] fp32 read once, keep
    [b, c, k] written once; one IoU test per candidate pair of an image."""
    return kernel_bound(b * k * (k - 1) / 2.0 * IOU_OPS,
                        b * k * 16.0 + b * k * c * 4.0 + b * c * k, "fp32")


def conv_cost(h, w, cin, cout, k, stride, batch, extra_read_c=0):
    """(flops, bytes) for one fused conv(+bias+leaky[+residual-add])."""
    ho, wo = h // stride, w // stride
    flops = 2.0 * batch * ho * wo * cin * cout * k * k
    bytes_ = BYTES * batch * (h * w * cin + ho * wo * cout
                              + ho * wo * extra_read_c)
    bytes_ += BYTES * k * k * cin * cout
    return flops, bytes_


def walk(batch: int, img_h: int, img_w: int, num_classes: int = 80
         ) -> List[Row]:
    """One row per conv of the forward (52 backbone, 23 head) plus one per
    upsample, as the program's script counts them: a residual block's 3x3
    conv also reads the shortcut, the upsample is one write and one read
    of the 2x map."""
    rows: List[Row] = []
    h, w = img_h, img_w
    table = conv_table(num_classes)
    backbone = [r for r in table if r[0] == "backbone"]
    shortcut_c = {}
    for i, (_, name, cin, cout, k, stride, _) in enumerate(backbone):
        # a residual block is a 1x1 then a 3x3 back to the block's width
        closes = (k == 3 and stride == 1 and i > 1
                  and backbone[i - 1][4] == 1)
        shortcut_c[name] = cout if closes else 0
        f, b = conv_cost(h, w, cin, cout, k, stride, batch,
                         extra_read_c=shortcut_c[name])
        rows.append((f"bb {h // stride}^2x{cout} k{k}", f, b))
        h, w = h // stride, w // stride
    grids = {0: (img_h // 32, img_w // 32), 1: (img_h // 16, img_w // 16),
             2: (img_h // 8, img_w // 8)}
    for _, name, cin, cout, k, _, has_bn in (r for r in table
                                             if r[0] == "head"):
        idx = int(name.split("_")[1])
        scale = idx // 8 if idx < 22 else 2
        gh, gw = grids[scale]
        f, b = conv_cost(gh, gw, cin, cout, k, 1, batch)
        if idx in (7, 15):
            h2, w2 = grids[scale + 1]
            rows.append((f"lat {name}", f, b))
            rows.append((f"upsample {h2}^2x{cout}", 0.0,
                         BYTES * batch * h2 * w2 * cout * 2))
        elif not has_bn:
            rows.append((f"det {name} {gh}x{gw}", f, b))
        else:
            rows.append((f"head {name} {gh}x{gw} k{k}x{cout}", f, b))
    return rows


def train_cost(rows: List[Row]) -> List[Row]:
    """Training-step rows: 3 matmul-shaped passes a conv (forward, input
    gradient, weight gradient) and 2.5x the forward's bytes."""
    return [(label, 3.0 * f, 2.5 * b) for label, f, b in rows]


def forward_flops(img_h: int, img_w: int, num_classes: int) -> float:
    """FLOPs of one image's forward."""
    return sum(f for _, f, _ in walk(1, img_h, img_w, num_classes))


def train_flops(img_h: int, img_w: int, num_classes: int) -> float:
    """FLOPs of one image's training step (3x the forward's convs)."""
    return sum(f for _, f, _ in train_cost(walk(1, img_h, img_w,
                                                num_classes)))
