"""Operations and bytes of YOLOv4's forward, over the YOLOv4 reference's
own layer table, frozen so that a later change to the program cannot move
the yardstick: one row per conv (FLOPs as 2 x its multiply-adds, bytes as
`costs.conv_cost` counts a fused conv), and the bytes that the conv
epilogue (E1) moves in each of its modes, as its operands lie in memory
on the packed path: y read and the result written in the compute dtype
(bf16), the shortcut read in the residual modes, the bias read once (fp32
where folded from batch norm, bf16 on the packed detection convs).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from benchmark.costs import BYTES, conv_cost
from benchmark.reference.yolov4 import layers

Row = Tuple[str, float, float]      # (label, flops, bytes)


def convs(batch: int, img_h: int, img_w: int, num_classes: int = 80
          ) -> List[Dict]:
    """Each conv of the forward with its input and output shapes: "layer",
    "h", "w" (input), "cin", "cout", "k", "stride", "act", and "shortcut"
    (a shortcut layer follows it: E1 adds it)."""
    plan = layers(num_classes)
    shapes: List[Tuple[int, int, int]] = []      # (c, h, w) of each output
    out = []
    for i, op in enumerate(plan):
        c, h, w = shapes[-1] if shapes else (3, img_h, img_w)
        if op[0] == "conv":
            _, cout, k, stride, act = op
            out.append({"layer": i, "h": h, "w": w, "cin": c, "cout": cout,
                        "k": k, "stride": stride, "act": act,
                        "shortcut": i + 1 < len(plan)
                        and plan[i + 1][0] == "shortcut"})
            shapes.append((cout, h // stride, w // stride))
        elif op[0] == "route":
            parts = [shapes[j] for j in op[1]]
            shapes.append((sum(p[0] for p in parts),) + parts[0][1:])
        elif op[0] == "upsample":
            shapes.append((c, 2 * h, 2 * w))
        else:
            shapes.append((c, h, w))
    return out


def walk(batch: int, img_h: int, img_w: int, num_classes: int = 80
         ) -> List[Row]:
    """One row per conv (72 backbone, 38 neck and head)."""
    rows = []
    for c in convs(batch, img_h, img_w, num_classes):
        ho, wo = c["h"] // c["stride"], c["w"] // c["stride"]
        f, b = conv_cost(c["h"], c["w"], c["cin"], c["cout"], c["k"],
                         c["stride"], batch,
                         extra_read_c=c["cout"] if c["shortcut"] else 0)
        rows.append((f"L{c['layer']} {c['act']} {ho}x{wo}x{c['cout']} "
                     f"k{c['k']}", f, b))
    return rows


def forward_flops(img_h: int, img_w: int, num_classes: int = 80) -> float:
    """FLOPs of one image's forward."""
    return sum(f for _, f, _ in walk(1, img_h, img_w, num_classes))


def epilogue_bytes(batch: int, img_h: int, img_w: int,
                   num_classes: int = 80, row: int = 128
                   ) -> Dict[str, float]:
    """Bytes E1 moves in one packed forward, by mode ("mish",
    "mish_residual", "leaky", "bias"); the packed detection convs write
    3 x `row` channels."""
    out = dict.fromkeys(("mish", "mish_residual", "leaky", "bias"), 0.0)
    for c in convs(batch, img_h, img_w, num_classes):
        cout = 3 * row if c["act"] == "linear" else c["cout"]
        numel = batch * (c["h"] // c["stride"]) * (c["w"] // c["stride"]) \
            * cout
        moved = 2 * BYTES * numel + (BYTES if c["act"] == "linear" else 4) \
            * cout
        if c["shortcut"]:
            moved += BYTES * numel
        mode = {"linear": "bias", "leaky": "leaky"}.get(
            c["act"], "mish_residual" if c["shortcut"] else "mish")
        out[mode] += moved
    return out


def mish_bytes(batch: int, img_h: int, img_w: int,
               num_classes: int = 80) -> float:
    """Bytes of E1's Mish instances (both Mish modes) in one forward."""
    b = epilogue_bytes(batch, img_h, img_w, num_classes)
    return b["mish"] + b["mish_residual"]
