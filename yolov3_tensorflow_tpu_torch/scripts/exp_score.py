"""How much does the packed path's selection score cost beside its read
floor? (counterpart of `scripts/exp_score.py`)

Five ways to compute the selection score sigmoid(conf) * sigmoid(max
class logit) from device-resident packed head outputs (the bf16 packed
detector's, `experiments.packed_setup`), each summed to a scalar:

  v0 the current form: `ops.fast_postprocess.packed_scores`, the
     per-anchor view [B, A, row] and the max over the class lanes [0, C)
     (the slice `[..., :C]`, the port's form of JAX's where-mask: the
     same lanes)
  v1 an additive mask (0 on the class lanes, -1e4 elsewhere, bf16) over
     the whole row, then the lane max
  v2 the 4-D form, no reshape: each anchor block a strided view
     p[..., a*row:(a+1)*row] of the conv output, as PyTorch runs it (no
     .contiguous())
  v3 the conf lane only: the read-floor probe
  v4 v1 in bf16 (the logistic as JAX's bf16 one, `_score_sigmoid`)

Each row is beside the H100's read floor: the packed outputs' bytes over
its 3.35 TB/s (`scripts/roofline.py:H100_PEAKS`; 348.9 MB, 0.104 ms, at
batch 128). The record holds each variant's sum ("value").

  python -m yolov3_tensorflow_tpu_torch.scripts.exp_score [--batch 128] \\
      [--size 416 416] [--iters 5,25] [--device cuda] [--out f.json]
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch

from yolov3_tensorflow_tpu_torch.ops.fast_postprocess import (
    _score_sigmoid, head_row_width, packed_scores)
from yolov3_tensorflow_tpu_torch.scripts import experiments
from yolov3_tensorflow_tpu_torch.scripts.roofline import H100_PEAKS

Outs = Sequence[torch.Tensor]


def variants(num_classes: int, device: torch.device
             ) -> Dict[str, Callable[[Outs], torch.Tensor]]:
    """name -> fn(packed outputs on `device`) -> the summed score (an fp32
    scalar)."""
    c = num_classes
    row = head_row_width(c)
    lane = torch.arange(row, device=device)
    mask = torch.where(lane < c, 0.0, -1e4).to(torch.bfloat16)

    def v0(po):
        return packed_scores(po, c).sum()

    def v1(po):
        tot = 0.0
        for p in po:
            pr = p.reshape(p.shape[0], -1, row)
            m = (pr + mask).amax(dim=-1).float()
            tot = tot + (torch.sigmoid(pr[..., c].float())
                         * torch.sigmoid(m)).sum()
        return tot

    def v2(po):
        tot = 0.0
        for p in po:
            for a in range(3):
                blk = p[..., a * row:(a + 1) * row]       # a strided view
                m = blk[..., :c].amax(dim=-1).float()
                tot = tot + (torch.sigmoid(blk[..., c].float())
                             * torch.sigmoid(m)).sum()
        return tot

    def v3(po):
        tot = 0.0
        for p in po:
            for a in range(3):
                tot = tot + torch.sigmoid(p[..., a * row + c].float()).sum()
        return tot

    def v4(po):
        tot = 0.0
        for p in po:
            pr = p.reshape(p.shape[0], -1, row)
            m = (pr + mask).amax(dim=-1)
            tot = tot + (_score_sigmoid(pr[..., c]) * _score_sigmoid(m)
                         ).float().sum()
        return tot

    return {"v0 class-lane max (current)": v0, "v1 addmask+max": v1,
            "v2 4-D class-lane max": v2, "v3 conf-only (floor)": v3,
            "v4 addmask bf16": v4}


def read_floor_ms(outs: Outs) -> float:
    """The packed outputs' bytes, read once, over the H100's HBM rate."""
    return sum(p.numel() * p.element_size() for p in outs) \
        / H100_PEAKS["hbm"] * 1e3


def main(argv: Optional[List[str]] = None) -> int:
    run = experiments.Run("exp_score", experiments.parser(__doc__,
                                                          batch=128), argv)
    _, _, _, outs = experiments.packed_setup(run.batch, run.size,
                                             run.device)
    floor = read_floor_ms(outs)
    print(f"packed outputs: {sum(p.numel() for p in outs)} bf16 values, "
          f"the H100 read floor {floor:.4f} ms (3.35 TB/s)", flush=True)
    with torch.inference_mode():
        for name, fn in variants(experiments.NUM_CLASSES, run.device).items():
            row = run.row(name, lambda fn=fn: fn(outs), alone=True,
                          value=float(fn(outs)))
            if row["device_ms"] is not None:
                print(f"  {name}: {row['device_ms'] / floor:.2f}x the read "
                      f"floor on the device alone", flush=True)
    return run.finish(read_floor_ms=floor)


if __name__ == "__main__":
    raise SystemExit(main())
