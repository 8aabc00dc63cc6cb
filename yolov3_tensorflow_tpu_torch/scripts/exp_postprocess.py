"""The packed detector end to end under its postprocess variants
(counterpart of `scripts/exp_postprocess.py`).

  A/B per-anchor / cell-major: JAX's two ways of reading the candidate
      rows are one gather in the port (`ops/fast_postprocess.py`, the
      module docstring: the per-anchor view is free in PyTorch), so they
      are one row: `postprocess_packed` as the detector runs it
  C   bf16 selection score (`score_dtype="bf16"`)

Each is the bf16 packed forward plus the postprocess at the serving
config, K1 on the GPU. With `--sweep b1,b2,...` the faster of the two is
then timed at each batch.

  python -m yolov3_tensorflow_tpu_torch.scripts.exp_postprocess \\
      [--batch 128] [--sweep 8,32,128] [--size 416 416] [--iters 5,25] \\
      [--device cuda] [--out f.json]
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

from yolov3_tensorflow_tpu_torch.ops.fast_postprocess import (
    postprocess_packed, yolov3_forward_packed)
from yolov3_tensorflow_tpu_torch.scripts import bench, experiments

VARIANTS = {"A/B per-anchor = cell-major (one gather)": None,
            "C bf16 selection score": "bf16"}


def detect(det, score_dtype=None) -> Callable[[torch.Tensor], Dict]:
    """images -> detections: the packed detector's program with the
    selection score in `score_dtype`."""
    def call(images):
        outs = yolov3_forward_packed(det.packed, images,
                                     compute_dtype=torch.bfloat16)
        return postprocess_packed(
            outs, None, det.num_classes, det.img_size, max_out=det.max_out,
            box_topk=det.box_topk, score_thresh=det.score_thresh,
            iou_thresh=det.iou_thresh, tables=det.tables,
            score_dtype=score_dtype)
    return call


def main(argv: Optional[List[str]] = None) -> int:
    p = experiments.parser(__doc__, batch=128)
    p.add_argument("--sweep", type=str, default="",
                   help="comma-separated batches to time the faster "
                        "variant at")
    run = experiments.Run("exp_postprocess", p, argv)
    sweep = [int(v) for v in run.args.sweep.split(",") if v]
    _, det, images, _ = experiments.packed_setup(run.batch, run.size,
                                                 run.device)
    with torch.inference_mode():
        rows = {name: run.row(name, lambda f=detect(det, sdt): f(images),
                              nms=True, batch=run.batch)
                for name, sdt in VARIANTS.items()}
        best = min(rows, key=lambda n: rows[n]["ms"])
        for b in sweep:
            imgs = bench.bench_images(b, run.size, run.device)
            run.row(f"sweep: {best.split()[0]} batch {b}",
                    lambda f=detect(det, VARIANTS[best]), imgs=imgs: f(imgs),
                    nms=True, batch=b)
    return run.finish(faster=best, sweep=sweep)


if __name__ == "__main__":
    raise SystemExit(main())
