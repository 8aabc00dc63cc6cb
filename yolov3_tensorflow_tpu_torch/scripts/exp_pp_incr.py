"""The in-pipeline cost of each packed-postprocess stage (counterpart of
`scripts/exp_pp_incr.py`).

Each row is the whole program up to a stage, from the images:

  fwd only         `yolov3_forward_packed` (bf16, the benched weights)
  +score           + `packed_scores` (fp32; and in bf16)
  +top-k           + `top_candidates` (the stable sort, K=64)
  +top-k r.85      no counterpart (PyTorch has no approximate top-k)
  +gather/decode   + `packed_decode`
  full (bf16 score) + K1 and the compaction, ranking by a bf16 score
  full             + K1 and the compaction (`postprocess_packed`): the
                   program of `build_detector(mode="packed")`

The differences between consecutive rows of the fp32 chain are each
stage's cost inside the pipeline. They are printed beside the decode+NMS
p50 of `scripts.bench` (`bench.p50_call`: `postprocess_prefilter` on the
folded forward's maps) on the same batch, measured here (P50_CALLS calls,
each alone).

  python -m yolov3_tensorflow_tpu_torch.scripts.exp_pp_incr [--batch 128] \\
      [--size 416 416] [--iters 5,25] [--device cuda] [--out f.json]
"""

from __future__ import annotations

import statistics
from typing import Callable, List, Optional, Tuple

import torch

from yolov3_tensorflow_tpu_torch.ops.fast_postprocess import (
    packed_decode, packed_scores, postprocess_packed, top_candidates,
    yolov3_forward_packed)
from yolov3_tensorflow_tpu_torch.scripts import bench, experiments
from yolov3_tensorflow_tpu_torch.utils.profiling import call_samples_ms

K = experiments.SERVING["box_topk"]
CHAIN = ("fwd only", "+score fp32", "+top-k", "+gather/decode", "full")


def stages(det, images: torch.Tensor
           ) -> List[Tuple[str, Callable[[], object], bool]]:
    """(name, call, launches K1) of every row, in order; the last is the
    packed detector's program, written out stage by stage."""
    c, size, tables = det.num_classes, det.img_size, det.tables

    def fwd():
        return yolov3_forward_packed(det.packed, images,
                                     compute_dtype=torch.bfloat16)

    def full(**kw):
        return postprocess_packed(
            fwd(), None, c, size, max_out=det.max_out, box_topk=det.box_topk,
            score_thresh=det.score_thresh, iou_thresh=det.iou_thresh,
            tables=tables, **kw)

    def topk():
        return top_candidates(packed_scores(fwd(), c), det.box_topk)

    def gather():
        outs = fwd()
        cand = top_candidates(packed_scores(outs, c), det.box_topk)
        return packed_decode(outs, cand, c, tables)

    return [("fwd only", fwd, False),
            ("+score fp32", lambda: packed_scores(fwd(), c), False),
            ("+score bf16", lambda: packed_scores(fwd(), c, "bf16"), False),
            ("+top-k", topk, False),
            ("+gather/decode", gather, False),
            ("full (bf16 score)", lambda: full(score_dtype="bf16"), True),
            ("full", full, True)]


def main(argv: Optional[List[str]] = None) -> int:
    run = experiments.Run("exp_pp_incr",
                          experiments.parser(__doc__, batch=128), argv)
    variables, det, images, _ = experiments.packed_setup(
        run.batch, run.size, run.device)
    ms = {}
    with torch.inference_mode():
        for name, fn, nms in stages(det, images):
            ms[name] = run.row(name, fn, nms=nms, batch=run.batch)["ms"]
            if name == "+top-k":
                run.no_counterpart("+top-k r.85",
                                   "PyTorch has no approximate top-k")
    p50_call = bench.p50_call(variables, images, run.size)
    samples = call_samples_ms(p50_call, run.device, bench.P50_CALLS)
    p50 = {"ms": statistics.median(samples), "calls": len(samples) + 1,
           "batch": run.batch}
    steps = {f"{b} - {a}": ms[b] - ms[a] for a, b in zip(CHAIN, CHAIN[1:])}
    print("stage costs inside the pipeline: " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in steps.items())
        + f" (postprocess {ms['full'] - ms['fwd only']:.3f} ms); "
        f"scripts.bench's decode+NMS p50 {p50['ms']:.3f} ms "
        f"(batch {run.batch}, {bench.P50_CALLS} calls) [{run.card}]",
        flush=True)
    return run.finish(increments=steps, p50=p50,
                      nms_calls=run.nms_calls() + p50["calls"])


if __name__ == "__main__":
    raise SystemExit(main())
