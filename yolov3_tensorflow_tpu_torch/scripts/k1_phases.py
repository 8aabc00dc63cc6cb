"""Where the shared-candidate NMS kernel (K1, `csrc/nms_shared.cu`) spends
its time, phase by phase, on one GPU.

    python -m yolov3_tensorflow_tpu_torch.scripts.k1_phases

Builds K1 a second time with -DK1_PHASES (thread 0 of each CTA stamps
clock64 at the end of each phase, behind a CTA barrier, and %globaltimer at
entry and exit) and runs it, through the port's own wrapper and plan
(`ops.nms_cuda.shared_plan`), on the candidates of the three requests that
reach K1 (`compare_revisions.shared_candidates`: packed at batch 128 and 8,
K=64; prefilter at batch 8, K=256). Per shape it prints the plan, the
instrumented kernel's time with the stream held (`utils.profiling.cuda_ms`;
the barriers make it slower than the shipped build), the span from the
first CTA's entry to the last CTA's exit, and the mean and largest time of
each phase over the CTAs:

  load      boxes into shared memory (the scores' copies issued first)
  mask      this CTA's rows of the IoU>t mask
  share     the other rows from the cluster's peers, and the scores landed
  classes   the greedy of every class of the CTA, keep rows written
  exit      the wait for the cluster's peers

Cycles become microseconds at the SM clock measured here: a sleep kernel
of known cycles timed with CUDA events. The last line is one JSON object.
"""

from __future__ import annotations

import ctypes
import json
from typing import Dict

import numpy as np
import torch

PHASES = ("load", "mask", "share", "classes", "exit")


def sm_ghz() -> float:
    """The SM clock under load, GHz: torch.cuda._sleep(cycles) timed with
    CUDA events."""
    cycles = 20_000_000
    torch.cuda._sleep(1_000_000)                     # settle the clock
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    torch.cuda.synchronize()
    return cycles / (start.elapsed_time(end) * 1e6)


def phases(stamps: np.ndarray, ghz: float) -> Dict[str, object]:
    """stamps [CTAs, 8] uint64 (K1_PHASES layout) -> the span (first entry
    to last exit, us, from %globaltimer) and each phase's mean and largest
    time over the CTAs (us, from clock64 at `ghz`)."""
    st = stamps.astype(np.float64)
    us = np.diff(st[:, 1:7], axis=1) / (ghz * 1e3)
    return {"span_us": float(st[:, 7].max() - st[:, 0].min()) / 1e3,
            "mean_us": dict(zip(PHASES, us.mean(0).tolist())),
            "max_us": dict(zip(PHASES, us.max(0).tolist()))}


def main() -> Dict:
    from yolov3_tensorflow_tpu_torch.ops import nms_cuda
    from yolov3_tensorflow_tpu_torch.scripts import exp_mxu_shapes as probes
    from yolov3_tensorflow_tpu_torch.scripts.compare_revisions import (
        card, shared_candidates)
    from yolov3_tensorflow_tpu_torch.utils.kernels import build_kernel
    from yolov3_tensorflow_tpu_torch.utils.profiling import cuda_ms
    dev = probes._gpu(None)
    lib = ctypes.CDLL(str(build_kernel("nms_shared",
                                       defines=("K1_PHASES",))))
    nms_cuda._shared_launcher = lambda: nms_cuda.bind_shared(lib)
    result = {"card": card(), "ghz": sm_ghz(), "shapes": {}}
    print(f"card: {result['card']}; SM clock {result['ghz']:.3f} GHz")
    for name, case in shared_candidates(dev).items():
        boxes, scores = case["boxes"], case["scores"]
        st, it = case["score_thresh"], case["iou_thresh"]
        b, k, c = scores.shape
        plan = nms_cuda.shared_plan(b, k, c)
        ms = cuda_ms(lambda: nms_cuda.nms_keep_mask_shared(boxes, scores,
                                                           st, it), 200)
        keep = nms_cuda.nms_keep_mask_shared(boxes, scores, st, it)
        torch.cuda.synchronize()
        if not torch.equal(keep, case["keep"]):
            raise RuntimeError(f"the instrumented kernel's keep masks differ "
                               f"from the plain version's on {name}")
        ctas = b * plan.slices
        stamps = np.zeros((ctas, 8), np.uint64)
        err = lib.nms_shared_phases(ctypes.c_void_p(stamps.ctypes.data),
                                    ctypes.c_int(ctas))
        if err != 0:
            raise RuntimeError(f"reading the stamps failed: CUDA error {err}")
        r = dict(phases(stamps, result["ghz"]), plan=plan._asdict(), ms=ms)
        result["shapes"][name] = r
        print(f"{name} B={b} K={k} C={c}: {ctas} CTAs of {plan.warps} warps, "
              f"{plan.classes} classes each, mask "
              f"{'shared by a cluster' if plan.shared else 'built by each'}; "
              f"instrumented {ms * 1e3:.2f} us held, span "
              f"{r['span_us']:.2f} us")
        for p in PHASES:
            print(f"  {p:8s} mean {r['mean_us'][p]:6.3f} us, max "
                  f"{r['max_us'][p]:6.3f} us")
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
