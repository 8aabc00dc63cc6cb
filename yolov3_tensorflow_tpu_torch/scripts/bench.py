"""Benchmark: batched YOLOv3-416 COCO inference throughput on one GPU.

Counterpart of the JAX package's root `bench.py`. Prints, as its last line,
ONE JSON object with the JAX script's keys:

  {"metric": "images_per_sec_416_inference", "value": N, "unit": "img/s",
   "vs_baseline": N / 43.5, "mode": "bf16" or "stem_int8_hybrid"}

Baseline: the reference implementation's published ~23 ms per 416x416
image (~43.5 img/s, Titan XP, batch 1, TF graph with GPU NMS;
BASELINE.md). The measured pipeline is the same end-to-end surface:
forward, anchor decode, score threshold and per-class NMS, batched.

What it times, on full COCO-80 YOLOv3 with seeded random weights
(`init_yolov3` from a torch.Generator seeded 0, then `spread_head`, so that
the serving threshold leaves the NMS real work: at random init every score
is ~0.25):

- the bf16 serving detector, `build_detector(mode="packed")` (BN folded in
  bf16, `pack_serving_head`) at the serving config (max_out 128, box_topk
  64, score 0.3, IoU 0.45, exact top-k; the shared-candidate NMS kernel,
  `ops/nms_cuda.py`), at every batch of `--batches`. The best batch is the
  knee;
- at the best batch, on stderr: the stem-int8 hybrid
  (`build_detector(mode="stem8")`, conv_0..conv_11 int8-chained), which
  becomes the headline when it wins, as in the JAX script, and full int8
  (`build_detector_int8(mode="packed")`: `quantize_model` plus the packed
  head), both calibrated on the batch's first 8 images;
- the decode+NMS p50: `postprocess_prefilter` (max_out 50, box_topk 128,
  pre_topk 128) on precomputed bf16 `yolov3_forward_folded` maps of the
  best batch, each of P50_CALLS calls timed alone, the median reported.

Timing: `utils.profiling.differential_ms` per detector ((T(n2) - T(n1)) /
(n2 - n1), each T the least of 3, torch.cuda.synchronize as the sync; n1, n2
from `--iters`), which is a call's cost with the host's gaps included;
beside it the device's busy time per call (`device_busy_ms`), which shows
where the host sets the pace. `--device cpu` (for the tests) times the
host clock and reports no busy time. `--record` writes every number,
with the requests made (each launches the NMS kernel once on a GPU), as
JSON.

  python -m yolov3_tensorflow_tpu_torch.scripts.bench [--size 416 416] \\
      [--batches 8,16,32] [--iters 5,25] [--device cuda] [--record f.json]
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from yolov3_tensorflow_tpu_torch.cli.common import device_name, resolve_device
from yolov3_tensorflow_tpu_torch.config import DEFAULT_ANCHORS
from yolov3_tensorflow_tpu_torch.models.convert import spread_head
from yolov3_tensorflow_tpu_torch.models.yolov3 import (fold_batch_norm,
                                                       init_yolov3,
                                                       yolov3_forward_folded)
from yolov3_tensorflow_tpu_torch.ops.fast_postprocess import (
    decode_tables, postprocess_prefilter)
from yolov3_tensorflow_tpu_torch.ops.postprocess import build_detector
from yolov3_tensorflow_tpu_torch.ops.quantize import build_detector_int8
from yolov3_tensorflow_tpu_torch.utils.profiling import (call_samples_ms,
                                                         device_busy_ms,
                                                         differential_ms)

BASELINE_IMG_PER_SEC = 43.5
NUM_CLASSES = 80
SERVING = dict(max_out=128, box_topk=64, score_thresh=0.3, iou_thresh=0.45)
P50 = dict(max_out=50, box_topk=128, pre_topk=128, score_thresh=0.3,
           iou_thresh=0.45)
# JAX's TPU v5e knee scan (64..256 around its knee at 128) with batch 8
# added; on the CPU (tests) JAX's non-TPU default
CUDA_BATCHES = (8, 16, 32, 64, 96, 128, 160, 192, 256)
CPU_BATCHES = (4,)
# calls of the differential's two runs: JAX's on the TPU, and elsewhere
CUDA_ITERS = (5, 25)
CPU_ITERS = (1, 3)
STEM_UPTO = 12                 # the stem-int8 hybrid's int8 convs
CALIB_IMAGES = 8               # calibration images, as JAX's images[:8]
P50_CALLS = 50                 # calls behind the decode+NMS median
BUSY_ITERS = 3                 # calls under torch.profiler per busy time


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def serving_variables(device: torch.device) -> dict:
    """The benched weights: init_yolov3 from a CPU torch.Generator seeded 0
    (the same bits on every device), then the seeded `spread_head`."""
    return spread_head(init_yolov3(torch.Generator().manual_seed(0),
                                   NUM_CLASSES, device=device), seed=0)


def bench_images(batch: int, size: Tuple[int, int],
                 device: torch.device) -> torch.Tensor:
    """The batch's images [batch, H, W, 3] in [0, 1] on `device`, from a
    generator on that device seeded with the batch size."""
    gen = torch.Generator(device=device).manual_seed(batch)
    return torch.rand((batch, size[0], size[1], 3), generator=gen,
                      device=device)


def packed_detector(variables: dict, size: Tuple[int, int],
                    device: torch.device) -> torch.nn.Module:
    """The timed bf16 detector: build_detector(mode="packed") at the
    serving config."""
    return build_detector(variables, np.asarray(DEFAULT_ANCHORS, np.float32),
                          NUM_CLASSES, size, device=device,
                          compute_dtype=torch.bfloat16, mode="packed",
                          **SERVING)


def p50_call(variables: dict, images: torch.Tensor,
             size: Tuple[int, int]) -> Callable[[], dict]:
    """The decode+NMS stage alone: a call of postprocess_prefilter at the
    P50 config on the bf16 folded forward's maps of `images`, computed
    here once."""
    anchors = np.asarray(DEFAULT_ANCHORS, np.float32)
    folded = fold_batch_norm(variables, dtype=torch.bfloat16)
    tables = decode_tables(size, anchors, device=images.device)
    with torch.inference_mode():
        fmaps = yolov3_forward_folded(folded, images,
                                      compute_dtype=torch.bfloat16)

    @torch.inference_mode()
    def call():
        return postprocess_prefilter(fmaps, anchors, NUM_CLASSES, size,
                                     tables=tables, **P50)

    return call


class _Counted:
    """A no-argument call that counts its calls."""

    def __init__(self, fn: Callable[[], object]):
        self.fn, self.calls = fn, 0

    def __call__(self):
        self.calls += 1
        return self.fn()


def _timed(det, images: torch.Tensor, device: torch.device,
           iters: Tuple[int, int]) -> Dict:
    """ms per batch (differential), img/s, device busy ms per batch (None
    on the CPU) and the requests made, of det on images."""
    call = _Counted(lambda: det(images))
    ms = differential_ms(call, device, *iters)
    busy = (device_busy_ms(call, BUSY_ITERS) if device.type == "cuda"
            else None)
    return {"batch": images.shape[0], "ms": ms,
            "img_per_sec": images.shape[0] * 1e3 / ms, "busy_ms": busy,
            "requests": call.calls}


def _busy_text(row: Dict) -> str:
    if row["busy_ms"] is None:
        return "device busy not measured on the CPU"
    return (f"device busy {row['busy_ms']:.3f} ms/batch, idle share "
            f"{1 - row['busy_ms'] / row['ms']:.3f}")


def run(size: Tuple[int, int], batches: List[int], iters: Tuple[int, int],
        device: torch.device) -> Dict:
    """Every measurement of the module docstring; returns the record."""
    variables = serving_variables(device)
    det = packed_detector(variables, size, device)
    record: Dict = {"size": list(size), "device": device_name(device),
                    "iters": list(iters), "bf16": []}
    for batch in batches:
        row = _timed(det, bench_images(batch, size, device), device, iters)
        record["bf16"].append(row)
        _log(f"bf16 batch {batch}: {row['img_per_sec']:.1f} img/s "
             f"({row['ms']:.3f} ms/batch; {_busy_text(row)})")
    best = max(record["bf16"], key=lambda r: r["img_per_sec"])
    batch = record["best_batch"] = best["batch"]
    record["best_mode"], best_ips = "bf16", best["img_per_sec"]

    images = bench_images(batch, size, device)
    calib = images[:CALIB_IMAGES]
    anchors = np.asarray(DEFAULT_ANCHORS, np.float32)
    stem8 = build_detector(variables, anchors, NUM_CLASSES, size,
                           device=device, mode="stem8",
                           calibration_images=calib,
                           stem_int8_upto=STEM_UPTO, **SERVING)
    row = record["stem8"] = _timed(stem8, images, device, iters)
    _log(f"stem-int8 hybrid (upto={STEM_UPTO}) batch {batch}: "
         f"{row['img_per_sec']:.1f} img/s ({row['ms']:.3f} ms/batch; "
         f"{_busy_text(row)})")
    if row["img_per_sec"] > best_ips:
        record["best_mode"], best_ips = "stem_int8_hybrid", row["img_per_sec"]
    del stem8
    int8, _ = build_detector_int8(variables, anchors, NUM_CLASSES, size,
                                  calibration_images=calib, device=device,
                                  mode="packed", **SERVING)
    row = record["int8"] = _timed(int8, images, device, iters)
    _log(f"int8 batch {batch}: {row['img_per_sec']:.1f} img/s "
         f"({row['ms']:.3f} ms/batch; {_busy_text(row)})")
    del int8

    counted = _Counted(p50_call(variables, images, size))
    samples = call_samples_ms(counted, device, P50_CALLS)
    p50 = statistics.median(samples)
    record["p50"] = {"batch": batch, "ms": p50, "ms_per_img": p50 / batch,
                     "calls": P50_CALLS, "p90_ms": float(np.percentile(
                         samples, 90)), "requests": counted.calls}
    _log(f"decode+NMS p50: {p50:.3f} ms/batch of {batch} "
         f"({p50 / batch:.4f} ms/img; p90 {record['p50']['p90_ms']:.3f} ms; "
         f"{P50_CALLS} calls)")
    record["value"] = best_ips
    record["requests"] = (sum(r["requests"] for r in record["bf16"])
                          + record["stem8"]["requests"]
                          + record["int8"]["requests"]
                          + record["p50"]["requests"])
    return record


def _ints(text: str) -> List[int]:
    return [int(v) for v in text.split(",") if v]


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--size", type=int, nargs=2, default=[416, 416],
                   metavar=("H", "W"),
                   help="inference resolution (e.g. --size 608 608 or "
                        "--size 896 1344); default 416 416 (the headline "
                        "configuration)")
    p.add_argument("--batches", type=str, default="",
                   help="comma-separated batch sizes (default: "
                        f"{','.join(map(str, CUDA_BATCHES))} on a GPU, "
                        f"{','.join(map(str, CPU_BATCHES))} on the CPU)")
    p.add_argument("--iters", type=str, default="",
                   help="n1,n2: calls of the two timed runs of each "
                        "differential (default "
                        f"{','.join(map(str, CUDA_ITERS))} on a GPU, "
                        f"{','.join(map(str, CPU_ITERS))} on the CPU)")
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda, cuda:N; cpu for the tests)")
    p.add_argument("--record", default="",
                   help="also write every measurement as JSON to this file")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    cuda = device.type == "cuda"
    size = (args.size[0], args.size[1])
    batches = _ints(args.batches) or list(CUDA_BATCHES if cuda
                                          else CPU_BATCHES)
    iters = tuple(_ints(args.iters)) or (CUDA_ITERS if cuda else CPU_ITERS)
    if len(iters) != 2:
        p.error(f"--iters takes n1,n2, got {args.iters!r}")
    _log(f"device: {device_name(device)}, size: {size[0]}x{size[1]}, "
         f"batches {batches}, iters {iters}")
    record = run(size, batches, iters, device)
    if args.record:
        with open(args.record, "w") as f:
            json.dump(record, f, indent=1)
    best = round(record["value"], 1)    # the ratio is of the printed rate
    print(json.dumps({
        "metric": "images_per_sec_416_inference",
        "value": best,
        "unit": "img/s",
        "vs_baseline": round(best / BASELINE_IMG_PER_SEC, 2),
        "mode": record["best_mode"],
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
