"""What the serving experiments share (`exp_score`, `exp_topk`,
`exp_tail`, `exp_pp_incr`, `exp_postprocess`, `exp_stem_int8`,
`exp_highres_int8`): their common flags, the benched weights and packed
head outputs, the timed row and the output.

Every experiment times the card by default (`--device cuda`; asking for
CUDA where there is none exits, nothing falls back to the CPU), on
`scripts.bench.serving_variables` (init_yolov3 seed 0 plus the seeded
`spread_head`) and `scripts.bench.bench_images`.

A row is `utils.profiling.differential_ms` with `--iters n1,n2` (a call's
cost, host gaps included; no scalar is fed back through the calls as in
the JAX scripts: eager PyTorch elides no call), with the device's busy
time per call (`device_busy_ms`) and the idle share 1 - busy / ms beside
it, with its sign (below 0 where the differential reads below the busy
time), and, for a stage timed alone, the device's own time (`cuda_ms`).
Off the card only the host's time is written: busy, idle and device time
are null. A row
counts its calls, and those of them that launch the shared-candidate NMS
kernel (K1), so that a caller can hold the kernel's launch count to them.
A JAX variant with no counterpart in the port is a row with no number
that says why.

Each experiment prints its rows, then one JSON line last ({"script",
"device", "batch", "size", "iters", "rows", ...}), which it also writes
to `--out` (default `build/experiments/<script>.json`).
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from yolov3_tensorflow_tpu_torch.cli.common import device_name, resolve_device
from yolov3_tensorflow_tpu_torch.ops.fast_postprocess import \
    yolov3_forward_packed
from yolov3_tensorflow_tpu_torch.scripts import bench
from yolov3_tensorflow_tpu_torch.utils.profiling import (cuda_ms,
                                                         device_busy_ms,
                                                         differential_ms)

NUM_CLASSES = bench.NUM_CLASSES
SERVING = bench.SERVING                # max_out 128, box_topk 64, 0.3, 0.45
CUDA_ITERS = (5, 25)                   # the JAX scripts' n1, n2
CPU_ITERS = (1, 3)
BUSY_ITERS = 3                         # calls under torch.profiler
DEVICE_ITERS = 20                      # calls behind a cuda_ms reading
OUT_DIR = os.path.join("build", "experiments")


def parser(doc: str, *, batch: int, size: Tuple[int, int] = (416, 416),
           iters: Tuple[int, int] = CUDA_ITERS) -> argparse.ArgumentParser:
    """The flags every experiment takes: --batch, --size, --iters,
    --device and --out."""
    p = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=batch)
    p.add_argument("--size", type=int, nargs=2, default=list(size),
                   metavar=("H", "W"), help="inference resolution")
    p.add_argument("--iters", type=str, default="",
                   help="n1,n2: calls of the two timed runs of each "
                        f"differential (default {iters[0]},{iters[1]} on a "
                        f"GPU, {CPU_ITERS[0]},{CPU_ITERS[1]} on the CPU)")
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda, cuda:N; cpu for the tests)")
    p.add_argument("--out", default="",
                   help=f"JSON record (default {OUT_DIR}/<script>.json)")
    p.set_defaults(cuda_iters=tuple(iters))
    return p


class Run:
    """One experiment's parsed flags, device and rows."""

    def __init__(self, script: str, p: argparse.ArgumentParser,
                 argv: Optional[List[str]]):
        self.args = args = p.parse_args(argv)
        self.script = script
        self.device = resolve_device(args.device)
        self.cuda = self.device.type == "cuda"
        self.card = device_name(self.device)
        iters = tuple(int(v) for v in args.iters.split(",") if v)
        if not iters:
            iters = args.cuda_iters if self.cuda else CPU_ITERS
        if len(iters) != 2:
            p.error(f"--iters takes n1,n2, got {args.iters!r}")
        self.iters = iters
        self.size = (args.size[0], args.size[1])
        self.batch = args.batch
        self.out = args.out or os.path.join(OUT_DIR, f"{script}.json")
        self.rows: List[Dict[str, Any]] = []

    def row(self, name: str, fn: Callable[[], Any], *, nms: bool = False,
            alone: bool = False, batch: Optional[int] = None,
            **extra) -> Dict[str, Any]:
        """Time fn() (see the module docstring) and print the row.
        nms: each call launches K1 once. alone: also the device's own time
        (cuda_ms). batch: also the images a second of a call that serves
        that many."""
        calls = [0]

        def call():
            calls[0] += 1
            return fn()

        ms = differential_ms(call, self.device, *self.iters)
        busy = device_busy_ms(call, BUSY_ITERS) if self.cuda else None
        dev = cuda_ms(call, DEVICE_ITERS) if self.cuda and alone else None
        row = {"name": name, "ms": ms, "busy_ms": busy,
               "idle_share": None if busy is None else 1 - busy / ms,
               "device_ms": dev, "calls": calls[0],
               "nms_calls": calls[0] if nms else 0, **extra}
        if batch is not None:
            row["batch"], row["img_per_sec"] = batch, batch * 1e3 / ms
        self.rows.append(row)
        print(self.text(row), flush=True)
        return row

    def no_counterpart(self, name: str, why: str,
                       key: str = "no_counterpart") -> Dict[str, Any]:
        """The row, with no number, of a JAX variant the port has no
        counterpart of (or, with key="refused", of one it refuses)."""
        row = {"name": name, "ms": None, key: why}
        self.rows.append(row)
        print(f"{name:<34s} {key.replace('_', ' ')}: {why}", flush=True)
        return row

    def text(self, row: Dict[str, Any]) -> str:
        parts = [f"{row['name']:<34s} {row['ms']:9.3f} ms"]
        if "img_per_sec" in row:
            parts.append(f"{row['img_per_sec']:8.1f} img/s")
        if row["device_ms"] is not None:
            parts.append(f"device {row['device_ms']:.4f} ms")
        if row["busy_ms"] is None:
            parts.append("busy not measured off the card")
        else:
            parts.append(f"busy {row['busy_ms']:.3f} ms, idle "
                         f"{row['idle_share']:.3f}")
        return "  ".join(parts) + f"  [{self.card}]"

    def nms_calls(self) -> int:
        return sum(r.get("nms_calls", 0) for r in self.rows)

    def finish(self, **extra) -> int:
        """Write the record to --out and print it as the last line."""
        record = {"script": self.script, "device": self.card,
                  "batch": self.batch, "size": list(self.size),
                  "iters": list(self.iters), "rows": self.rows, **extra}
        record.setdefault("nms_calls", self.nms_calls())
        os.makedirs(os.path.dirname(os.path.abspath(self.out)),
                    exist_ok=True)
        with open(self.out, "w") as f:
            json.dump(record, f, indent=1)
        print(json.dumps(record), flush=True)
        return 0


def packed_setup(batch: int, size: Tuple[int, int], device: torch.device):
    """The benched bf16 packed detector (`bench.packed_detector` on
    `bench.serving_variables`), a batch of `bench.bench_images` and the
    detector's packed head outputs on it. Returns (variables, detector,
    images, packed outputs)."""
    variables = bench.serving_variables(device)
    det = bench.packed_detector(variables, size, device)
    images = bench.bench_images(batch, size, device)
    with torch.inference_mode():
        outs = yolov3_forward_packed(det.packed, images,
                                     compute_dtype=torch.bfloat16)
    return variables, det, images, outs
