"""Training-step throughput and MFU on one GPU.

Counterpart of the JAX package's `scripts/bench_train.py`. Times the train
step (`train.trainer.make_train_step`: forward, loss, backward, clip,
optimizer and the new BN statistics) of the reference recipe (`Config()`
with no frozen part and no restore exclusion; the schedule derived for
117000 images) at several batch sizes on device-resident data: random
images and all-zero label grids made once on the device, so the number is
the step alone. The host loader is benchmarked by `bench_loader`.

Timing: steps chain through the state each returns; ms per step is
`utils.profiling.differential_ms` ((T(n2) - T(n1)) / (n2 - n1), the least
of 3, torch.cuda.synchronize as the sync; n1, n2 from `--iters`), host
gaps included. Beside it the device's busy time per step
(`device_busy_ms`) and the idle share 1 - busy / ms.

MFU = model FLOPs per step / (step time * peak). The FLOPs are the
roofline's count (`scripts/roofline.py`: `train_cost(walk(batch, img,
img))`, three times each conv's forward FLOPs; batch norm, the loss and
the optimizer are not counted); the JAX script took XLA's cost analysis
of its compiled step, which has no counterpart here, hence the key
`model_flops_per_step`. The peak is the H100 SXM's published dense bf16
rate, 989 TF/s (`roofline.H100_PEAKS`).

Prints one stderr line per batch and, last, one JSON line
`{"metric": "train_step_416", "rows": [{"batch", "ms_per_step",
"img_per_sec", "model_flops_per_step", "mfu_vs_bf16_peak", "busy_ms",
"idle_share"}, ...]}` (mfu_vs_bf16_peak, busy_ms and idle_share are null
on the CPU: no device was timed).

  python -m yolov3_tensorflow_tpu_torch.scripts.bench_train \\
      [--batches 8,16,32,64] [--img 416] [--iters 4,16] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from yolov3_tensorflow_tpu_torch.cli.common import resolve_device
from yolov3_tensorflow_tpu_torch.config import Config
from yolov3_tensorflow_tpu_torch.models.yolov3 import init_yolov3
from yolov3_tensorflow_tpu_torch.scripts.roofline import (H100_PEAKS,
                                                          train_cost, walk)
from yolov3_tensorflow_tpu_torch.train.optimizers import build_optimizer
from yolov3_tensorflow_tpu_torch.train.schedules import build_schedule
from yolov3_tensorflow_tpu_torch.train.trainer import make_train_step
from yolov3_tensorflow_tpu_torch.utils.profiling import (device_busy_ms,
                                                         differential_ms)

PEAK_BF16_FLOPS = H100_PEAKS["bf16"]   # H100 SXM, dense, published
ITERS = (4, 16)                        # the JAX script's n1, n2
BUSY_ITERS = 3                         # steps under torch.profiler


def reference_config() -> Config:
    """The reference recipe as the JAX benchmarks set it: nothing frozen,
    nothing excluded from a restore, the schedule derived for 117000
    images (COCO train2017) in 1000 batches."""
    cfg = Config()
    cfg.train.update_part = None
    cfg.train.restore_exclude = None
    cfg.train_img_cnt = 117000         # schedule derivations only
    cfg.train_batch_num = 1000
    return cfg.finalize(count_files=False)


def train_setup(cfg: Config):
    """(make_train_step(cfg, optimizer), optimizer) for the reference
    recipe's optimizer and schedule."""
    schedule = build_schedule(cfg)
    optimizer = build_optimizer(cfg.train.optimizer, schedule,
                                momentum=cfg.train.momentum,
                                grad_clip_norm=cfg.train.grad_clip_norm)
    return make_train_step(cfg, optimizer), optimizer


def fresh_state(optimizer, num_classes: int, device: torch.device) -> Dict:
    """The seed-0 init_yolov3 tree (drawn on the CPU, the same bits on every
    device) on `device`, with its optimizer state, at step 0."""
    v = init_yolov3(torch.Generator().manual_seed(0), num_classes,
                    device=device)
    return {"params": v["params"], "batch_stats": v["batch_stats"],
            "opt_state": optimizer.init(v["params"]), "step": 0}


def model_flops(batch: int, size: int, num_classes: int) -> float:
    """The train step's model FLOPs: 3x every conv's forward FLOPs of the
    roofline walk."""
    return sum(f for _, f, _ in train_cost(walk(batch, size, size,
                                                num_classes)))


def bench_batch(cfg: Config, step, optimizer, batch: int, size: int,
                iters: Tuple[int, int], device: torch.device,
                rng: np.random.Generator) -> Dict:
    """One row: the step at `batch` on fresh seed-0 state."""
    c = cfg.model.num_classes
    state = fresh_state(optimizer, c, device)
    images = torch.from_numpy(rng.uniform(0, 1, (batch, size, size, 3))
                              .astype(np.float32)).to(device)
    y_true = tuple(torch.zeros((batch, size // s, size // s, 3, 6 + c),
                               device=device) for s in (32, 16, 8))
    holder = [state]

    def one_step():
        holder[0], metrics = step(holder[0], images, y_true)
        return metrics

    dt = differential_ms(one_step, device, *iters) / 1e3
    busy = (device_busy_ms(one_step, BUSY_ITERS) if device.type == "cuda"
            else None)
    flops = model_flops(batch, size, c)
    # a share of the H100's peak only for a time taken on a GPU
    mfu = (round(flops / dt / PEAK_BF16_FLOPS, 3) if device.type == "cuda"
           else None)
    return {"batch": batch, "ms_per_step": round(dt * 1e3, 2),
            "img_per_sec": round(batch / dt, 1),
            "model_flops_per_step": flops,
            "mfu_vs_bf16_peak": mfu,
            "busy_ms": None if busy is None else round(busy, 3),
            "idle_share": (None if busy is None
                           else round(1 - busy / (dt * 1e3), 3))}


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batches", type=str, default="8,16,32,64")
    p.add_argument("--img", type=int, default=416)
    p.add_argument("--iters", type=str, default=",".join(map(str, ITERS)),
                   help="n1,n2: steps of the two timed runs of each "
                        "differential")
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda, cuda:N; cpu for the tests)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    iters = tuple(int(v) for v in args.iters.split(","))
    if len(iters) != 2:
        p.error(f"--iters takes n1,n2, got {args.iters!r}")

    cfg = reference_config()
    step, optimizer = train_setup(cfg)
    rng = np.random.default_rng(0)
    rows = []
    for batch in (int(b) for b in args.batches.split(",")):
        row = bench_batch(cfg, step, optimizer, batch, args.img, iters,
                          device, rng)
        rows.append(row)
        device_text = (
            "MFU, device busy: not measured on the CPU"
            if row["busy_ms"] is None
            else f"MFU {row['mfu_vs_bf16_peak'] * 100:5.1f}%  busy "
                 f"{row['busy_ms']:8.3f} ms  idle {row['idle_share']:.3f}")
        print(f"batch {batch:3d}: {row['ms_per_step']:8.2f} ms/step  "
              f"{row['img_per_sec']:8.1f} img/s  {device_text}",
              file=sys.stderr, flush=True)
        if device.type == "cuda":
            torch.cuda.empty_cache()

    print(json.dumps({"metric": "train_step_416", "rows": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
