"""Stage-by-stage train-step profiler on one GPU.

Counterpart of the JAX package's `scripts/profile_train.py`. Splits the
train step into incremental stages, each a closure over device tensors,
timed alone:

  fwd(train)      training-mode forward (BN batch statistics) only
  loss(fmaps)     the fp32 YOLO loss from precomputed feature maps
                  (with the ignore mask's fixed-capacity top-k)
  fwd+loss        forward + loss, value only
  grad(fwd+bwd)   autograd of fwd+loss + the L2 term w.r.t. every param
  opt(grads)      optimizer update + apply_updates from precomputed grads
  l2(params)      the weight-decay reduction alone
  full step       train.trainer.make_train_step (the production step)

of the reference recipe (`bench_train.reference_config`) on seeded random
images and label grids (uniform in [0, 0.01], as the JAX script's).

Per stage: ms per batch (`utils.profiling.differential_ms`, host gaps
included; n1, n2 from `--iters`), img/s, the roofline's FLOPs
(`scripts/roofline.py`: the forward rows of `walk` for the forward
stages, three times them for grad and the full step, none for the loss,
the optimizer and the L2 term; the JAX script read XLA's count of each
compiled stage) and the MFU they imply against the H100 SXM's published
dense bf16 peak (989 TF/s); and beside them the device's busy ms per call
(`device_busy_ms`) and the host gap, ms - busy: the step's host time by
stage. Then JAX's three derived lines (loss attach, bwd cost, step
scaffolding). On the CPU (`--device cpu`, for the tests) the MFU, busy
time and host gap are not measured. `--record` writes every number as
JSON.

  python -m yolov3_tensorflow_tpu_torch.scripts.profile_train \\
      [--batch 32] [--size 416] [--iters 5,20] [--device cuda] \\
      [--record f.json]
"""

from __future__ import annotations

import argparse
import json
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from yolov3_tensorflow_tpu_torch.cli.common import device_name, resolve_device
from yolov3_tensorflow_tpu_torch.config import Config
from yolov3_tensorflow_tpu_torch.models.yolov3 import yolov3_forward
from yolov3_tensorflow_tpu_torch.ops.losses import (compute_loss,
                                                    l2_regularization)
from yolov3_tensorflow_tpu_torch.scripts.bench_train import (
    PEAK_BF16_FLOPS, fresh_state, reference_config, train_setup)
from yolov3_tensorflow_tpu_torch.scripts.roofline import walk
from yolov3_tensorflow_tpu_torch.train.optimizers import (apply_updates,
                                                          flatten, unflatten)
from yolov3_tensorflow_tpu_torch.train.trainer import compute_dtype_of
from yolov3_tensorflow_tpu_torch.utils.profiling import (device_busy_ms,
                                                         differential_ms)

ITERS = (5, 20)                        # the JAX script's n1, n2
BUSY_ITERS = 3                         # calls under torch.profiler
Stage = Tuple[str, Callable[[], object], float]   # (name, call, FLOPs)


def train_inputs(batch: int, size: int, num_classes: int,
                 device: torch.device, seed: int = 0):
    """(images [B, S, S, 3] in [0, 1], the 3 label grids uniform in
    [0, 0.01]) from a numpy generator, on `device`."""
    rng = np.random.default_rng(seed)
    images = torch.from_numpy(rng.uniform(0, 1, (batch, size, size, 3))
                              .astype(np.float32)).to(device)
    c = 6 + num_classes
    y_true = tuple(torch.from_numpy(
        rng.uniform(0, 0.01, (batch, size // s, size // s, 3, c))
        .astype(np.float32)).to(device) for s in (32, 16, 8))
    return images, y_true


def stages(cfg: Config, step, optimizer, state: Dict, images: torch.Tensor,
           y_true) -> List[Stage]:
    """The stages of the module docstring, in its order, as closures over
    `state`, `images` and `y_true` (each leaves them unchanged), with the
    roofline's FLOPs of one call."""
    m = cfg.model
    anchors = np.asarray(cfg.anchors, np.float32)
    size = (images.shape[1], images.shape[2])
    dtype = compute_dtype_of(cfg)
    params, stats = state["params"], state["batch_stats"]
    fwd_flops = sum(f for _, f, _ in walk(images.shape[0], size[0], size[1],
                                          m.num_classes))

    def fwd(p):
        return yolov3_forward({"params": p, "batch_stats": stats}, images,
                              train=True, compute_dtype=dtype,
                              bn_momentum=m.batch_norm_decay,
                              bn_eps=m.batch_norm_epsilon)

    def loss_of(fmaps):
        return compute_loss(fmaps, y_true, anchors, m.num_classes, size,
                            use_label_smooth=m.use_label_smooth,
                            use_focal_loss=m.use_focal_loss,
                            max_gt=cfg.data.max_boxes_per_image,
                            box_loss=m.box_loss)["total"]

    def grads_of(with_l2: bool) -> Dict[str, torch.Tensor]:
        live = {k: v.detach().requires_grad_(True)
                for k, v in flatten(params).items()}
        with torch.enable_grad():
            p = unflatten(live)
            total = loss_of(fwd(p)[0])
            if with_l2:
                total = total + l2_regularization(p, m.weight_decay)
            grads = torch.autograd.grad(total, list(live.values()))
        return dict(zip(live, grads))

    fmaps = fwd(params)[0]
    grads = grads_of(False)

    def opt():
        updates, _ = optimizer.update(grads, state["opt_state"])
        return apply_updates(params, updates)

    return [
        ("fwd(train)", lambda: fwd(params)[0], fwd_flops),
        ("loss(fmaps)", lambda: loss_of(fmaps), 0.0),
        ("fwd+loss", lambda: loss_of(fwd(params)[0]), fwd_flops),
        ("grad(fwd+bwd)", lambda: grads_of(True), 3 * fwd_flops),
        ("opt(grads)", opt, 0.0),
        ("l2(params)", lambda: l2_regularization(params, m.weight_decay),
         0.0),
        ("full step", lambda: step(state, images, y_true)[1]["total"],
         3 * fwd_flops),
    ]


def profile(batch: int, size: int, iters: Tuple[int, int],
            device: torch.device) -> List[Dict]:
    """One row per stage of the reference recipe: {"stage", "ms",
    "img_per_sec", "flops", "mfu", "busy_ms", "host_gap_ms"} (the last
    three None on the CPU)."""
    cfg = reference_config()
    step, optimizer = train_setup(cfg)
    state = fresh_state(optimizer, cfg.model.num_classes, device)
    images, y_true = train_inputs(batch, size, cfg.model.num_classes, device)
    rows = []
    for name, fn, flops in stages(cfg, step, optimizer, state, images,
                                  y_true):
        ms = differential_ms(fn, device, *iters)
        row = {"stage": name, "ms": ms, "img_per_sec": batch * 1e3 / ms,
               "flops": flops, "mfu": None, "busy_ms": None,
               "host_gap_ms": None}
        if device.type == "cuda":
            busy = device_busy_ms(fn, BUSY_ITERS)
            row.update(mfu=flops / (ms * 1e-3) / PEAK_BF16_FLOPS,
                       busy_ms=busy, host_gap_ms=ms - busy)
        rows.append(row)
        print(report_line(row), flush=True)
    return rows


def report_line(row: Dict) -> str:
    text = (f"{row['stage']:<14s} {row['ms']:8.2f} ms/batch  "
            f"{row['img_per_sec']:7.1f} img/s   model "
            f"{row['flops'] / 1e12:6.2f} TFLOP")
    if row["mfu"] is None:
        return text + "  MFU, busy, host gap: not measured on the CPU"
    return (text + f"  MFU {row['mfu'] * 100:5.1f}%   busy "
            f"{row['busy_ms']:8.2f} ms  host gap {row['host_gap_ms']:8.2f} "
            f"ms")


def derived(rows: List[Dict]) -> List[str]:
    """The JAX script's derived lines (ms/batch)."""
    t = {r["stage"]: r["ms"] for r in rows}
    return [
        "derived (ms/batch):",
        f"  loss attach overhead (fwd+loss - fwd):   "
        f"{t['fwd+loss'] - t['fwd(train)']:7.2f}",
        f"  bwd cost        (grad - fwd+loss):       "
        f"{t['grad(fwd+bwd)'] - t['fwd+loss']:7.2f}",
        f"  step scaffolding (full - grad - opt):    "
        f"{t['full step'] - t['grad(fwd+bwd)'] - t['opt(grads)']:7.2f}",
    ]


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--size", type=int, default=416)
    p.add_argument("--iters", type=str, default=",".join(map(str, ITERS)),
                   help="n1,n2: calls of the two timed runs of each "
                        "differential")
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda, cuda:N; cpu for the tests)")
    p.add_argument("--record", default="",
                   help="also write the rows as JSON to this file")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    iters = tuple(int(v) for v in args.iters.split(","))
    if len(iters) != 2:
        p.error(f"--iters takes n1,n2, got {args.iters!r}")
    name = device_name(device)
    print(f"device: {name}; batch {args.batch} @ {args.size}^2, reference "
          f"recipe", flush=True)
    rows = profile(args.batch, args.size, iters, device)
    print()
    for line in derived(rows):
        print(line, flush=True)
    if args.record:
        with open(args.record, "w") as f:
            json.dump({"device": name, "batch": args.batch,
                       "size": args.size, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
