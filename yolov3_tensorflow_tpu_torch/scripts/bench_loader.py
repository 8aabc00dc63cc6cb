"""Host data-pipeline throughput: images/s through the real DataLoader.

Counterpart of the JAX package's `scripts/bench_loader.py`. The device
benchmarks (`bench`, `bench_train`) use device-resident data; this one
measures the other half, on the host's threads: annotation parse, cv2
imread, the augmentation chain, label encoding and batch assembly, so the
training picture is honest about where the input pipeline saturates. The
Trainer overlaps it with the device's step through the prefetch queue, so
training runs at about min(step rate, this rate).

On the deterministic synthetic dataset (`data/synthetic.py`, 416x416
jpgs, no external data), in the JAX script's five modes at each thread
count: train, train + mixup, val (letterboxed), device-augment (the host
decodes and draws the parameters, the pixels are made on the device;
tiles staged at 416) and + device-encode (the label grids too). Epoch 0
of each warms the page cache; `--epochs` more are timed. One line per
thread count, as the JAX script's.

The loader itself runs on the host. `--device` names the GPU the batches
are for: asking for CUDA where there is none fails, so a run never
reports a machine without its card. The dataset goes to `--out_dir`, or
to a temporary directory deleted at the end.

  python -m yolov3_tensorflow_tpu_torch.scripts.bench_loader \\
      [--threads 4,8,16] [--images 200] [--batch 8] [--epochs 3] \\
      [--out_dir DIR] [--device cuda]
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from yolov3_tensorflow_tpu_torch.cli.common import resolve_device
from yolov3_tensorflow_tpu_torch.config import DEFAULT_ANCHORS
from yolov3_tensorflow_tpu_torch.data.loader import DataLoader
from yolov3_tensorflow_tpu_torch.data.synthetic import generate_dataset

SIZE = (416, 416)
# name -> (loader mode, mixup, device_augment, device_encode)
MODES = {
    "train": ("train", False, False, False),
    "train+mixup": ("train", True, False, False),
    "val": ("val", False, False, False),
    "device-augment": ("train", True, True, False),
    "+device-encode": ("train", True, True, True),
}


def count_images(annotation_file: str, mode: str, threads: int, batch: int,
                 epochs: int) -> Tuple[List[int], float]:
    """Images per timed epoch of one loader mode (MODES), and the seconds
    the timed epochs took, after epoch 0 warms the page cache."""
    split, mixup, dev_aug, dev_enc = MODES[mode]
    loader = DataLoader(annotation_file, 3,
                        np.asarray(DEFAULT_ANCHORS, np.float32), batch, SIZE,
                        mode=split, letterbox=(split == "val"),
                        num_threads=threads, use_mix_up=mixup,
                        device_augment=dev_aug, staged_size=SIZE[0],
                        device_encode=dev_enc)
    for _ in loader.epoch(0):
        pass
    counts = []
    t0 = time.perf_counter()
    for ep in range(1, epochs + 1):
        counts.append(sum((b.images if b.images is not None
                           else b.staged).shape[0] for b in loader.epoch(ep)))
    return counts, time.perf_counter() - t0


def rates(annotation_file: str, threads: int, batch: int,
          epochs: int) -> Dict[str, float]:
    """Images/s of every mode at one thread count."""
    out = {}
    for mode in MODES:
        counts, seconds = count_images(annotation_file, mode, threads, batch,
                                       epochs)
        out[mode] = sum(counts) / seconds
    return out


def run(out_dir: str, args) -> None:
    data = generate_dataset(os.path.join(out_dir, "data"),
                            num_images=args.images, seed=0, img_size=SIZE)
    print(f"host: {os.cpu_count()} cpus; dataset {args.images} x "
          f"{SIZE[0]}x{SIZE[1]} jpgs, batch {args.batch}", flush=True)
    for threads in (int(t) for t in args.threads.split(",")):
        r = rates(data["annotation_file"], threads, args.batch, args.epochs)
        print(f"threads {threads:3d}: train {r['train']:7.1f} img/s | "
              f"train+mixup {r['train+mixup']:7.1f} | val {r['val']:7.1f} | "
              f"device-augment {r['device-augment']:7.1f} | +device-encode "
              f"{r['+device-encode']:7.1f}", flush=True)


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--threads", type=str, default="4,8,16")
    p.add_argument("--images", type=int, default=200,
                   help="synthetic dataset size")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--epochs", type=int, default=3,
                   help="timed epochs per mode (epoch 0, before them, warms "
                        "the page cache)")
    p.add_argument("--out_dir", default="",
                   help="where the dataset goes (default: a temporary "
                        "directory, deleted at the end)")
    p.add_argument("--device", default="cuda",
                   help="the GPU the batches are for (cuda, cuda:N; cpu for "
                        "the tests)")
    args = p.parse_args(argv)
    resolve_device(args.device)
    if args.out_dir:
        run(args.out_dir, args)
    else:
        with tempfile.TemporaryDirectory(prefix="loader_bench_") as tmp:
            run(tmp, args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
