"""Training entry point (counterpart of `yolov3_tensorflow_tpu/cli/train.py`).

  python -m yolov3_tensorflow_tpu_torch.cli.train \
      --config configs/voc.json train.batch_size=32 data.train_file=train.txt
  (on the GPU by default; add --device cpu to train without one)
"""

from __future__ import annotations

import argparse

from yolov3_tensorflow_tpu_torch.cli.common import resolve_device
from yolov3_tensorflow_tpu_torch.config import load_config
from yolov3_tensorflow_tpu_torch.train.trainer import Trainer

MULTIHOST_FLAGS = ("coordinator_address", "num_processes", "process_id")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Train YOLOv3 (PyTorch).",
        epilog="Any config field can be overridden positionally as "
               "section.key=value, e.g. train.batch_size=32")
    p.add_argument("--config", type=str, default="",
                   help="optional JSON config file")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to train on (cuda, cuda:1, cpu)")
    # the JAX package's multi-host flags: parsed so that its command lines
    # give a clear refusal
    for flag in MULTIHOST_FLAGS:
        p.add_argument(f"--{flag}", type=str, default=None,
                       help="multi-host training: not ported yet")
    p.add_argument("overrides", nargs="*", default=[])
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    given = [f"--{f}" for f in MULTIHOST_FLAGS if getattr(args, f) is not None]
    if given:
        raise SystemExit(f"{', '.join(given)}: multi-host training is not "
                         f"ported yet (ROADMAP queue 1, item 11)")
    device = resolve_device(args.device)
    cfg = load_config(args.config or None, args.overrides).finalize()
    trainer = Trainer(cfg, seed=args.seed, device=device)
    try:
        trainer.fit()
    finally:
        trainer.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
