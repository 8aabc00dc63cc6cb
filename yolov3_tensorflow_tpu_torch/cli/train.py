"""Training entry point (counterpart of `yolov3_tensorflow_tpu/cli/train.py`).

  python -m yolov3_tensorflow_tpu_torch.cli.train \
      --config configs/voc.json train.batch_size=32 data.train_file=train.txt
  (on the GPU by default; add --device cpu to train without one)

Data-parallel training runs one process per device, each started with the
same arguments and its own --process_id (or under torchrun, which sets the
rank in the environment), with train.num_data_parallel set to the number of
processes:

  python -m yolov3_tensorflow_tpu_torch.cli.train --num_processes 2 \
      --process_id 0 --coordinator_address 10.0.0.1:29500 \
      train.num_data_parallel=2 ...
"""

from __future__ import annotations

import argparse

import torch.distributed as dist

from yolov3_tensorflow_tpu_torch.cli.common import resolve_device
from yolov3_tensorflow_tpu_torch.config import load_config
from yolov3_tensorflow_tpu_torch.parallel.multihost import \
    initialize_distributed
from yolov3_tensorflow_tpu_torch.train.trainer import Trainer


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Train YOLOv3 (PyTorch).",
        epilog="Any config field can be overridden positionally as "
               "section.key=value, e.g. train.batch_size=32")
    p.add_argument("--config", type=str, default="",
                   help="optional JSON config file")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to train on (cuda, cuda:1, cpu); in a "
                        "multi-process run cuda means cuda:LOCAL_RANK")
    # multi-process bring-up; under torchrun these come from the
    # environment instead
    p.add_argument("--coordinator_address", type=str, default=None,
                   help="host:port of process 0, or a file:// URL every "
                        "process can reach, for torch.distributed")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("overrides", nargs="*", default=[])
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = initialize_distributed(
        coordinator_address=args.coordinator_address,
        num_processes=args.num_processes, process_id=args.process_id,
        device=resolve_device(args.device))
    try:
        cfg = load_config(args.config or None, args.overrides).finalize()
        trainer = Trainer(cfg, seed=args.seed, device=device)
        try:
            trainer.fit()
        finally:
            trainer.close()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
