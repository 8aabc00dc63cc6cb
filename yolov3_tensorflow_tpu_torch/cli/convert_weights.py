"""Convert darknet .weights to a checkpoint directory of this package
(counterpart of `yolov3_tensorflow_tpu/cli/convert_weights.py`).

  python -m yolov3_tensorflow_tpu_torch.cli.convert_weights \
      --weights yolov3.weights --output ./data/darknet_weights/yolov3_ckpt
  (loads on the GPU by default; add --device cpu to convert without one)

The checkpoint holds `params`, `batch_stats` and `step = 0` in the format of
`train.checkpoint.CheckpointStore`, which `cli.common.load_variables`, the
CLIs' `--restore_path` and `train.restore_path` read.
"""

from __future__ import annotations

import argparse
import os

import torch

from yolov3_tensorflow_tpu_torch.cli.common import (load_classes,
                                                    resolve_device)
from yolov3_tensorflow_tpu_torch.models.yolov3 import init_yolov3
from yolov3_tensorflow_tpu_torch.train.checkpoint import CheckpointStore
from yolov3_tensorflow_tpu_torch.train.optimizers import flatten
from yolov3_tensorflow_tpu_torch.utils.weights import load_darknet_weights


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="darknet .weights -> checkpoint")
    p.add_argument("--weights", type=str, required=True)
    p.add_argument("--output", type=str, required=True,
                   help="checkpoint directory to create")
    p.add_argument("--class_name_path", type=str, default="")
    p.add_argument("--num_classes", type=int, default=0,
                   help="override class count (default: from names file/80)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to load on (cuda, cuda:N or cpu)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    num_classes = args.num_classes or len(load_classes(args.class_name_path))
    fresh = init_yolov3(torch.Generator().manual_seed(0), num_classes,
                        device=device)
    variables = load_darknet_weights(fresh, args.weights, num_classes)

    out = os.path.abspath(args.output)
    store = CheckpointStore(os.path.dirname(out))
    store.save(os.path.basename(out),
               {"params": variables["params"],
                "batch_stats": variables["batch_stats"], "step": 0})
    total = sum(t.numel() for t in flatten(variables).values())
    print(f"converted {total} parameters -> {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
