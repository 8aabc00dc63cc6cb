"""Strip optimizer slots from a training checkpoint (counterpart of
`yolov3_tensorflow_tpu/cli/strip_checkpoint.py`).

  python -m yolov3_tensorflow_tpu_torch.cli.strip_checkpoint \
      --input ./ckpt/best_model_... --output ./ckpt/best_model_infer

A file-format tool: the tensors pass through the host, no device is used.
"""

from __future__ import annotations

import argparse
import os

from yolov3_tensorflow_tpu_torch.train.checkpoint import (CheckpointStore,
                                                          strip_optimizer)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="drop optimizer state from ckpt")
    p.add_argument("--input", type=str, required=True)
    p.add_argument("--output", type=str, required=True)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    in_path = os.path.abspath(args.input)
    out_path = os.path.abspath(args.output)
    store = CheckpointStore(os.path.dirname(out_path))
    state = store.restore(in_path)
    stripped = strip_optimizer(state)
    store.save(os.path.basename(out_path), stripped)
    print(f"stripped checkpoint -> {out_path} "
          f"(kept: {sorted(stripped.keys())})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
