"""Compute prior anchors with IoU k-means (counterpart of
`yolov3_tensorflow_tpu/cli/kmeans_anchors.py`; host numpy only, no device).

  python -m yolov3_tensorflow_tpu_torch.cli.kmeans_anchors train.txt \
      --target_size 416 416 --clusters 9
"""

from __future__ import annotations

import argparse

from yolov3_tensorflow_tpu_torch.utils.kmeans import (anchors_to_string,
                                                      kmeans_anchors,
                                                      parse_annotation_sizes)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="IoU k-means anchor selection")
    p.add_argument("annotation_file", type=str)
    p.add_argument("--target_size", nargs="*", type=int, default=[416, 416],
                   help="letterbox-scale boxes to this (width, height); "
                        "pass empty to use original image scale")
    p.add_argument("--clusters", type=int, default=9)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--output", type=str, default="",
                   help="optionally write the anchor string to this file")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    target = tuple(args.target_size) if args.target_size else None
    sizes = parse_annotation_sizes(args.annotation_file, target)
    anchors, avg_iou = kmeans_anchors(sizes, args.clusters, seed=args.seed)
    text = anchors_to_string(anchors)
    print("anchors are:")
    print(text)
    print("the average iou is:")
    print(avg_iou)
    if args.output:
        with open(args.output, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
