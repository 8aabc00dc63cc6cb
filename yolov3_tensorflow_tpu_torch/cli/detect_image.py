"""Single-image detection demo (counterpart of
`yolov3_tensorflow_tpu/cli/detect_image.py`).

Example:
  python -m yolov3_tensorflow_tpu_torch.cli.detect_image dog.jpg \
      --restore_path yolov3.weights --new_size 416 416
  (add --device cpu to run without a GPU)
"""

from __future__ import annotations

import argparse
import sys

import cv2
import numpy as np
import torch

from yolov3_tensorflow_tpu_torch.cli.common import (load_anchors,
                                                    load_classes,
                                                    load_variables,
                                                    resolve_device, str2bool)
from yolov3_tensorflow_tpu_torch.data.augment import letterbox_resize
from yolov3_tensorflow_tpu_torch.ops.postprocess import (
    SERVING_TABLES, build_auto_detector, build_detector, detections_to_numpy,
    select_serving_mode)
from yolov3_tensorflow_tpu_torch.ops.quantize import build_detector_int8
from yolov3_tensorflow_tpu_torch.utils.viz import (get_color_table,
                                                   plot_one_box)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="YOLOv3 single-image detection (PyTorch).")
    p.add_argument("input_image", type=str)
    p.add_argument("--anchor_path", type=str, default="")
    p.add_argument("--new_size", nargs="*", type=int, default=[416, 416],
                   help="input resolution [width, height]")
    p.add_argument("--letterbox_resize", type=str2bool, default=True)
    p.add_argument("--class_name_path", type=str, default="")
    p.add_argument("--restore_path", type=str, required=True,
                   help="darknet .weights file or a checkpoint directory "
                        "of this package")
    p.add_argument("--score_thresh", type=float, default=0.3)
    p.add_argument("--nms_thresh", type=float, default=0.45)
    p.add_argument("--max_boxes", type=int, default=200)
    p.add_argument("--mode", type=str, default="prefilter",
                   choices=["exact", "prefilter", "split", "packed",
                            "stem8", "int8", "auto"],
                   help="postprocess pipeline (ops.postprocess.build_detector)"
                        ": prefilter is exact at demo thresholds; packed is "
                        "the serving path, split the serving path with the "
                        "split head; stem8 int8-quantizes the early "
                        "backbone, int8 the whole network (both calibrate "
                        "on the input image); auto picks by resolution and "
                        "--quantize")
    p.add_argument("--quantize", type=str, default="hybrid",
                   choices=["none", "hybrid", "full"],
                   help="quantization budget for --mode auto: none (bf16 "
                        "packed), hybrid (up to stem8), full (up to int8); "
                        "select_serving_mode picks the fastest mode the "
                        "budget allows as the device type measured it "
                        "(never slower than bf16)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (cuda, cuda:N or cpu)")
    p.add_argument("--output", type=str, default="detection_result.jpg")
    p.add_argument("--show", action="store_true")
    return p


def preprocess(img_ori: np.ndarray, new_size, use_letterbox: bool):
    """BGR image -> network input [1, h, w, 3] fp32 in [0, 1] (numpy) and
    the inverse-transform params."""
    if use_letterbox:
        img, ratio, dw, dh = letterbox_resize(img_ori, new_size[0], new_size[1])
        inv = ("letterbox", ratio, dw, dh)
    else:
        img = cv2.resize(img_ori, tuple(new_size))
        h, w = img_ori.shape[:2]
        inv = ("plain", w / new_size[0], h / new_size[1], 0)
    img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB).astype(np.float32) / 255.0
    return img[None], inv


def invert_boxes(boxes: np.ndarray, inv) -> np.ndarray:
    """Map boxes from network-input coords back to original pixels."""
    boxes = boxes.copy()
    if inv[0] == "letterbox":
        _, ratio, dw, dh = inv
        boxes[:, [0, 2]] = (boxes[:, [0, 2]] - dw) / ratio
        boxes[:, [1, 3]] = (boxes[:, [1, 3]] - dh) / ratio
    else:
        _, sx, sy, _ = inv
        boxes[:, [0, 2]] *= sx
        boxes[:, [1, 3]] *= sy
    return boxes


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    anchors = load_anchors(args.anchor_path)
    classes = load_classes(args.class_name_path)
    num_classes = len(classes)
    color_table = get_color_table(num_classes)

    img_ori = cv2.imread(args.input_image)
    if img_ori is None:
        print(f"cannot read image: {args.input_image}", file=sys.stderr)
        return 1
    inp, inv = preprocess(img_ori, args.new_size, args.letterbox_resize)

    variables = load_variables(args.restore_path, num_classes, device)
    img_size = (args.new_size[1], args.new_size[0])
    common = dict(device=device, max_out=args.max_boxes,
                  score_thresh=args.score_thresh, iou_thresh=args.nms_thresh)
    # the quantized modes calibrate their activation scales on the input
    # image itself, the right choice for a one-image demo
    if args.mode == "auto":
        detect = build_auto_detector(
            variables, anchors, num_classes, img_size,
            quantize=args.quantize, calibration_images=inp, **common)
    elif args.mode == "int8":
        if select_serving_mode(img_size, quantize="full",
                               device=device) != "int8":
            print(f"warning: full int8 was measured SLOWER than bf16 at "
                  f"{img_size[0]}x{img_size[1]} in "
                  f"{SERVING_TABLES[device.type]} (the policy of "
                  f"ops.postprocess.select_serving_mode) - consider "
                  f"--mode auto", file=sys.stderr)
        detect, _ = build_detector_int8(
            variables, anchors, num_classes, img_size,
            calibration_images=inp, mode="packed", **common)
    else:
        detect = build_detector(
            variables, anchors, num_classes, img_size, mode=args.mode,
            calibration_images=inp if args.mode == "stem8" else None,
            **common)

    dets = detect(torch.from_numpy(inp))
    boxes, scores, labels = detections_to_numpy(dets, 0)
    boxes = invert_boxes(boxes, inv)

    print("box coords:")
    print(boxes)
    print("*" * 30)
    print("scores:")
    print(scores)
    print("*" * 30)
    print("labels:")
    print(labels)

    for box, score, label in zip(boxes, scores, labels):
        plot_one_box(img_ori, box,
                     label=f"{classes[int(label)]}, {score * 100:.2f}%",
                     color=color_table[int(label)])
    cv2.imwrite(args.output, img_ori)
    if args.show:
        cv2.imshow("Detection result", img_ori)
        cv2.waitKey(0)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
