"""Streaming video detection demo (counterpart of
`yolov3_tensorflow_tpu/cli/detect_video.py`).

- pipelining (--pipeline_depth): each dispatch queues its work on the
  device and returns a device tensor; the host reads a dispatch's
  detections (one copy to the host) only when that many later dispatches
  are in flight, so decode and drawing overlap the device's work;
- frame batching (--frame_batch): N file-input frames per device call and
  one packed buffer back, at N-1 frames of latency (keep 1 for live input);
- device preprocessing (--device_preprocess, the default): raw uint8 BGR
  frames go to the device, which flips, letterboxes and detects them in
  one call (ops.preprocess.build_streaming_detector).

Example:
  python -m yolov3_tensorflow_tpu_torch.cli.detect_video in.mp4 \
      --restore_path yolov3.weights --save_video true
"""

from __future__ import annotations

import argparse
import sys
import time
from collections import deque

import cv2
import numpy as np
import torch

from yolov3_tensorflow_tpu_torch.cli.common import (load_anchors,
                                                    load_classes,
                                                    load_variables,
                                                    resolve_device, str2bool)
from yolov3_tensorflow_tpu_torch.cli.detect_image import (invert_boxes,
                                                          preprocess)
from yolov3_tensorflow_tpu_torch.ops.postprocess import (build_detector,
                                                         pack_detections,
                                                         unpack_detections)
from yolov3_tensorflow_tpu_torch.ops.preprocess import \
    build_streaming_detector
from yolov3_tensorflow_tpu_torch.utils.viz import (get_color_table,
                                                   plot_one_box)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="YOLOv3 video detection (PyTorch).")
    p.add_argument("input_video", type=str)
    p.add_argument("--anchor_path", type=str, default="")
    p.add_argument("--new_size", nargs="*", type=int, default=[416, 416])
    p.add_argument("--letterbox_resize", type=str2bool, default=True)
    p.add_argument("--class_name_path", type=str, default="")
    p.add_argument("--restore_path", type=str, required=True)
    p.add_argument("--score_thresh", type=float, default=0.3)
    p.add_argument("--nms_thresh", type=float, default=0.45)
    p.add_argument("--max_boxes", type=int, default=200)
    p.add_argument("--save_video", type=str2bool, default=False)
    p.add_argument("--output", type=str, default="video_result.mp4")
    p.add_argument("--show", action="store_true")
    p.add_argument("--max_frames", type=int, default=0,
                   help="stop after N frames (0 = all); useful headless")
    p.add_argument("--device_preprocess", type=str2bool, default=True,
                   help="letterbox+normalize on the device from raw uint8 "
                        "frames (4x less host->device traffic); implies "
                        "letterbox_resize")
    p.add_argument("--mode", type=str, default="prefilter",
                   choices=["exact", "prefilter", "split", "packed"],
                   help="postprocess pipeline; packed is the serving path "
                        "(streaming supports prefilter/packed: the other "
                        "modes stream in prefilter mode, as in the JAX CLI)")
    p.add_argument("--pipeline_depth", type=int, default=2,
                   help="dispatches in flight on the device; raise to hide "
                        "host<->device latency (adds that much display "
                        "latency)")
    p.add_argument("--frame_batch", type=int, default=1,
                   help="frames per device call: every call pays a fixed "
                        "launch and copy cost, which batching N file-input "
                        "frames amortizes N-fold. Adds N-1 frames of "
                        "latency — keep 1 for live/interactive input")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (cuda, cuda:N or cpu)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    use_device_pre = args.device_preprocess and args.letterbox_resize
    stream_mode = args.mode if args.mode in ("prefilter", "packed") \
        else "prefilter"
    anchors = load_anchors(args.anchor_path)
    classes = load_classes(args.class_name_path)
    num_classes = len(classes)
    color_table = get_color_table(num_classes)

    vid = cv2.VideoCapture(args.input_video)
    if not vid.isOpened():
        print(f"cannot open video: {args.input_video}", file=sys.stderr)
        return 1
    fps = vid.get(cv2.CAP_PROP_FPS) or 25
    width = int(vid.get(cv2.CAP_PROP_FRAME_WIDTH))
    height = int(vid.get(cv2.CAP_PROP_FRAME_HEIGHT))

    writer = None
    if args.save_video:
        fourcc = cv2.VideoWriter_fourcc(*"mp4v")
        writer = cv2.VideoWriter(args.output, fourcc, fps, (width, height))
        if not writer.isOpened():
            vid.release()
            print(f"cannot write {args.output} with the mp4v codec",
                  file=sys.stderr)
            return 1

    variables = load_variables(args.restore_path, num_classes, device)
    dst_hw = (args.new_size[1], args.new_size[0])
    common = dict(device=device, max_out=args.max_boxes,
                  score_thresh=args.score_thresh, iou_thresh=args.nms_thresh)
    if use_device_pre:
        detect, invert_stream = build_streaming_detector(
            variables, anchors, num_classes, (height, width), dst_hw,
            bgr_input=True, mode=stream_mode, **common)
    else:
        detect = build_detector(variables, anchors, num_classes, dst_hw,
                                mode=args.mode, **common)
    del variables

    # (frames, invs, host input kept alive until its copy is read, packed
    # detections on the device) per dispatch
    pending = deque()
    depth = max(1, args.pipeline_depth)
    fb = max(1, args.frame_batch)
    frames = 0
    t_start = time.time()
    t_warm = None  # set after batch 0 completes (excludes the first call)

    def finish(item):
        batch_frames, invs, _, dets = item
        t0 = time.time()
        dets = dets.cpu().numpy()                    # ONE device sync
        for i, (frame, inv) in enumerate(zip(batch_frames, invs)):
            boxes, scores, labels = unpack_detections(dets, i)
            boxes = (invert_stream(boxes) if inv is None
                     else invert_boxes(boxes, inv))
            for box, score, label in zip(boxes, scores, labels):
                plot_one_box(frame, box,
                             label=f"{classes[int(label)]}, "
                                   f"{score * 100:.2f}%",
                             color=color_table[int(label)])
            ms = (time.time() - t0) * 1000 / len(batch_frames)
            cv2.putText(frame, f"{ms:.2f} ms", (40, 40), 0, fontScale=1,
                        color=(0, 255, 0), thickness=2)
            if writer is not None:
                writer.write(frame)
            if args.show:
                cv2.imshow("image", frame)
                cv2.waitKey(1)

    def dispatch(batch_frames):
        """One device call over len(batch_frames) frames. The LAST batch of
        the video may be short: pad it by repeating the final frame (one
        batch shape for every call) and drop the pad rows."""
        n = len(batch_frames)
        padded = batch_frames + [batch_frames[-1]] * (fb - n)
        if use_device_pre:
            invs = [None] * n
            x = torch.from_numpy(np.stack(padded))   # raw uint8 BGR
        else:
            pre = [preprocess(f, args.new_size, args.letterbox_resize)
                   for f in padded]
            invs = [inv for _, inv in pre[:n]]
            x = torch.from_numpy(np.concatenate([inp for inp, _ in pre]))
        if device.type == "cuda":
            x = x.pin_memory()           # the copy overlaps the host's work
        pending.append((batch_frames, invs, x, pack_detections(detect(x))))

    batch_buf = []
    frames_at_warm = 0
    while True:
        ok, frame = vid.read()
        if not ok or (args.max_frames and frames >= args.max_frames):
            break
        batch_buf.append(frame)
        frames += 1
        if len(batch_buf) < fb:
            continue
        dispatch(batch_buf)
        batch_buf = []
        if len(pending) >= depth + 1 or (t_warm is None and pending):
            finish(pending.popleft())  # overlap: consume oldest in flight
            if t_warm is None:
                t_warm = time.time()  # first result done
                frames_at_warm = frames
    if batch_buf:
        dispatch(batch_buf)
    while pending:
        finish(pending.popleft())

    elapsed = time.time() - t_start
    if frames:
        msg = (f"{frames} frames in {elapsed:.2f}s "
               f"({frames / elapsed:.1f} FPS incl. decode+draw+first call)")
        if t_warm is not None and frames > frames_at_warm:
            steady = (frames - frames_at_warm) / max(
                time.time() - t_warm, 1e-9)
            msg += (f"; steady-state {steady:.1f} FPS "
                    f"(first batch excluded)")
        print(msg)
    vid.release()
    if writer is not None:
        writer.release()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
