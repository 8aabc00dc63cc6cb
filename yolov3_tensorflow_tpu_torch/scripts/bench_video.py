"""Measure the video demo at several --frame_batch settings.

Counterpart of the JAX package's `scripts/bench_video.py`. Writes a
deterministic synthetic mp4 (moving rectangles over noise, `--size`
square), saves a seeded COCO-80 checkpoint (`init_yolov3` from a
torch.Generator seeded 0 with `spread_head`, so that frames have
detections to decode and draw; `train.checkpoint.CheckpointStore`), runs
the real `cli.detect_video` main in this process at each frame batch
(`--mode packed --pipeline_depth 3 --frame_batch N --save_video false`, on
`--device`), and reports the two rates the CLI prints: the steady-state
FPS (first batch excluded) and the overall FPS (decode, draw and the
first call included).

Batching N file-input frames per device call amortizes the call's fixed
launch and copy cost N-fold, at the price of N - 1 frames of latency. The
reference's comparable number is ~30 FPS on a locally attached Titan XP
(its video demo's on-frame ms overlay).

Writes {"frames", "size", "mode", "pipeline_depth", "device", "results":
{N: {"rc", "steady_fps", "overall_fps"}}} to `--out` (default under
build/, which git ignores) and prints the results as the last line. The
video and checkpoint live in a temporary directory, deleted at the end.

  python -m yolov3_tensorflow_tpu_torch.scripts.bench_video \\
      [--frames 120] [--batches 1,4,8] [--size 416] [--out f.json] \\
      [--device cuda]
"""

from __future__ import annotations

import argparse
import io
import json
import os
import re
import tempfile
from contextlib import redirect_stderr, redirect_stdout
from typing import Dict, List, Optional

import numpy as np
import torch

from yolov3_tensorflow_tpu_torch.cli import detect_video
from yolov3_tensorflow_tpu_torch.cli.common import device_name, resolve_device
from yolov3_tensorflow_tpu_torch.models.convert import spread_head
from yolov3_tensorflow_tpu_torch.models.yolov3 import init_yolov3
from yolov3_tensorflow_tpu_torch.train.checkpoint import CheckpointStore

DEFAULT_OUT = os.path.join("build", "bench_video", "video_frame_batch.json")
PIPELINE_DEPTH = 3


def make_video(path: str, frames: int, size: int = 416) -> None:
    """A seeded mp4 of `frames` size x size frames at 25 FPS: two moving
    rectangles over fixed noise (a stable decode cost)."""
    import cv2
    rng = np.random.default_rng(7)
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 25,
                         (size, size))
    base = rng.integers(0, 80, (size, size, 3), dtype=np.uint8)
    for i in range(frames):
        f = base.copy()
        x = (13 * i) % max(size - 120, 1)
        cv2.rectangle(f, (x, 60), (x + 100, 180), (250, 250, 250), -1)
        cv2.rectangle(f, (40, x), (140, x + 90), (40, 220, 220), -1)
        vw.write(f)
    vw.release()


def parse_rates(text: str) -> Dict[str, Optional[float]]:
    """The steady-state and overall FPS of a detect_video run's output
    (None where the line is missing)."""
    steady = re.search(r"steady-state ([0-9.]+) FPS", text)
    overall = re.search(r"\(([0-9.]+) FPS incl", text)
    return {"steady_fps": float(steady.group(1)) if steady else None,
            "overall_fps": float(overall.group(1)) if overall else None}


def run(frames: int, batches: List[int], size: int, device: str,
        tmp: str) -> Dict[str, Dict]:
    """Each frame batch's {"rc", "steady_fps", "overall_fps"}."""
    vid = os.path.join(tmp, "in.mp4")
    make_video(vid, frames, size)
    names = os.path.join(tmp, "names.txt")
    with open(names, "w") as f:
        f.write("\n".join(f"c{i}" for i in range(80)) + "\n")
    variables = spread_head(init_yolov3(torch.Generator().manual_seed(0), 80,
                                        device=torch.device("cpu")), seed=0)
    ckpt = CheckpointStore(os.path.join(tmp, "ckpt")).save(
        "m", {"params": variables["params"],
              "batch_stats": variables["batch_stats"]})
    del variables
    results = {}
    for fb in batches:
        buf = io.StringIO()
        with redirect_stdout(buf), redirect_stderr(buf):
            rc = detect_video.main([
                vid, "--restore_path", ckpt,
                "--class_name_path", names,
                "--new_size", str(size), str(size),
                "--score_thresh", "0.3", "--max_boxes", "20",
                "--mode", "packed", "--pipeline_depth", str(PIPELINE_DEPTH),
                "--frame_batch", str(fb),
                "--save_video", "false", "--device", device,
            ])
        results[str(fb)] = {"rc": rc, **parse_rates(buf.getvalue())}
        r = results[str(fb)]
        print(f"frame_batch={fb}: steady {r['steady_fps']} FPS (overall "
              f"{r['overall_fps']})", flush=True)
    return results


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--frames", type=int, default=120)
    p.add_argument("--batches", type=str, default="1,4,8")
    p.add_argument("--size", type=int, default=416,
                   help="square frame size of the video and the detector")
    p.add_argument("--out", default=DEFAULT_OUT)
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda, cuda:N; cpu for the tests)")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    with tempfile.TemporaryDirectory(prefix="bench_video_") as tmp:
        results = run(args.frames, [int(x) for x in args.batches.split(",")],
                      args.size, args.device, tmp)
    out = {"frames": args.frames, "size": args.size, "mode": "packed",
           "pipeline_depth": PIPELINE_DEPTH,
           "device": device_name(device),
           "results": results,
           "note": "synthetic mp4, seeded random weights with spread_head; "
                   "steady-state excludes the first batch"}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps(out["results"]))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
