#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: build, check, serve, time.

Run from the repository root, on a machine with a CUDA GPU:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the last line:

1. checks: a CUDA device is present; prints the card's name and power limit
   (nvidia-smi) and the toolchain.
2. build: compiles the shared-candidate NMS kernel (csrc/nms_shared.cu) from
   the sources in this checkout.
3. kernel against its plain version: keep masks must be equal bit for bit
   on the case list of yolov3_tensorflow_tpu_torch.testing (random sets at
   K in {8, 64, 256} x C in {6, 20, 80}, K=200 and K=1024, ties, zero-area
   boxes, all-invalid classes, IoU within 2 ulps of t) and the bench shape
   B=128, K=64, C=80.
4. main path: build_detector(mode="packed") at COCO-80, 416x416, bf16, with
   the serving config (max_out 128, box_topk 64, score 0.3, iou 0.45) on
   seeded random weights plus the spread head, answers 3 requests at batch 8
   and 2 at batch 128. Outputs must be finite and of the right shape, every
   image must have detections, the NMS kernel must have launched once per
   request, and on the last request's candidates the kernel's keep masks
   must equal the plain version's. Then the fp32 detector on the GPU (TF32
   off) must find the same detections as the fp32 detector on the CPU
   (plain NMS) on 2 images: same label, IoU >= 0.9, for every detection
   scored at least 0.02 above the threshold.
5. timings (CUDA events, after warm-up): img/s at batch 8 and 128, the
   stages at batch 128, and the kernel against its plain version at
   B=128, K=64, C=80 on the main path's candidates.
6. prints the kernel record and the device record as JSON; the last line is
   {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
C = 80
SIZE = 416
SERVING = dict(max_out=128, box_topk=64, score_thresh=0.3, iou_thresh=0.45)
REQUESTS = (8, 8, 8, 128, 128)
KERNEL_SOURCE = "yolov3_tensorflow_tpu_torch/csrc/nms_shared.cu"
KERNEL_REPLACES = "yolov3_tensorflow_tpu/ops/nms_pallas.py:115"


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean device milliseconds of fn() over `iters` back-to-back calls."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_cases(dev: torch.device, cases) -> float:
    """Phase 3: kernel vs plain version, bit for bit. Returns the largest
    |kernel - plain| over all keep bits (0.0 when they agree)."""
    from yolov3_tensorflow_tpu_torch.ops.nms_cuda import (
        nms_keep_mask_shared, nms_keep_mask_shared_reference)
    worst = 0.0
    for case in cases:
        boxes = torch.from_numpy(case.boxes).to(dev)
        scores = torch.from_numpy(case.scores).to(dev)
        got = nms_keep_mask_shared(boxes, scores, case.score_thresh,
                                   case.iou_thresh)
        torch.cuda.synchronize()
        want = nms_keep_mask_shared_reference(boxes, scores,
                                              case.score_thresh,
                                              case.iou_thresh)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        worst = max(worst, err)
        b, k, c = case.scores.shape
        print(f"kernel case {case.name}: B={b} K={k} C={c} "
              f"kept={int(want.sum())} valid="
              f"{int((scores >= case.score_thresh).sum())} "
              f"equal={err == 0.0}")
        check(err == 0.0, f"kernel keep masks differ on case {case.name}")
    return worst


def main() -> int:
    # ---- 1. checks -------------------------------------------------------
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    sys.path.insert(0, str(ROOT))
    try:
        import yolov3_tensorflow_tpu_torch as port
    except ImportError as e:
        fail(f"the port's package is not beside this script: {e}")
    check(Path(port.__file__).resolve().parent.parent == ROOT,
          f"imported the port from {port.__file__}, not from {ROOT}")
    from yolov3_tensorflow_tpu_torch.config import DEFAULT_ANCHORS
    from yolov3_tensorflow_tpu_torch.models.convert import spread_head
    from yolov3_tensorflow_tpu_torch.models.yolov3 import init_yolov3
    from yolov3_tensorflow_tpu_torch.ops import nms_cuda
    from yolov3_tensorflow_tpu_torch.ops.fast_postprocess import (
        packed_candidates, yolov3_forward_packed)
    from yolov3_tensorflow_tpu_torch.ops.postprocess import (
        build_detector, detections_to_numpy)
    from yolov3_tensorflow_tpu_torch.testing import (bench_case,
                                                     match_detections,
                                                     nms_cases)
    from yolov3_tensorflow_tpu_torch.utils import kernels
    jaxy = [m for m in sys.modules if m.split(".")[0] in
            ("jax", "yolov3_tensorflow_tpu")]
    check(not jaxy, f"the port imported jax or the JAX package: {jaxy}")

    dev = torch.device("cuda", 0)
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]} device {torch.cuda.get_device_name(0)}")
    # every fp32 comparison below runs in full fp32 (cuDNN defaults to TF32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # ---- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    lib = kernels.build_kernel("nms_shared")
    print(f"build nms_shared: {time.perf_counter() - t0:.2f} s -> "
          f"{lib.relative_to(ROOT)}")
    log = lib.with_suffix(".so.log")
    if log.exists():
        for line in log.read_text().splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling")):
                print(f"  ptxas: {line.strip()}")

    # ---- 3. kernel against its plain version -----------------------------
    cases = nms_cases(batch=16, seed=1) + [bench_case(seed=2)]
    max_err = kernel_cases(dev, cases)

    # ---- 4. the main path at full width ----------------------------------
    anchors = np.asarray(DEFAULT_ANCHORS, np.float32)
    variables = spread_head(
        init_yolov3(torch.Generator().manual_seed(0), C, device=dev), seed=0)
    det = build_detector(variables, anchors, C, (SIZE, SIZE), device=dev,
                         compute_dtype=torch.bfloat16, **SERVING)
    gen = torch.Generator(device=dev).manual_seed(1)
    batches = [torch.rand((b, SIZE, SIZE, 3), generator=gen, device=dev)
               for b in REQUESTS]
    torch.cuda.synchronize()

    nms_cuda.nms_keep_mask_shared.launches = 0
    results = []
    t0 = time.perf_counter()
    for images in batches:
        results.append(det(images))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = nms_cuda.nms_keep_mask_shared.launches

    for b, out in zip(REQUESTS, results):
        check(out["boxes"].shape == (b, C * SERVING["max_out"], 4),
              f"boxes shape {tuple(out['boxes'].shape)}")
        for key in ("scores", "labels", "valid"):
            check(out[key].shape == (b, C * SERVING["max_out"]),
                  f"{key} shape {tuple(out[key].shape)}")
        check(bool(torch.isfinite(out["boxes"]).all()
                   and torch.isfinite(out["scores"]).all()),
              "non-finite detections")
        per_image = out["valid"].sum(dim=1)
        check(bool((per_image > 0).all()),
              f"an image of a batch-{b} request has no detection")
        print(f"request batch {b}: detections per image min "
              f"{int(per_image.min())} median {int(per_image.median())} max "
              f"{int(per_image.max())}; score range "
              f"{float(out['scores'][out['valid']].min()):.4f}.."
              f"{float(out['scores'][out['valid']].max()):.4f}")
    print(f"served {len(REQUESTS)} requests ({sum(REQUESTS)} images) in "
          f"{wall:.3f} s wall, first calls included; nms_shared launches "
          f"{launches}")
    check(launches == len(REQUESTS),
          f"nms_shared launched {launches} times for {len(REQUESTS)} requests")

    with torch.inference_mode():
        outs = yolov3_forward_packed(det.packed, batches[-1],
                                     compute_dtype=torch.bfloat16)
        boxes, scores = packed_candidates(outs, C, det.tables,
                                          SERVING["box_topk"])
        keep = nms_cuda.nms_keep_mask_shared(boxes, scores, 0.3, 0.45)
        want = nms_cuda.nms_keep_mask_shared_reference(boxes, scores, 0.3,
                                                       0.45)
        torch.cuda.synchronize()
    err = float((keep.float() - want.float()).abs().max())
    max_err = max(max_err, err)
    print(f"main-path candidates B={boxes.shape[0]} K={boxes.shape[1]} "
          f"C={scores.shape[2]}: kept {int(want.sum())} of "
          f"{int((scores >= 0.3).sum())} valid; kernel == plain: {err == 0.0}")
    check(err == 0.0, "kernel and plain keep masks differ on the main path")

    # fp32 on the GPU against fp32 on the CPU, 2 images
    cpu = torch.device("cpu")
    small = batches[0][:2]
    g32 = build_detector(variables, anchors, C, (SIZE, SIZE), device=dev,
                         compute_dtype=torch.float32, **SERVING)(small)
    c32 = build_detector(variables, anchors, C, (SIZE, SIZE), device=cpu,
                         compute_dtype=torch.float32, **SERVING)(small.cpu())
    g = [detections_to_numpy(g32, i) for i in range(2)]
    r = [detections_to_numpy(c32, i) for i in range(2)]
    n1, f1 = match_detections(r, g, 0.32)
    n2, f2 = match_detections(g, r, 0.32)
    print(f"fp32 GPU vs fp32 CPU reference: {f1}/{n1} CPU detections found "
          f"on the GPU, {f2}/{n2} GPU detections found on the CPU")
    check(n1 > 0 and n2 > 0, "no confident fp32 detections to compare")
    check(f1 == n1 and f2 == n2, "GPU detector disagrees with the CPU one")

    # ---- 5. timings ------------------------------------------------------
    timings = {}
    for b, iters in ((8, 30), (128, 10)):
        images = batches[0] if b == 8 else batches[-1]
        for _ in range(3):
            det(images)
        ms = cuda_ms(lambda: det(images), iters)
        timings[b] = ms
        print(f"detector batch {b}: {ms:.3f} ms/batch, "
              f"{b * 1000.0 / ms:.1f} img/s [{card}]")

    with torch.inference_mode():
        images = batches[-1]
        fwd_ms = cuda_ms(lambda: yolov3_forward_packed(
            det.packed, images, compute_dtype=torch.bfloat16), 10)
        cand_ms = cuda_ms(lambda: packed_candidates(
            outs, C, det.tables, SERVING["box_topk"]), 20)
        nms_ms = cuda_ms(lambda: nms_cuda.batched_nms_shared(
            boxes, scores, max_out=128, score_thresh=0.3, iou_thresh=0.45), 20)
    print(f"stages at batch 128: forward {fwd_ms:.3f} ms, prefilter+decode "
          f"{cand_ms:.3f} ms, batched_nms_shared {nms_ms:.3f} ms [{card}]")

    def kernel():
        nms_cuda.nms_keep_mask_shared(boxes, scores, 0.3, 0.45)

    def plain():
        nms_cuda.nms_keep_mask_shared_reference(boxes, scores, 0.3, 0.45)

    kernel(), plain()
    order = [("plain", plain, 5), ("kernel", kernel, 200),
             ("kernel", kernel, 200), ("plain", plain, 5)]
    runs = {"kernel": [], "plain": []}
    for name, fn, iters in order:
        runs[name].append(cuda_ms(fn, iters))
    k_ms = sum(runs["kernel"]) / 2
    p_ms = sum(runs["plain"]) / 2
    print(f"nms_shared keep masks B=128 K=64 C=80: kernel {k_ms:.4f} ms "
          f"(runs {runs['kernel'][0]:.4f}, {runs['kernel'][1]:.4f}), plain "
          f"PyTorch {p_ms:.4f} ms (runs {runs['plain'][0]:.4f}, "
          f"{runs['plain'][1]:.4f}) [{card}]")

    # ---- 6. records ------------------------------------------------------
    print(json.dumps({"kernels": [{
        "name": "nms_shared", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches,
        "max_abs_err": max_err, "ms": k_ms, "plain_ms": p_ms}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
