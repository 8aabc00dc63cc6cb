#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: build, check, serve, time.

Run from the repository root, on a machine with a CUDA GPU:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the last line:

1. checks: a CUDA device is present; prints the card's name and power limit
   (nvidia-smi) and the toolchain.
2. build: compiles all five kernels (csrc/nms_shared.cu, csrc/nms.cu,
   csrc/mma_rate.cu, csrc/patch_build.cu and csrc/conv_epilogue.cu) from
   the sources in this checkout, one nvcc each, started together; prints
   the build time and ptxas's register and spill lines, and the HGMMA and
   HMMA instruction
   counts of the tensor-core chain's library (cuobjdump -sass): it must run
   on wgmma (HGMMA) and hold no mma.sync (HMMA).
3. kernels against their plain versions, bit for bit: the shared-candidate
   kernel on the case list of yolov3_tensorflow_tpu_torch.testing.nms_cases
   (random sets at K in {8, 64, 256} x C in {6, 20, 80}, K=200 and K=1024,
   ties, zero-area boxes, all-invalid classes, IoU within 2 ulps of t), the
   bench shape B=128, K=64, C=80 and testing.card_cases (B=8 at K=64 and
   K=256 with C=80; K=1024 at C=80 and at C=160, whose scores are staged in
   two chunks; K=37 and K=130; B=300); the per-group kernel on
   testing.per_class_cases (dense random sets at K in {64, 200, 256, 1024}
   with random validity and an all-invalid group, the three-box chain, IoU
   within 2 ulps of t).
4. packed path: build_detector(mode="packed") at COCO-80, 416x416, bf16,
   with the serving config (max_out 128, box_topk 64, score 0.3, iou 0.45)
   on seeded random weights plus the spread head, answers 3 requests at
   batch 8 and 2 at batch 128. Outputs must be finite and of the right
   shape, every image must have detections, the shared-candidate kernel
   must have launched once per request and the conv epilogue 75 times per
   request (the record's count), and on the last request's candidates its
   keep masks must equal the plain version's. Then the fp32
   detector on the GPU (TF32 off) must find the same detections as the
   fp32 detector on the CPU (plain NMS) on 2 images: same label, IoU >=
   0.9, for every detection scored at least 0.02 above the threshold.
5. weights: the same seeded tree goes out through save_darknet_weights to
   a darknet .weights file and back through load_darknet_weights into a
   fresh tree; every tensor must come back equal.
6. exact path: build_detector(mode="exact") from the loaded tree at COCO-80,
   416x416, bf16, with the eval config (max_out 150, pre_topk 1024, score
   0.01, iou 0.45), answers 3 requests at batch 8. Outputs finite and
   [8, 80*150, ...], detections in every image, the per-group kernel
   launched once per request, and on the exact path's own candidates
   (G = 8*80 = 640 groups, K = 1024) its keep masks must equal the plain
   version's; prints the valid and kept candidates per group (mean and
   max). Then at the demo config (max_out 200, pre_topk 256, score
   0.3, iou 0.45) the fp32 exact detector on the GPU and on the CPU must
   find the same detections on 2 images, both ways.
7. prefilter path: build_detector(mode="prefilter") at the demo config,
   bf16, answers 1 request at batch 8 with one shared-candidate kernel
   launch. Then, in fp32, on every image where no more than box_topk boxes
   pass the score threshold (the prefilter's exactness condition) it must
   find the same detections as the exact mode, both ways; the threshold is
   the lowest of 0.3, 0.4, ..., 0.9 at which at least one image meets the
   condition. (In bf16 the logits tie often, and the two modes order equal
   scores differently: by candidate rank and by anchor index.)
8. timings (CUDA events, after warm-up): img/s of the packed detector at
   batch 8 and 128 and its stages at batch 128; ms per batch of the exact
   detector at batch 8 in both configs and its stages at the eval config
   (`call_ms`: back-to-back calls, host gaps included; the packed
   detector's loops before the first profiler session); beside each
   detector's ms per batch, the device's busy time per batch
   (utils.profiling.device_busy_ms, torch.profiler): the difference is
   time the device waited for the host. Every kernel is timed on the device
   alone (utils.profiling.cuda_ms holds the stream while the host queues
   the calls), against its plain version, twice in turns; the launch floor
   (an empty kernel, torch.cuda._sleep(0)) is timed the same way. The
   shared-candidate kernel on each path's own candidates: packed at batch
   128 and 8 (K=64) and prefilter at batch 8 (K=256), with the valid and
   kept candidates per class, the earlier one-CTA-per-image design's times
   on the same candidates beside it, and its share of the packed
   detector's device busy time at batch 8; the per-group kernel at G=640,
   K=1024.
9. probes (scripts/exp_mxu_shapes.py): the tensor-core chain (K3) against
   its plain version at each of the 10 stem shapes (M 16384, reps 64),
   max|kernel - plain| / max|plain| <= 1e-4 (tensor-core fp32 sums are
   not ordered as torch.matmul's); the patch build (K4) against its plain
   version bit for bit at c in {32, 64, 128} (M 65536). Then the probes'
   own run (`run`: the bf16 torch.matmul peak, each shape at reps 64 and
   128, each width), with every shape's TF/s and GB/s printed: the reps
   128 / reps 64 time ratio must lie in [1.7, 2.3] and no shape may read
   above 1.05x the measured peak (an impossible reading means a collapsed
   chain). Each kernel against its plain version, timed in turns, and K3
   against its library yardstick: `reps` back-to-back torch.mm on its
   operands (fp32 output where torch.mm takes out_dtype), TF/s of both.
10. roofline: the stage profile (scripts/profile_stages.py) at batch 128,
   whose copy probe gives the bandwidth; the roofline
   (scripts/roofline.py) of the batch-128 416^2 forward from the measured
   matmul peak and the better copy bandwidth; the packed detector's
   batch-128 ms/batch of phase 8 as a share of its bound (it must be
   under 1); the stage table.
11. entry points: a .weights file of phase 4's tree, two seeded 480x640
   BGR jpgs and a 24-frame 480x640 video (mp4v) in a temporary directory.
   cli.detect_image at 416^2 on the GPU in its default mode (prefilter:
   one shared-candidate launch), in --mode exact (one per-group launch)
   and in --mode split (one shared-candidate launch); rc 0, an output of
   the input's shape, boxes drawn. cli.detect_video with --save_video true
   five ways: streaming prefilter (the default) at frame batch 1 and 8,
   streaming packed at frame batch 8, host preprocessing at frame batch 1
   and host preprocessing with --mode split at frame batch 8; rc 0, 24
   frames out, one shared-candidate launch per dispatch (24 or 3), each
   run's steady-state FPS printed. Then the streaming detector
   (ops.preprocess.build_streaming_detector) at 480x640 -> 416^2 in both
   modes: the shared-candidate kernel bit-equal to its plain version on
   the detector's own candidates (batch 8), device_letterbox on the GPU
   within 0.01/255 of the CPU's, fp32 detections on the GPU equal to the
   CPU's on 2 frames (same label, IoU >= 0.9, score >= 0.32); ms per call
   (host gaps included) and device busy time at frame batch 1 and 8, and
   the pinned uint8 host-to-device copy alone.
12. training: 64 + 8 + 8 seeded synthetic 416^2 images in a temporary
   directory (`data.synthetic.generate_dataset`, labels 0..2 under the
   COCO-80 head). One fp32 momentum step (TF32 off) of the seed-0 tree on a
   loader batch of 2 on the GPU and on the CPU: loss terms within 1e-4,
   BN moving statistics within 1e-5, each leaf's update within 1e-3 of
   its largest, or within twice the GPU's own noise (the step on the batch
   in reverse order), whichever is larger. 30 bf16 Adam steps at batch 8
   must halve the loss. K2 bit-equal to its plain version on the eval
   step's own candidates after them (G = 640, K = 1024). cli.train on the
   GPU with the reference recipe (momentum, piecewise with a 1-epoch
   warm-up, mixup, color distortion, label smoothing, focal loss,
   multi-scale), batch 8, 3 epochs: rc 0, finite losses, a best_model_
   checkpoint, K2 once per in-train evaluation and per validation batch;
   then 4 epochs with auto_resume, which resumes from the newest checkpoint
   and ends at step 32. Timings: the bf16 train step at batch 8 and 32
   (device-resident batches; ms per step with host gaps, device busy time,
   idle share, peak memory, share of 3x the forward's roofline bound), the
   host loader alone in images/s, cli.train's StepTimer p50.
13. the device data path, the overfit gate and the checkpoint CLIs, on
   phase 12's synthetic set (labels 0..2, COCO-80 head). One device-mode
   loader batch with the reference recipe (mixup, color distortion,
   multi-scale, 608^2 tiles, the largest bucket): encode_labels_device on
   the GPU bit-equal to the host encode_labels on the same padded ground
   truth, augment_batch on the GPU within 1/255 of the CPU's everywhere
   and equal on at least 99.5% of the values. The bf16 train step in
   device mode (augmentation and label grids in the step) at batch 8 and
   32 beside phase 12's host-mode step, then both in 8 turns (h d d h h d
   d h) on the same inputs as before, the prologue alone, the loader
   alone in both modes and the bytes each copies per batch. The reduced
   overfit gate (scripts/overfit_gate.py: adam, 416^2, batch 8, 16 images,
   GATE_EPOCHS epochs, device_augment and device_encode, its own 3-class
   head) graded by cli.evaluate.run_eval: rc 0, mAP >= 0.95, the per-group
   kernel once per evaluate batch. cli.convert_weights of a .weights file
   of phase 4's tree: the checkpoint's tensors equal the file's and
   cli.detect_image draws the same boxes from both; cli.strip_checkpoint
   of the gate's best checkpoint drops its optimizer state and
   cli.evaluate of it gives the gate's mAP.
14. int8 serving, on phase 4's tree (spread head) at COCO-80, 416x416,
   and phase 13's directory. The detectors of the slice built through their
   entry points, each calibrated on 8 seeded images: build_detector_int8 in
   modes packed, prefilter and chained, build_detector(mode="stem8") at
   upto 12 and 9, build_auto_detector under quantize none, hybrid and full.
   The int8 GEMM route (ops.int8_conv: im2col + torch._int_mm) bit-equal
   to its float64 reference at batch 8 with the quantized weights of
   conv_0 (K 27 padded to 32), the stride-2 conv_1, the 1x1 conv_2, head
   conv_1 at 13^2 and both halves of the chained head conv_8. Each
   detector answers a request at batch 8 and at 128: finite outputs of
   the right shape, detections in every image, one shared-candidate
   launch and its int8 GEMMs per request (72 full int8, 74 chained, 12 and
   9 stem8, 0 under every auto budget, which serves bf16 packed on CUDA
   (phase 15); no silent float path),
   and the kernel bit-equal to its plain version on the last request's
   candidates. The int8 packed, prefilter and chained detectors on the GPU
   and on the CPU (plain NMS), both quantized with the GPU's activation
   scales, find the same detections on 2 images (same label, IoU >= 0.9,
   score >= 0.32); stem8's int8 region (conv_0..11) gives the same bf16
   output on both (its bf16 remainder is the packed path's, compared in
   fp32 in phase 4).
   scripts/validate_quantized.py on the reduced gate's checkpoint and 16
   images, calibrated on the first 8 (the JAX script's procedure) and on
   all 16: int8, chained and stem8 mAP within 0.01 of bf16's, packed
   identity >= 0.95, stem8 identity >= 0.95 when calibrated on all 16
   (printed for 8), the per-group kernel once per exact-eval batch; the
   int8 packed and chained detectors' identity, printed.
   Timings: int8 packed, chained and stem8 in turns with the bf16 packed
   detector at batch 8 and 128 (ms per batch, img/s, device busy, idle
   share, peak memory); torch.profiler's split of the int8 packed forward
   at batch 128 into GEMM, quantize, patch build and the rest;
   torch._int_mm's TOPS at 8192^3 against the 1979 TOPS dense int8 peak;
   packed, stem8 and int8 img/s at 416^2 batch 128, 608^2 batch 80 and
   896x1344 batch 16 beside select_serving_mode's pick. cli.detect_image
   --mode int8, --mode stem8 and --mode auto --quantize full / hybrid /
   none on phase 13's 480x640 jpg: rc 0, boxes drawn, one shared-candidate
   launch per call.
15. the serving policy on CUDA: select_serving_mode on the card picks bf16
   packed under every budget at the mode table's sizes (the H100 table:
   no int8 mode beat bf16 there), and cli.detect_image --mode int8 at
   416^2 warns that full int8 is slower there, naming that table.
16. data parallelism, at COCO-80, 416x416. (1) World size 1 over NCCL in
   this process: make_dp_train_step bit-equal to make_train_step over 3
   momentum steps at batch 8 in bf16 and fp32 (params, BN statistics,
   optimizer slots, metrics; deterministic algorithms on), make_dp_eval_
   forward bit-equal to the eval step's detections with one per-group
   launch, that kernel bit-equal to its plain version on the eval's
   candidates; the bf16 step plain and DP in turns. (2) Two ranks on the
   one card over gloo, spawned processes: one fp32 DP step at global batch
   16 against the single-device step on the same 16 images, as
   tests/test_torch_train_model.py holds a step, or within twice the GPU's
   own reordering noise (the step on the batch reversed, the DP step with
   the batch re-partitioned), both ranks' parameters bit-equal;
   make_sharded_detector in packed and stem8 at batch 128 (64 a rank):
   each rank's rows bit-equal to build_detector on them, one
   shared-candidate launch a rank a request, that kernel bit-equal to its
   plain version on each rank's candidates, the gathered batch >= 99%
   identical (counts printed) to the whole batch on one device both ways;
   the two-rank step's time, a same-card functional run. (3) cli.train
   --num_processes 2 on the card (gloo) on 64 + 8 synthetic images, one
   epoch and validation: rc 0 and the same mAP line on both ranks, one
   per-group launch per validation batch a rank, one best_model_
   checkpoint, logs and events from rank 0 only.
17. the split head and the space-to-depth stem, at COCO-80, 416x416, on
   phase 4's tree (spread head) and the serving config.
   build_detector(mode="split") in bf16 answers 3 requests at batch 8 and
   2 at batch 128: finite outputs of the right shape, detections in every
   image, one shared-candidate launch per request (added to the kernel
   record's launches), and the kernel bit-equal to its plain version on
   the last request's split candidates. In fp32 (TF32 off) the split
   detector on the GPU finds the CPU's detections on 2 images, and the
   prefilter mode's (the same math) on every image where no more than
   box_topk boxes pass, at phase 7's choice of threshold. The rewritten
   stem (space_to_depth_stem) against the original conv_0 and conv_1 on a
   batch of 8 in fp32, max |diff| <= 1e-4, and the packed forward with
   stem_s2d against without: the same detections. Timings: the split
   detector and the packed one in turns at batch 8 and 128 (ms per batch,
   img/s, device busy, idle share), the split stages at batch 128 and each
   detection conv's 15-channel boxconf half and both halves beside the
   packed conv, the packed forward with and without stem_s2d in turns at
   batch 128, conv_0 + conv_1 alone in both forms with the input
   preparation of each, each beside its bound (scripts/roofline.py:
   conv_cost) and beside its time with cudnn.benchmark on (cuDNN's
   algorithm chosen by timing), and conv_1's asymmetric padding as pad-and-crop
   (layers.conv_folded_asym) against F.pad first.
18. the measurement scripts, each one's main called in this process on
   the card at short settings (BENCH_ARGS and the others; each script's
   own defaults are for a run of its own): scripts.bench (batches 8, 64,
   128 and 256 at 416x416, then stem8, int8 and the decode+NMS p50 at the
   best batch) exits 0 with the JAX bench's five keys last and launches
   the shared-candidate kernel once per request it made (its record
   counts them; they join the kernel record's launches); on the p50's own
   K=128 candidates the kernel is bit-equal to its plain version and is
   timed beside it with its bound (the record's "p50_k128"); its batch-128
   ms is printed beside phase 8's. scripts.bench_train (batches 8 and 32)
   prints its row keys with no MFU above MFU_MAX; scripts.profile_train
   (batch 8) times its seven stages with busy time and host gap, no MFU
   above MFU_MAX; scripts.bench_loader (64 images, threads 4 and 8) gives
   a rate for all five modes; scripts.bench_video (48 frames at frame
   batch 1, 4 and 8) returns rc 0 with both FPS at each.
19. the serving experiments, the recipe-precision analyzer and the host
   library, each script's main called in this process on the card at
   short settings (EXP_ARGS): exp_score, exp_topk, exp_tail and exp_pp_incr
   at batch 128, exp_postprocess at 128 with the sweep at 8 and 32,
   exp_stem_int8 at batch 32 (upto 4, 9, 12) and exp_highres_int8 at
   896x1344 batch 4 (upto 9, 12 and the refused 15), every --iters 2,6
   (1,3 at 896x1344). Each exits 0 with its record last (equal to its
   --out file), a device busy time beside every timed row, and the
   shared-candidate kernel launched once for each call its record counts
   (joining the kernel record's launches); the kernel bit-equal to its
   plain version on exp_topk's synthetic NMS-only candidates (B=128,
   K=128); exp_pp_incr's last row (the packed detector's program) within
   5% of phase 8's packed ms at batch 128. scripts.analyze_recipe_
   precision on phase 13's gate directory: the per-group kernel once per
   eval batch (joining the record's launches), its mAP at cutoff 0.01
   equal to the gate's. The host library (utils/native.py) built from
   csrc/postprocess.cc by the host compiler into build/torch_kernels/:
   NMS equal to py_nms at both pixel offsets, per-class NMS to cpu_nms,
   the IoU matrix to the numpy one, bit for bit; the native and numpy IoU
   timed in turns on cli.evaluate's shapes (150 detections x 50 ground
   truth boxes an image, 8 images). evaluation.metrics.evaluate_batch, the
   in-train evaluation's metric, at its own shapes (the eval step's
   detections of the seed-0 COCO-80 tree at batch 8, 416^2, 4 ground truth
   boxes an image), with each IoU route (the host library's, its default
   where the library loads, and numpy's) and each route's IoU matrices
   alone, timed in turns: the same recall and precision both ways.
20. the graft entry points (yolov3_tensorflow_tpu_torch/entry.py).
   entry() on the card: JAX's example, the output contract on it and on a
   seeded batch of 8, the shared-candidate kernel once a call (joining the
   kernel record's launches) and bit-equal to its plain version on the
   program's candidates; make_entry_fn in fp32 on the card against the
   CPU on the seed-0 tree with the spread head (same label, IoU >= 0.9,
   score >= 0.32); fn's ms a call at batch 8 with its device busy time.
   dryrun_multichip over every card (NCCL) and over 2 ranks (gloo on a
   one-card host), spawned processes: finite losses, JAX's 99% rule on
   the sharded detections against the single-device detector on the
   plain keep mask, the kernel once a rank (joining the record's
   launches) and bit-equal to its plain version on each rank's
   candidates. The busy time late in this process
   (utils.profiling.device_busy_ms): phase 19's K1 rows read above 0,
   its forward-only exp_pp_incr row's idle share at batch 128 is within
   0.01 of the same script's run alone in a fresh process, and the
   packed forward at batch 128 reads a busy time short of the device's
   time of the same calls (between the session's markers) by at most two
   launch floors an event (the gaps between its kernels).
21. the folded conv's epilogue (csrc/conv_epilogue.cu) at the offline
   cell's shapes: phase 4's tree, packed, one bf16 forward at batch 128,
   416^2, with every epilogue call caught (`epilogue_calls`): 75 calls
   (52 backbone, 23 of them with the shortcut, 18 head, 2 junctions, 3
   output convs), each kernel bit-equal to its plain version on copies of
   the call's operands; the packed forward launches the kernel 75 times.
   Each call's kernel and plain chain on the device alone, in turns,
   summed over the 75 calls, beside the byte bound (each operand read
   once, the output written once, at 3.35 TB/s); the forward with the
   kernel and with the plain chain in turns (device alone, and the host's
   time to issue it); the same forward at batch 8.
22. YOLOv4's Mish epilogues (E1's mish and mish_residual modes) on the
   main path: build_detector(arch="yolov4", mode="packed") on a seeded
   init_yolov4 tree (gamma 1, beta 0: about half of every activation's
   inputs below 0) at the YOLOv4 cell's batch 64, 608^2, bf16. The
   detector's first request builds the bf16 Mish table, once (the record
   conv_epilogue_mish_table: its builds, one build timed beside the byte
   bound of its 128 KB): equal to mish_activation on the card at all
   65,536 codes. The second request launches the Mish modes 72 times
   (`conv_epilogue.launches_by_mode`, zeroed before it), all 72 on the
   table route (`conv_epilogue.mish_launches_by_route`, as the library
   reports it); the 72 Mish calls of one packed forward, caught, each
   bit-equal to its plain version on copies of the call's operands; each
   call's kernel and plain chain on the device alone, summed over the 72,
   beside the byte bound. The library's machine code (cuobjdump -sass):
   the 18 kernels off the table route equal to the build before the
   table (E1_BEFORE_TABLE, where nvcc is the one it was recorded with),
   and no MUFU for mish() in the bf16 Mish instances (none but the
   integer divisions' MUFU.RCP), some in the fp32 ones.
23. prints the kernel record and the device record as JSON; the last line
   is {"ok": true, "device": {...}}. Each kernel's record carries its bound
   (scripts/roofline.py: the published H100 SXM peaks, from this run's
   inputs: K2 counts the IoU tests its candidates need) and its library
   yardstick's ms (null where no single PyTorch call computes the same
   function).
"""

from __future__ import annotations

import functools
import hashlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path
from typing import Tuple

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
C = 80
SIZE = 416
SERVING = dict(max_out=128, box_topk=64, score_thresh=0.3, iou_thresh=0.45)
REQUESTS = (8, 8, 8, 128, 128)
EVAL = dict(max_out=150, pre_topk=1024, score_thresh=0.01, iou_thresh=0.45)
DEMO = dict(max_out=200, pre_topk=256, score_thresh=0.3, iou_thresh=0.45)
EXACT_REQUESTS = 3                     # batch 8 each
BOX_TOPK = 256                         # prefilter candidates per image
KERNELS = {
    "nms_shared": ("yolov3_tensorflow_tpu_torch/csrc/nms_shared.cu",
                   "yolov3_tensorflow_tpu/ops/nms_pallas.py:115"),
    "nms": ("yolov3_tensorflow_tpu_torch/csrc/nms.cu",
            "yolov3_tensorflow_tpu/ops/nms_pallas.py:36"),
    "mma_rate": ("yolov3_tensorflow_tpu_torch/csrc/mma_rate.cu",
                 "scripts/exp_mxu_shapes.py:44"),
    "patch_build": ("yolov3_tensorflow_tpu_torch/csrc/patch_build.cu",
                    "scripts/exp_mxu_shapes.py:121"),
    "conv_epilogue": ("yolov3_tensorflow_tpu_torch/csrc/conv_epilogue.cu",
                      "none: XLA fuses the epilogue into the TPU's conv"),
    # E1's Mish instances (conv_epilogue_mish_kernel), a record of their own
    "conv_epilogue_mish": ("yolov3_tensorflow_tpu_torch/csrc/conv_epilogue.cu",
                           "none: the JAX package has no YOLOv4"),
    # the table that E1's bf16 Mish instances read (mish_table_build)
    "conv_epilogue_mish_table": (
        "yolov3_tensorflow_tpu_torch/csrc/conv_epilogue.cu",
        "none: the JAX package has no YOLOv4"),
}
# the libraries to build: each record's source once
BUILDS = tuple(dict.fromkeys(Path(src).stem for src, _ in KERNELS.values()))
# the shared-candidate kernel's earlier design (one 8-warp CTA per image,
# commit 68345cc) on the same candidates, stream held: an H100 80GB HBM3 at
# 700 W, scripts/compare_revisions.py (PERF.md)
K1_BEFORE_MS = {"packed_b128_k64": 0.0258, "packed_b8_k64": 0.0243,
                "prefilter_b8_k256": 0.1635}
K3_RTOL = 1e-4                         # max|kernel - plain| / max|plain|
K3_RATIO = (1.7, 2.3)                  # time(2 x reps) / time(reps)
K3_RECORD = "ctrl 512x512"             # K3's shape in the kernel record
K4_RECORD = 128                        # K4's width in the kernel record
# conv_epilogue.cu's kernels off the bf16 Mish table route, as built before
# the table existed (commit ab4df56) by nvcc E1_BEFORE_TABLE_NVCC with
# kernels.NVCC_FLAGS on an H100: the first 16 hex digits of the sha256 of
# each kernel's kernels.sass_functions lines, joined by newlines, by its
# name without the per-build tag of its anonymous namespace (E1_ANON).
# Phase 22 holds this build to them; a change to those kernels updates them.
E1_BEFORE_TABLE_NVCC = "V12.9.86"
E1_BEFORE_TABLE = {
    "conv_epilogue_kernelI13__nv_bfloat16Li0ELb0EEEvNS_4ArgsE":
        "feffa3e83dc11294",
    "conv_epilogue_kernelI13__nv_bfloat16Li0ELb1EEEvNS_4ArgsE":
        "bc93c9ca2e963365",
    "conv_epilogue_kernelI13__nv_bfloat16Li1ELb0EEEvNS_4ArgsE":
        "ffb4fb4545b783bb",
    "conv_epilogue_kernelI13__nv_bfloat16Li1ELb1EEEvNS_4ArgsE":
        "97cd8a3d0d5846c7",
    "conv_epilogue_kernelI13__nv_bfloat16Li2ELb0EEEvNS_4ArgsE":
        "303466c20d01ab18",
    "conv_epilogue_kernelI13__nv_bfloat16Li2ELb1EEEvNS_4ArgsE":
        "f55d3d96c911c26a",
    "conv_epilogue_kernelI13__nv_bfloat16Li3ELb1EEEvNS_4ArgsE":
        "6b03dc84b4d61e11",
    "conv_epilogue_kernelIfLi0ELb0EEEvNS_4ArgsE":
        "a32e5cc34caf8272",
    "conv_epilogue_kernelIfLi0ELb1EEEvNS_4ArgsE":
        "651a8ea0cae9c786",
    "conv_epilogue_kernelIfLi1ELb0EEEvNS_4ArgsE":
        "499a84bb51790896",
    "conv_epilogue_kernelIfLi1ELb1EEEvNS_4ArgsE":
        "1a1a5cd808f595e4",
    "conv_epilogue_kernelIfLi2ELb0EEEvNS_4ArgsE":
        "b4982bef5b8b1061",
    "conv_epilogue_kernelIfLi2ELb1EEEvNS_4ArgsE":
        "78cdf269c03211f6",
    "conv_epilogue_kernelIfLi3ELb1EEEvNS_4ArgsE":
        "e21bb73f813895a6",
    "conv_epilogue_mish_kernelIfLi4ELb0EEEvNS_4ArgsE":
        "ab221f5c478c130f",
    "conv_epilogue_mish_kernelIfLi4ELb1EEEvNS_4ArgsE":
        "4c5610e2bcdc228e",
    "conv_epilogue_mish_kernelIfLi5ELb0EEEvNS_4ArgsE":
        "1a0ec42234f96c63",
    "conv_epilogue_mish_kernelIfLi5ELb1EEEvNS_4ArgsE":
        "07429487bf4e8b9b",
}
E1_ANON = re.compile(r"^_ZN\d+_GLOBAL__N__\w+?_cu_[0-9a-f]{8}\d+")
ROOF_BATCH = 128                       # batch of the roofline and profile
CLI_SRC_HW = (480, 640)                # the entry points' input frames
CLI_FRAMES = 24                        # frames of the input video
STREAM = dict(max_out=200, score_thresh=0.3, iou_thresh=0.45)
STREAM_BATCHES = (1, 8)                # frame batches timed
LETTERBOX_ATOL = 0.01 / 255            # device_letterbox, GPU vs CPU
LEARN_STEPS = 30                       # bf16 Adam steps; the loss must halve
TRAIN_IMAGES = 64                      # cli.train's training set (8 batches)
TRAIN_BATCHES = (8, 32)                # train step batches timed
STAGED = 608                           # device-mode tiles: the largest bucket
PIXEL_EQUAL = 0.995                    # augment_batch GPU == CPU, share
GATE_IMAGES = 16                       # the reduced overfit gate's images
GATE_EPOCHS = 450                      # and epochs (PERF.md says why)
CALIB_IMAGES = 8                       # int8 calibration images
INT8_BATCHES = (8, 128)                # int8 request batches
INT8_MAP_DELTA = 0.01                  # int8 mAP within this of bf16's
IDENTITY_MIN = 0.95                    # packed and stem8 detection identity
INT8_PEAK_TOPS = 1979.0                # H100 SXM dense int8 (data sheet)
INT_MM_SIZE = 8192                     # the square _int_mm of the rate
# the H100 mode table at the JAX package's benched sizes: (h, w), batch
MODE_TABLE = (((416, 416), 128), ((608, 608), 80), ((896, 1344), 16))
DP_BATCH = 8                           # the world-size-1 DP steps' batch
DP_STEPS = 3                           # and steps, held bit-equal
DP2_BATCH = 16                         # the two-rank step's global batch
DP2_TIMED = 3                          # two-rank steps timed
SHARD_BATCH = 128                      # sharded serving, 64 a rank
DP_TRAIN_IMAGES = 64                   # cli.train --num_processes 2
SPLIT_REQUESTS = (8, 8, 8, 128, 128)   # the split detector's requests
S2D_ATOL = 1e-4                        # the s2d stem against the plain one
# phase 18: the measurement scripts at settings that keep it short (each
# script's own defaults are for a run of its own; PERF.md records those)
BENCH_ARGS = ["--batches", "8,64,128,256", "--iters", "2,6"]
BENCH_TRAIN_ARGS = ["--batches", "8,32", "--iters", "2,6"]
PROFILE_TRAIN_ARGS = ["--batch", "8", "--iters", "2,6"]
LOADER_ARGS = ["--images", "64", "--threads", "4,8", "--epochs", "1"]
VIDEO_ARGS = ["--frames", "48", "--batches", "1,4,8"]
MFU_MAX = 1.05                         # a higher MFU means an elided step
# phase 19: the serving experiments at settings that keep it short (each
# script's own defaults are for a run of its own)
EXP_ARGS = {
    "exp_score": ["--batch", "128", "--iters", "2,6"],
    "exp_topk": ["--batch", "128", "--iters", "2,6"],
    "exp_tail": ["--batch", "128", "--iters", "2,6"],
    "exp_pp_incr": ["--batch", "128", "--iters", "2,6"],
    "exp_postprocess": ["--batch", "128", "--iters", "2,6", "--sweep",
                        "8,32"],
    "exp_stem_int8": ["--batch", "32", "--iters", "2,6"],
    "exp_highres_int8": ["--batch", "4", "--iters", "1,3"],
}
PP_INCR_TOL = 0.05                     # exp_pp_incr's full row vs phase 8
IOU_SHAPES = (150, 50, 8)              # cli.evaluate: dets, GT boxes, images
IOU_REPS = 50                          # batches of IoU matrices timed
EVAL_BATCH = 8                         # evaluate_batch: the in-train batch
EPILOGUE_BATCHES = (128, 8)             # phase 21: the offline cell's, and
EPILOGUE_CALLS = 75                    # entry()'s; calls a packed forward
YOLOV4_SIZE = 608                      # phase 22: the YOLOv4 cell's input,
YOLOV4_BATCH = 64                      # its batch
YOLOV4_MISH_CALLS = 72                 # and its Mish epilogues a forward
# phase 20: the graft entry points (entry.py)
ENTRY_ITERS = (5, 20)                  # entry()'s differential at batch 8
IDLE_ALONE_TOL = 0.01                  # F4: fwd idle share, here vs alone
GAP_FLOORS = 2.0                       # F4: launch floors a gap, busy time
BUSY_DEVICE_ITERS = 10


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def check_no_jax() -> None:
    jaxy = [m for m in sys.modules if m.split(".")[0] in
            ("jax", "yolov3_tensorflow_tpu")]
    check(not jaxy, f"the port imported jax or the JAX package: {jaxy}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def call_ms(fn, iters: int) -> float:
    """Mean milliseconds per call of fn() over `iters` back-to-back calls,
    from CUDA events on the stream: the steady cost of a call, host gaps
    included (utils.profiling.cuda_ms times the device alone)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def in_turns(kernel, plain, kernel_iters: int, plain_iters: int,
             timer=None):
    """Kernel and plain version timed twice each on the device alone
    (utils.profiling.cuda_ms, or `timer`: call_ms for whole detectors), in
    turns (plain, kernel, kernel, plain). Returns (kernel ms, plain ms,
    kernel runs, plain runs)."""
    from yolov3_tensorflow_tpu_torch.utils.profiling import cuda_ms
    timer = timer or cuda_ms
    kernel(), plain()
    runs = {"kernel": [], "plain": []}
    for name, fn, iters in (("plain", plain, plain_iters),
                            ("kernel", kernel, kernel_iters),
                            ("kernel", kernel, kernel_iters),
                            ("plain", plain, plain_iters)):
        runs[name].append(timer(fn, iters))
    return (sum(runs["kernel"]) / 2, sum(runs["plain"]) / 2, runs["kernel"],
            runs["plain"])


def kernel_cases(dev: torch.device, cases) -> float:
    """Phase 3, shared-candidate kernel vs plain version, bit for bit.
    Returns the largest |kernel - plain| over all keep bits (0.0 when they
    agree)."""
    from yolov3_tensorflow_tpu_torch.ops import nms_cuda
    worst = 0.0
    for case in cases:
        boxes = torch.from_numpy(case.boxes).to(dev)
        scores = torch.from_numpy(case.scores).to(dev)
        got = nms_cuda.nms_keep_mask_shared(boxes, scores, case.score_thresh,
                                            case.iou_thresh)
        torch.cuda.synchronize()
        want = nms_cuda.nms_keep_mask_shared_reference(
            boxes, scores, case.score_thresh, case.iou_thresh)
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


def shared_timing(card: str, shapes: dict, busy8: float) -> dict:
    """Phase 8, the shared-candidate kernel on each path's own candidates
    (`shapes`: name -> boxes, scores, config): bit-equal to its plain
    version there, the valid and kept candidates per class, the kernel and
    its plain version on the device alone in turns, the earlier design's
    time on the same candidates (K1_BEFORE_MS) and the bound; then the
    launch floor and the kernel's share of the packed detector's device
    busy time at batch 8 (`busy8`, ms). Returns name -> (kernel ms, plain
    ms, bound)."""
    from yolov3_tensorflow_tpu_torch.ops import nms_cuda
    from yolov3_tensorflow_tpu_torch.scripts import roofline
    from yolov3_tensorflow_tpu_torch.utils.profiling import cuda_ms
    out = {}
    for name, (boxes, scores, cfg) in shapes.items():
        st, it = cfg["score_thresh"], cfg["iou_thresh"]
        got = nms_cuda.nms_keep_mask_shared(boxes, scores, st, it)
        want = nms_cuda.nms_keep_mask_shared_reference(boxes, scores, st, it)
        check(torch.equal(got, want),
              f"nms_shared keep masks differ on the {name} candidates")
        n = roofline.shared_counts(scores, want, st)
        b, k, c = scores.shape
        k_ms, p_ms, k_runs, p_runs = in_turns(
            lambda: nms_cuda.nms_keep_mask_shared(boxes, scores, st, it),
            lambda: nms_cuda.nms_keep_mask_shared_reference(boxes, scores,
                                                            st, it), 200, 3)
        bound = roofline.bound_nms_shared(b, k, c)
        out[name] = (k_ms, p_ms, bound)
        print(f"nms_shared {name} B={b} K={k} C={c}: valid per class mean "
              f"{n['valid_mean']:.2f} max {n['valid_max']}, kept per class "
              f"mean {n['kept_mean']:.2f} max {n['kept_max']}, "
              f"{n['empty_classes']} of {n['classes']} classes with no valid "
              f"candidate; kernel == plain; kernel {k_ms:.4f} ms (runs "
              f"{k_runs[0]:.4f}, {k_runs[1]:.4f}) against the one-CTA "
              f"design's {K1_BEFORE_MS[name]:.4f} ms, plain PyTorch "
              f"{p_ms:.4f} ms (runs {p_runs[0]:.4f}, {p_runs[1]:.4f}); "
              f"bound {bound[0]:.4f} ms "
              f"({bound[1]}): {bound[0] / k_ms * 100:.1f}% [{card}]")
    floor = cuda_ms(lambda: torch.cuda._sleep(0), 200)
    k8 = out["packed_b8_k64"][0]
    print(f"launch floor (an empty kernel, torch.cuda._sleep(0)): {floor:.4f} "
          f"ms; nms_shared at batch 8 takes {k8:.4f} ms, "
          f"{k8 / busy8 * 100:.2f}% of the packed detector's {busy8:.3f} ms "
          f"device busy time per batch [{card}]")
    return out


def keep_mask_error(boxes: torch.Tensor, valid: torch.Tensor,
                    iou_thresh: float, what: str) -> float:
    """Per-group kernel vs plain version on one input, bit for bit. Returns
    the largest |kernel - plain| over all keep bits."""
    from yolov3_tensorflow_tpu_torch.ops import nms_cuda
    got = nms_cuda.nms_keep_mask(boxes, valid, iou_thresh)
    torch.cuda.synchronize()
    want = nms_cuda.nms_keep_mask_reference(boxes, valid, iou_thresh)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    g, k = valid.shape
    print(f"nms {what}: G={g} K={k} t={iou_thresh} kept={int(want.sum())} "
          f"of valid={int(valid.sum())} equal={err == 0.0}")
    check(err == 0.0, f"nms keep masks differ on {what}")
    return err


def detections(out, n: int):
    from yolov3_tensorflow_tpu_torch.ops.postprocess import \
        detections_to_numpy
    return [detections_to_numpy(out, i) for i in range(n)]


def check_requests(results, sizes, max_out: int, what: str) -> None:
    """Shapes, finiteness and a detection in every image."""
    for b, out in zip(sizes, results):
        check(out["boxes"].shape == (b, C * max_out, 4),
              f"{what}: boxes shape {tuple(out['boxes'].shape)}")
        for key in ("scores", "labels", "valid"):
            check(out[key].shape == (b, C * max_out),
                  f"{what}: {key} shape {tuple(out[key].shape)}")
        check(bool(torch.isfinite(out["boxes"]).all()
                   and torch.isfinite(out["scores"]).all()),
              f"{what}: non-finite detections")
        per_image = out["valid"].sum(dim=1)
        check(bool((per_image > 0).all()),
              f"{what}: an image of a batch-{b} request has no detection")
        print(f"{what} request batch {b}: detections per image min "
              f"{int(per_image.min())} median {int(per_image.median())} max "
              f"{int(per_image.max())}; score range "
              f"{float(out['scores'][out['valid']].min()):.4f}.."
              f"{float(out['scores'][out['valid']].max()):.4f}")


def same_detections(a, b, min_score: float, what: str) -> None:
    """Detection identity both ways (testing.match_detections)."""
    from yolov3_tensorflow_tpu_torch.testing import match_detections
    n1, f1 = match_detections(a, b, min_score)
    n2, f2 = match_detections(b, a, min_score)
    print(f"{what}: {f1}/{n1} found one way, {f2}/{n2} the other "
          f"(score >= {min_score:.2f})")
    check(n1 > 0 and n2 > 0, f"{what}: no detections to compare")
    check(f1 == n1 and f2 == n2, f"{what}: detections differ")


def probe_phase(dev: torch.device, card: str, launches: dict, max_err: dict,
                kernel_ms: dict, bounds: dict, library: dict) -> float:
    """Phase 9: K3 and K4 against their plain versions, the probes' own run
    (counted), each kernel against its plain version in turns and K3
    against its library yardstick. Fills the five records' entries for
    both kernels; returns the measured bf16 matmul peak (TF/s)."""
    from yolov3_tensorflow_tpu_torch.scripts import exp_mxu_shapes as probes
    from yolov3_tensorflow_tpu_torch.scripts import roofline
    checked = {}
    max_err["mma_rate"] = max_err["patch_build"] = 0.0
    for name, k, n in probes.SHAPES:
        a, b = probes.mma_operands(probes.M_TOTAL, k, n, dev)
        got = probes.mma_chain(a, b, probes.REPS)
        want = probes.mma_chain_reference(a, b, probes.REPS)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        rel = err / float(want.abs().max())
        max_err["mma_rate"] = max(max_err["mma_rate"], err)
        print(f"mma_rate {name.strip()}: M={probes.M_TOTAL} K={k} N={n} "
              f"reps={probes.REPS} max|kernel-plain| {err:.6g}, relative "
              f"{rel:.3g} (limit {K3_RTOL})")
        check(rel <= K3_RTOL, f"mma_rate differs from its plain version at "
                              f"{name.strip()}: relative {rel:.3g}")
        checked[name.strip()] = (a, b)
    for c in probes.WIDTHS:
        x = probes.patch_operand(probes.PATCH_M, c, dev)
        got = probes.concat_patches(x)
        want = probes.concat_patches_reference(x)
        torch.cuda.synchronize()
        same = torch.equal(got, want)
        print(f"patch_build c={c}: M={probes.PATCH_M} -> "
              f"{tuple(got.shape)}, kernel == plain: {same}")
        check(same, f"patch_build differs from its plain version at c={c}")
        checked[c] = x

    probes.mma_chain.launches = 0
    probes.concat_patches.launches = 0
    t0 = time.perf_counter()
    pres = probes.run(dev)
    wall = time.perf_counter() - t0
    launches["mma_rate"] = probes.mma_chain.launches
    launches["patch_build"] = probes.concat_patches.launches
    for line in probes.report(pres):
        print(f"{line} [{card}]")
    print(f"probes: run in {wall:.2f} s wall; mma_rate launches "
          f"{launches['mma_rate']}, patch_build launches "
          f"{launches['patch_build']}")
    check(launches["mma_rate"] > 0 and launches["patch_build"] > 0,
          "the probes did not launch both kernels")
    peak = pres["peak_tflops"]
    for r in pres["mma"]:
        check(K3_RATIO[0] <= r["ratio"] <= K3_RATIO[1],
              f"mma_rate {r['name']}: 2x reps took {r['ratio']:.3f}x the "
              f"time, outside {K3_RATIO}")
        check(r["tflops"] <= 1.05 * peak,
              f"mma_rate {r['name']}: {r['tflops']:.1f} TF/s is over 1.05x "
              f"the measured peak {peak:.1f}: a collapsed chain")

    out_dtype = probes.library_out_dtype(dev)
    print(f"mma_rate library yardstick: {probes.REPS} back-to-back torch.mm, "
          f"{str(out_dtype).replace('torch.', '')} output")
    for name, k, n in probes.SHAPES:
        a, b = checked[name.strip()]
        k_ms, p_ms, k_runs, p_runs = in_turns(
            lambda: probes.mma_chain(a, b, probes.REPS),
            lambda: probes.mma_chain_reference(a, b, probes.REPS), 10, 2)
        lib_ms = probes.library_ms(a, b, probes.REPS, out_dtype)
        bound = roofline.bound_mma_chain(probes.M_TOTAL, k, n, probes.REPS)
        if name.strip() == K3_RECORD:
            kernel_ms["mma_rate"] = (k_ms, p_ms)
            bounds["mma_rate"], library["mma_rate"] = bound, lib_ms
        tf = 2.0 * probes.M_TOTAL * k * n * probes.REPS / 1e9
        print(f"mma_rate {name.strip()} K={k} N={n}: kernel {k_ms:.4f} ms "
              f"(runs {k_runs[0]:.4f}, {k_runs[1]:.4f}) {tf / k_ms:.1f} "
              f"TF/s, torch.mm {lib_ms:.4f} ms {tf / lib_ms:.1f} TF/s, plain "
              f"PyTorch {p_ms:.4f} ms (runs {p_runs[0]:.4f}, "
              f"{p_runs[1]:.4f}); bound {bound[0]:.4f} ms ({bound[1]}): "
              f"{bound[0] / k_ms * 100:.1f}% [{card}]")
    for c in probes.WIDTHS:
        x = checked[c]
        k_ms, p_ms, k_runs, p_runs = in_turns(
            lambda: probes.concat_patches(x),
            lambda: probes.concat_patches_reference(x), 50, 20)
        bound = roofline.bound_patch_build(probes.PATCH_M, c, probes.TAPS)
        if c == K4_RECORD:
            kernel_ms["patch_build"] = (k_ms, p_ms)
            # the plain version is one torch.cat of 9 strided views: the
            # single library call that computes the same function
            bounds["patch_build"], library["patch_build"] = bound, p_ms
        print(f"patch_build c={c}: kernel {k_ms:.4f} ms (runs "
              f"{k_runs[0]:.4f}, {k_runs[1]:.4f}), plain PyTorch (torch.cat) "
              f"{p_ms:.4f} ms (runs {p_runs[0]:.4f}, {p_runs[1]:.4f}); bound "
              f"{bound[0]:.4f} ms ({bound[1]}): {bound[0] / k_ms * 100:.1f}% "
              f"[{card}]")
    del checked
    return peak


def roofline_phase(dev: torch.device, card: str, variables: dict,
                   packed_ms: float, peak: float) -> None:
    """Phase 10: the stage profile at batch 128 (its copy probe gives the
    bandwidth), the roofline of the batch-128 forward from the two measured
    constants, the packed detector's measured ms/batch (`packed_ms`) as a
    share of its bound, and the stage table."""
    from yolov3_tensorflow_tpu_torch.scripts import profile_stages, roofline
    t0 = time.perf_counter()
    prof = profile_stages.profile(variables, ROOF_BATCH, (SIZE, SIZE),
                                  device=dev)
    prof_wall = time.perf_counter() - t0
    hbm = max(gbs for _, _, gbs in prof["copy"])
    print(f"roofline constants: bf16 matmul peak {peak:.1f} TF/s "
          f"(torch.matmul 8192^3), bandwidth {hbm:.1f} GB/s (the better "
          f"copy probe at batch {ROOF_BATCH}) [{card}]")
    bound = roofline.roofline(ROOF_BATCH, (SIZE, SIZE), peak, hbm)
    for line in roofline.report(bound, ROOF_BATCH, (SIZE, SIZE),
                                measured_ms=packed_ms):
        print(line)
    share = bound["t_bound"] * 1e3 / packed_ms
    print(f"packed detector batch {ROOF_BATCH}: {packed_ms:.3f} ms/batch "
          f"measured (phase 8), bound {bound['t_bound'] * 1e3:.3f} ms: "
          f"{share * 100:.1f}% of the bound [{card}]")
    check(0.0 < share < 1.0, f"the detector read {share:.2f} of its lower "
                             f"bound: the measurement or the bound is wrong")
    print(f"stage profile at batch {ROOF_BATCH} ({prof_wall:.1f} s wall) "
          f"[{card}]:")
    for line in profile_stages.report(prof, ROOF_BATCH):
        print(f"  {line}")


def run_cli(main_fn, argv, module) -> tuple:
    """One CLI run with the kernels' counts set to 0 just before it and
    read just after, its standard output captured and the boxes it draws
    recorded (`module.plot_one_box` wrapped for the run). Returns (rc,
    stdout, the boxes drawn, shared-candidate launches, per-group launches,
    wall seconds)."""
    import contextlib
    import io

    from yolov3_tensorflow_tpu_torch.ops import nms_cuda
    plot, drawn = module.plot_one_box, []

    def counting_plot(img, coord, **kw):
        drawn.append(coord)
        plot(img, coord, **kw)

    module.plot_one_box = counting_plot
    out = io.StringIO()
    try:
        torch.cuda.synchronize()
        nms_cuda.nms_keep_mask_shared.launches = 0
        nms_cuda.nms_keep_mask.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = main_fn(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        module.plot_one_box = plot
    return (rc, out.getvalue(), drawn,
            nms_cuda.nms_keep_mask_shared.launches,
            nms_cuda.nms_keep_mask.launches, wall)


def video_frames(path: Path) -> list:
    """Shapes of the frames cv2 reads back from a video file."""
    import cv2
    cap = cv2.VideoCapture(str(path))
    shapes = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        shapes.append(frame.shape)
    cap.release()
    return shapes


def cli_phase(dev: torch.device, card: str, variables: dict,
              anchors: np.ndarray, max_err: dict) -> None:
    """Phase 11: the entry points. Both CLIs (cli.detect_image,
    cli.detect_video) at COCO-80, 416x416, bf16, the demo thresholds, on
    `variables` written to a .weights file, seeded 480x640 BGR jpgs and a
    24-frame 480x640 video; then the streaming detector itself (K1 on its
    own candidates against the plain version, the device letterbox against
    the CPU's, fp32 detections against the CPU's) and its timings."""
    import cv2

    from yolov3_tensorflow_tpu_torch.cli import detect_image, detect_video
    from yolov3_tensorflow_tpu_torch.models.yolov3 import \
        yolov3_forward_folded
    from yolov3_tensorflow_tpu_torch.ops import nms_cuda
    from yolov3_tensorflow_tpu_torch.ops.fast_postprocess import (
        packed_candidates, prefilter_candidates, yolov3_forward_packed)
    from yolov3_tensorflow_tpu_torch.ops.preprocess import (
        STREAM_BOX_TOPK, build_streaming_detector, device_letterbox)
    from yolov3_tensorflow_tpu_torch.utils.profiling import (cuda_ms,
                                                             device_busy_ms)
    from yolov3_tensorflow_tpu_torch.utils.weights import save_darknet_weights

    rng = np.random.default_rng(11)
    frames = rng.integers(0, 256, (CLI_FRAMES,) + CLI_SRC_HW + (3,),
                          dtype=np.uint8)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        weights = tmp / "spread_coco80.weights"
        save_darknet_weights(variables, str(weights), C)
        images = []
        for i in range(2):
            images.append(tmp / f"in{i}.jpg")
            check(cv2.imwrite(str(images[-1]), frames[i]),
                  "cv2 cannot write a jpg")
        video = tmp / "in.mp4"
        writer = cv2.VideoWriter(str(video), cv2.VideoWriter_fourcc(*"mp4v"),
                                 25, (CLI_SRC_HW[1], CLI_SRC_HW[0]))
        check(writer.isOpened(), "cv2 cannot write an mp4v video here")
        for frame in frames:
            writer.write(frame)
        writer.release()
        check(len(video_frames(video)) == CLI_FRAMES,
              "cv2 does not read back the input video")

        common = ["--restore_path", str(weights), "--device", str(dev),
                  "--new_size", str(SIZE), str(SIZE)]
        for mode, image, kernel in (("prefilter", images[0], "nms_shared"),
                                    ("exact", images[1], "nms"),
                                    ("split", images[0], "nms_shared")):
            out = tmp / f"out_{mode}.jpg"
            argv = [str(image), *common, "--output", str(out)]
            if mode != "prefilter":          # prefilter is the default
                argv += ["--mode", mode]
            rc, _, boxes, k1, k2, wall = run_cli(detect_image.main, argv,
                                                 detect_image)
            drawn = len(boxes)
            print(f"detect_image --mode {mode} ({SIZE}^2, bf16): rc {rc}, "
                  f"{drawn} boxes drawn, nms_shared launches {k1}, nms "
                  f"launches {k2}, {wall:.2f} s wall (weights load and "
                  f"first call included)")
            check(rc == 0, f"detect_image --mode {mode} returned {rc}")
            got = cv2.imread(str(out))
            check(got is not None and got.shape == CLI_SRC_HW + (3,),
                  f"detect_image --mode {mode}: output image "
                  f"{None if got is None else got.shape}")
            check(drawn > 0, f"detect_image --mode {mode}: no detections")
            want = {"nms_shared": (1, 0), "nms": (0, 1)}[kernel]
            check((k1, k2) == want, f"detect_image --mode {mode}: launches "
                                    f"(nms_shared, nms) {(k1, k2)}, want "
                                    f"{want}")

        runs = (("streaming prefilter, frame batch 1", ["--frame_batch", "1"],
                 CLI_FRAMES),
                ("streaming prefilter, frame batch 8", ["--frame_batch", "8"],
                 CLI_FRAMES // 8),
                ("streaming packed, frame batch 8",
                 ["--mode", "packed", "--frame_batch", "8"], CLI_FRAMES // 8),
                ("host preprocessing, prefilter, frame batch 1",
                 ["--device_preprocess", "false"], CLI_FRAMES),
                ("host preprocessing, split, frame batch 8",
                 ["--mode", "split", "--device_preprocess", "false",
                  "--frame_batch", "8"], CLI_FRAMES // 8))
        for i, (name, extra, dispatches) in enumerate(runs):
            out = tmp / f"out{i}.mp4"
            argv = [str(video), *common, "--save_video", "true", "--output",
                    str(out), *extra]
            rc, text, boxes, k1, k2, wall = run_cli(detect_video.main, argv,
                                                    detect_video)
            drawn = len(boxes)
            fps = [line for line in text.splitlines() if "FPS" in line]
            print(f"detect_video {name}: rc {rc}, {fps[-1] if fps else '?'}; "
                  f"{drawn} boxes drawn, nms_shared launches {k1} "
                  f"(dispatches {dispatches}), nms launches {k2}, "
                  f"{wall:.2f} s wall [{card}]")
            check(rc == 0, f"detect_video {name} returned {rc}")
            shapes = video_frames(out)
            check(shapes == [CLI_SRC_HW + (3,)] * CLI_FRAMES,
                  f"detect_video {name}: {len(shapes)} frames out")
            check(drawn > 0, f"detect_video {name}: no detections")
            check((k1, k2) == (dispatches, 0),
                  f"detect_video {name}: launches (nms_shared, nms) "
                  f"{(k1, k2)}, want {(dispatches, 0)}")

    # the streaming detector itself
    src = f"{CLI_SRC_HW[0]}x{CLI_SRC_HW[1]}"
    host = torch.from_numpy(frames[:8])
    on_dev = host.to(dev)
    lb_dev = device_letterbox(on_dev[:2], (SIZE, SIZE))
    lb_cpu = device_letterbox(host[:2], (SIZE, SIZE))
    err = float((lb_dev.cpu() - lb_cpu).abs().max())
    print(f"device_letterbox {src} -> {SIZE}^2, GPU against CPU: max |diff| "
          f"{err * 255:.3g} of 255 (limit {LETTERBOX_ATOL * 255:.3g})")
    check(err <= LETTERBOX_ATOL, "device_letterbox differs on the GPU")
    for mode in ("prefilter", "packed"):
        detect, _ = build_streaming_detector(
            variables, anchors, C, CLI_SRC_HW, (SIZE, SIZE), device=dev,
            bgr_input=True, mode=mode, **STREAM)
        det = detect.detector
        with torch.inference_mode():
            images = device_letterbox(on_dev.flip(-1), (SIZE, SIZE))
            if mode == "prefilter":
                boxes, scores = prefilter_candidates(yolov3_forward_folded(
                    det.folded, images, compute_dtype=torch.bfloat16), C,
                    det.tables, STREAM_BOX_TOPK)
            else:
                boxes, scores = packed_candidates(yolov3_forward_packed(
                    det.packed, images, compute_dtype=torch.bfloat16), C,
                    det.tables, STREAM_BOX_TOPK)
            st, it = STREAM["score_thresh"], STREAM["iou_thresh"]
            keep = nms_cuda.nms_keep_mask_shared(boxes, scores, st, it)
            want = nms_cuda.nms_keep_mask_shared_reference(boxes, scores,
                                                           st, it)
        err = float((keep.float() - want.float()).abs().max())
        max_err["nms_shared"] = max(max_err["nms_shared"], err)
        print(f"streaming {mode} candidates B=8 K={boxes.shape[1]} C={C}: "
              f"kept {int(want.sum())} of {int((scores >= st).sum())} valid; "
              f"kernel == plain: {err == 0.0}")
        check(err == 0.0, f"streaming {mode}: kernel and plain keep masks "
                          f"differ")

        # fp32 on the GPU against fp32 on the CPU, 2 frames
        two = host[:2]
        g32 = build_streaming_detector(
            variables, anchors, C, CLI_SRC_HW, (SIZE, SIZE), device=dev,
            bgr_input=True, mode=mode, compute_dtype=torch.float32,
            **STREAM)[0](two)
        c32 = build_streaming_detector(
            variables, anchors, C, CLI_SRC_HW, (SIZE, SIZE),
            device=torch.device("cpu"), bgr_input=True, mode=mode,
            compute_dtype=torch.float32, **STREAM)[0](two)
        same_detections(detections(c32, 2), detections(g32, 2),
                        STREAM["score_thresh"] + 0.02,
                        f"streaming {mode} fp32 GPU vs fp32 CPU")

        for fb in STREAM_BATCHES:
            x = host[:fb].pin_memory()
            for _ in range(3):
                detect(x)
            ms = call_ms(lambda: detect(x), 30 if fb == 1 else 10)
            busy = device_busy_ms(lambda: detect(x), 5)
            print(f"streaming {mode} frame batch {fb} (uint8 {src} pinned "
                  f"on the host -> {SIZE}^2 detections): {ms:.3f} ms/call, "
                  f"{ms / fb:.3f} ms/frame, {fb * 1000.0 / ms:.1f} frames/s; "
                  f"device busy {busy:.3f} ms/call, idle share "
                  f"{1 - busy / ms:.3f} [{card}]")
    for fb in STREAM_BATCHES:
        x = host[:fb].pin_memory()
        ms = cuda_ms(lambda: x.to(dev, non_blocking=True), 50)
        print(f"uint8 host-to-device copy of {fb} frame(s) (pinned, "
              f"{x.numel() / 1e6:.3f} MB): {ms:.4f} ms on the device, "
              f"{x.numel() / ms / 1e6:.1f} GB/s [{card}]")


def to_device(tree, dev: torch.device):
    """A nest of dicts of tensors (and numbers) on `dev`."""
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    return tree.to(dev) if isinstance(tree, torch.Tensor) else tree


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / max |want|."""
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def train_config(compute_dtype: str, optimizer: str, **train):
    """A finalized COCO-80 Config with a fixed learning rate and no freeze."""
    from yolov3_tensorflow_tpu_torch.config import Config
    cfg = Config()
    cfg.model.compute_dtype = compute_dtype
    cfg.train.optimizer = optimizer
    cfg.train.lr_type = "fixed"
    cfg.train.learning_rate_init = 1e-3
    cfg.train.use_warm_up = False
    cfg.train.update_part = None
    for key, value in train.items():
        setattr(cfg.train, key, value)
    return cfg.finalize(count_files=False)


def train_step_fn(cfg, **modes):
    """(make_train_step(cfg, optimizer, **modes), optimizer) for a Config;
    `modes` are make_train_step's device data path arguments."""
    from yolov3_tensorflow_tpu_torch.train.optimizers import build_optimizer
    from yolov3_tensorflow_tpu_torch.train.schedules import build_schedule
    from yolov3_tensorflow_tpu_torch.train.trainer import make_train_step
    sched = build_schedule(cfg)
    opt = build_optimizer(cfg.train.optimizer, sched)
    return make_train_step(cfg, opt, schedule=sched, **modes), opt


def fresh_state(opt, dev: torch.device) -> dict:
    """The seed-0 init_yolov3 tree on `dev`, with its optimizer state."""
    from yolov3_tensorflow_tpu_torch.models.yolov3 import init_yolov3
    v = to_device(init_yolov3(torch.Generator().manual_seed(0), C,
                              device=torch.device("cpu")), dev)
    return {"params": v["params"], "batch_stats": v["batch_stats"],
            "opt_state": opt.init(v["params"]), "step": 0}


def fro(got, want) -> float:
    """|got - want| / |want| in the Frobenius norm."""
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def one_step_check(dev: torch.device, card: str, batch) -> None:
    """Training, part 1: one fp32 momentum step (TF32 off) of the same
    seed-0 tree on the same loader batch of 2 at 416^2, on the GPU and on
    the CPU. fp32 training-mode batch norm amplifies rounding through 72
    layers (tests/test_torch_train_model.py), so the gradient of some leaves
    is reproducible only to a few percent, by either device alone; the
    GPU's noise is measured as the same step on the batch in reverse order
    (the same step mathematically). Checks, each relative to the largest
    magnitude: every loss term within 1e-4 or twice its noise; the BN moving
    statistics within 1e-5 or twice the largest noise of any leaf; the
    updates of the detection convs (which no batch norm precedes) within
    1e-3; every leaf's update, in norm, within 1e-3 or twice the largest
    noise of any leaf; all updates together within 1e-3 or twice their
    noise. It prints how many leaves lie past 1e-3 in their largest
    element."""
    from yolov3_tensorflow_tpu_torch.models.yolov3 import DETECTION_CONVS
    from yolov3_tensorflow_tpu_torch.train.optimizers import flatten
    cpu = torch.device("cpu")
    step, opt = train_step_fn(train_config("float32", "momentum"))

    def run(device, order):
        state = fresh_state(opt, device)
        images = torch.from_numpy(batch.images[order].copy()).to(device)
        y_true = tuple(torch.from_numpy(y[order].copy()).to(device)
                       for y in batch.y_true)
        t0 = time.perf_counter()
        new, metrics = step(state, images, y_true)
        metrics = {k: v for k, v in metrics.items() if k != "lr"}
        if device.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        before = flatten(state["params"])
        updates = {p: (t - before[p]).cpu()
                   for p, t in flatten(new["params"]).items()}
        return (to_device(metrics, cpu), flatten(to_device(
            new["batch_stats"], cpu)), updates, wall)

    fwd, rev = slice(None), slice(None, None, -1)
    g, g_rev, c = run(dev, fwd), run(dev, rev), run(cpu, fwd)
    print(f"training one step (fp32, momentum, batch 2 at {SIZE}^2, seed-0 "
          f"init): GPU {g[3]:.2f} s, CPU {c[3]:.2f} s wall (first calls)")

    def within(err, tol, noise, what):
        check(err <= max(tol, 2 * noise), f"training one step: {what} GPU "
              f"vs CPU {err:.3g}, over {tol} and twice the GPU's reorder "
              f"noise {noise:.3g}")

    for k in sorted(c[0]):
        within(rel_err(g[0][k], c[0][k]), 1e-4, rel_err(g_rev[0][k], g[0][k]),
               f"loss {k}")
    print("  loss terms GPU / CPU: " + ", ".join(
        f"{k} {float(g[0][k]):.6f} / {float(c[0][k]):.6f}"
        for k in ("total", "xy", "wh", "conf", "class", "l2")))
    stats_noise = max(rel_err(g_rev[1][p], g[1][p]) for p in c[1])
    stats_err = {p: rel_err(g[1][p], c[1][p]) for p in c[1]}
    for p, err in stats_err.items():
        within(err, 1e-5, stats_noise, f"BN statistics {p}")
    u_g, u_rev, u_c = g[2], g_rev[2], c[2]
    det = [f"head/{n}/{k}" for n in DETECTION_CONVS for k in ("w", "b")]
    for p in det:
        within(rel_err(u_g[p], u_c[p]), 1e-3, 0.0, f"update of {p}")
    leaf_noise = max(fro(u_rev[p], u_g[p]) for p in u_c)
    leaf_err = {p: fro(u_g[p], u_c[p]) for p in u_c}
    for p, err in leaf_err.items():
        within(err, 1e-3, leaf_noise, f"update of {p} (norm)")

    def whole(d):
        return torch.cat([d[p].reshape(-1) for p in u_c])
    all_err, all_noise = fro(whole(u_g), whole(u_c)), fro(whole(u_rev),
                                                           whole(u_g))
    within(all_err, 1e-3, all_noise, "all updates (norm)")
    past = sum(rel_err(u_g[p], u_c[p]) > 1e-3 for p in u_c)
    worst = max((e, p) for p, e in leaf_err.items())
    det_worst = max(rel_err(u_g[p], u_c[p]) for p in det)
    print(f"  BN moving statistics: {len(c[1])} leaves, worst "
          f"{max(stats_err.values()):.3g} of the leaf's largest (GPU noise "
          f"{stats_noise:.3g}); updates: {len(u_c)} leaves, all together "
          f"{all_err:.3g} in norm (GPU noise {all_noise:.3g}), worst leaf "
          f"{worst[0]:.3g} ({worst[1]}; GPU noise up to {leaf_noise:.3g}), "
          f"detection convs worst {det_worst:.3g} of their largest, "
          f"{past} leaves past 1e-3 in their largest "
          f"element [{card}]")


def learning_check(dev: torch.device, card: str, ann: str, anchors):
    """Training, part 2: 30 bf16 Adam steps (lr 1e-3) on 8 synthetic 416^2
    images (labels 0..2 under the 80-class head), one loader batch per step;
    the mean of the last 3 totals must be under half the first 3's. Returns
    the trained state and the last batch."""
    from yolov3_tensorflow_tpu_torch.data.loader import DataLoader
    step, opt = train_step_fn(train_config("bfloat16", "adam"))
    state = fresh_state(opt, dev)
    loader = DataLoader(ann, C, anchors, 8, (SIZE, SIZE), mode="train",
                        use_mix_up=False, use_color_distort=False,
                        num_threads=8, seed=0)
    totals = []
    t0 = time.perf_counter()
    for i in range(LEARN_STEPS):
        batch = next(iter(loader.epoch(i)))
        state, metrics = step(
            state, torch.from_numpy(batch.images).to(dev),
            tuple(torch.from_numpy(y).to(dev) for y in batch.y_true))
        totals.append(metrics["total"])
    totals = torch.stack(totals).tolist()
    first, last = np.mean(totals[:3]), np.mean(totals[-3:])
    print(f"training learns: {LEARN_STEPS} bf16 Adam steps at batch 8, "
          f"{SIZE}^2, in {time.perf_counter() - t0:.1f} s wall: total loss "
          f"{', '.join(f'{t:.1f}' for t in totals[:3])} ... "
          f"{', '.join(f'{t:.1f}' for t in totals[-3:])}; first 3 mean "
          f"{first:.2f}, last 3 mean {last:.2f} [{card}]")
    check(np.isfinite(totals).all(), "training learns: a loss is not finite")
    check(last < first / 2, f"training learns: the loss did not halve "
                            f"({first:.2f} -> {last:.2f})")
    return state, batch


def cli_train_runs(dev: torch.device, card: str, tmp: Path) -> float:
    """Training, part 3: cli.train on the GPU with the reference recipe
    (momentum, piecewise lr with a 1-epoch warm-up, mixup, color
    distortion, label smoothing, focal loss, multi-scale over the default
    sizes), bf16, on 64 train and 8 val synthetic 416^2 images: batch 8,
    3 epochs, in-train evaluation every 8 steps, validation every epoch
    from epoch 1. Then a second run with 4 epochs and auto_resume resumes
    from the newest checkpoint (the last run's best, at step 16 or 24) and
    trains to the end of epoch 4, step 32. K2's launches are
    counted in each run: once per in-train evaluation (every 8th global
    step) and once per validation batch. Returns the first run's StepTimer
    p50 (ms)."""
    import contextlib
    import io
    import re

    from yolov3_tensorflow_tpu_torch.cli import train as cli_train
    from yolov3_tensorflow_tpu_torch.ops import nms_cuda
    argv = ["--device", str(dev),
            f"data.train_file={tmp / 'train' / 'train.txt'}",
            f"data.val_file={tmp / 'val' / 'val.txt'}",
            "train.batch_size=8", "train.train_evaluation_step=8",
            "train.val_evaluation_epoch=1", "train.warm_up_epoch=1",
            f"train.save_dir={tmp / 'ckpt'}", f"train.log_dir={tmp / 'logs'}",
            f"train.progress_log_path={tmp / 'progress.log'}"]
    steps_per_epoch = TRAIN_IMAGES // 8
    p50 = None
    for epochs, resume in ((3, False), (4, True)):
        run_argv = argv + [f"train.total_epochs={epochs}",
                           f"train.auto_resume={str(resume).lower()}"]
        before = set(os.listdir(tmp / "ckpt")) if resume else set()
        torch.cuda.synchronize()
        nms_cuda.nms_keep_mask.launches = 0
        nms_cuda.nms_keep_mask_shared.launches = 0
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli_train.main(run_argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k2 = nms_cuda.nms_keep_mask.launches
        text = out.getvalue()
        log = (tmp / "progress.log").read_text()
        check(rc == 0, f"cli.train ({epochs} epochs) returned {rc}")
        losses = [float(v) for v in re.findall(r"loss: total: (\S+),", log)]
        check(losses and np.isfinite(losses).all(),
              f"cli.train ({epochs} epochs): losses {losses}")
        resumed_at = 0
        if resume:
            m = re.search(r"auto-resumed from (\S+) at step (\d+)", text)
            check(m is not None, "cli.train did not auto-resume")
            latest, resumed_at = Path(m.group(1)).name, int(m.group(2))
            saved = int(re.search(r"_step_(\d+)_", latest).group(1))
            check(latest in before and resumed_at == saved,
                  f"cli.train resumed from {latest} at step {resumed_at}")
        ends = [int(s) for s in re.findall(r"global_step: (\d+)", log)]
        check(ends and max(ends) == epochs * steps_per_epoch,
              f"cli.train ({epochs} epochs) ended at step "
              f"{max(ends) if ends else None}")
        first_epoch = resumed_at // steps_per_epoch
        evals = epochs * steps_per_epoch // 8 - resumed_at // 8
        vals = sum(1 for e in range(first_epoch, epochs) if e >= 1)
        best = [n for n in os.listdir(tmp / "ckpt")
                if n.startswith("best_model_")]
        check(best, "cli.train wrote no best_model_ checkpoint")
        check(k2 == evals + vals and nms_cuda.nms_keep_mask_shared.launches
              == 0, f"cli.train ({epochs} epochs): nms launches {k2}, want "
                    f"{evals} in-train evaluations + {vals} validation "
                    f"batches")
        times = re.findall(r"step time: p50 (\S+) ms", log)
        if not resume:
            p50 = float(times[-1])
        how = f", auto-resumed at step {resumed_at}" if resume else ""
        print(f"cli.train, {epochs} epochs{how}: "
              f"rc {rc}, {wall:.1f} s wall, steps to {max(ends)}, losses "
              f"{losses[0]:.2f} .. {losses[-1]:.2f}, nms launches {k2} "
              f"({evals} in-train evaluations + {vals} validation batches), "
              f"checkpoints {sorted(os.listdir(tmp / 'ckpt'))}; StepTimer "
              f"p50 per epoch {', '.join(times)} ms [{card}]")
    return p50


def step_timing(dev: torch.device, card: str, fn, b: int,
                what: str) -> tuple:
    """A bf16 train step at batch b, 416^2: 3 warm-up calls, then ms per
    step with host gaps (call_ms), device busy time, idle share, peak
    memory and the share of 3x the forward's roofline bound, printed.
    Returns (ms, busy ms, peak GiB)."""
    from yolov3_tensorflow_tpu_torch.scripts import roofline
    from yolov3_tensorflow_tpu_torch.utils.profiling import device_busy_ms
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for _ in range(3):
        fn()
    ms = call_ms(fn, 10)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    busy = device_busy_ms(fn, 3)
    bound = 3 * roofline.roofline(
        b, (SIZE, SIZE), roofline.H100_PEAKS["bf16"] / 1e12,
        roofline.H100_PEAKS["hbm"] / 1e9)["t_bound"]
    print(f"train step batch {b} at {SIZE}^2 (bf16, momentum, no freeze, "
          f"{what}): {ms:.3f} ms/step (host gaps included), "
          f"{b * 1000.0 / ms:.1f} img/s; device busy {busy:.3f} ms/step, "
          f"idle share {1 - busy / ms:.3f}; peak memory "
          f"{peak:.2f} GiB; bound {bound * 1e3:.3f} ms (3x the forward's "
          f"roofline bound, published peaks): {bound * 1e3 / ms * 100:.1f}% "
          f"of it [{card}]")
    return ms, busy, peak


def loader_rate(loader) -> float:
    """Images per second of a loader alone over its second epoch (the
    first warms up)."""
    for epoch in range(2):
        t0 = time.perf_counter()
        n = sum(len(b.image_ids) for b in loader.epoch(epoch))
        wall = time.perf_counter() - t0
    return n / wall


def train_phase(dev: torch.device, card: str, anchors: np.ndarray,
                max_err: dict) -> dict:
    """Phase 12: training (see the module docstring). Returns the train
    step's timings by batch, as `step_timing` gives them, each followed by
    the timed call (phase 13 times it again in turns with its own)."""
    from yolov3_tensorflow_tpu_torch.data.loader import DataLoader
    from yolov3_tensorflow_tpu_torch.data.synthetic import generate_dataset
    from yolov3_tensorflow_tpu_torch.models.decode import predict_boxes
    from yolov3_tensorflow_tpu_torch.models.yolov3 import yolov3_forward
    from yolov3_tensorflow_tpu_torch.ops import nms_cuda
    from yolov3_tensorflow_tpu_torch.ops.nms import select_per_class

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        train = generate_dataset(str(tmp / "train"), TRAIN_IMAGES, seed=0,
                                 img_size=(SIZE, SIZE), prefix="train")
        generate_dataset(str(tmp / "val"), 8, seed=1, img_size=(SIZE, SIZE),
                         prefix="val")
        learn = generate_dataset(str(tmp / "learn"), 8, seed=2,
                                 img_size=(SIZE, SIZE), prefix="learn")
        print(f"training data: {TRAIN_IMAGES} + 8 + 8 synthetic {SIZE}^2 "
              f"images in {time.perf_counter() - t0:.1f} s")

        # ---- part 1: one step, GPU against CPU
        two = next(iter(DataLoader(train["annotation_file"], C, anchors, 2,
                                   (SIZE, SIZE), mode="train",
                                   use_mix_up=False, num_threads=2,
                                   seed=0).epoch(0)))
        one_step_check(dev, card, two)

        # ---- part 2: learning on the card
        state, batch = learning_check(dev, card, learn["annotation_file"],
                                      anchors)

        # ---- part 4: K2 on the eval step's own candidates
        cfg = train_config("bfloat16", "adam")
        with torch.no_grad():
            images = torch.from_numpy(batch.images).to(dev)
            fmaps, _ = yolov3_forward(
                {"params": state["params"], "batch_stats":
                 state["batch_stats"]}, images, train=False,
                compute_dtype=torch.bfloat16)
            boxes, confs, probs = predict_boxes(fmaps, anchors, C,
                                                (SIZE, SIZE))
            _, top_boxes, valid = select_per_class(
                boxes, confs * probs, cfg.eval.pre_nms_topk,
                cfg.eval.score_threshold)
            b, _, k = valid.shape
            max_err["nms"] = max(max_err["nms"], keep_mask_error(
                top_boxes.reshape(b * C, k, 4).contiguous(),
                valid.reshape(b * C, k).contiguous(),
                cfg.eval.nms_threshold, f"eval-step candidates (after "
                f"{LEARN_STEPS} steps)"))

        # ---- part 3: cli.train
        p50 = cli_train_runs(dev, card, tmp)

        # ---- part 5: timings
        step, opt = train_step_fn(train_config("bfloat16", "momentum"))
        fresh = fresh_state(opt, dev)
        host_steps = {}
        for b in TRAIN_BATCHES:
            reps = b // batch.images.shape[0]
            images = torch.from_numpy(np.tile(batch.images, (reps, 1, 1, 1))
                                      ).to(dev)
            y_true = tuple(torch.from_numpy(np.tile(
                y, (reps,) + (1,) * (y.ndim - 1))).to(dev)
                for y in batch.y_true)
            fn = functools.partial(step, fresh, images, y_true)
            host_steps[b] = step_timing(dev, card, fn, b,
                                        "device-resident batch") + (fn,)
        loader = DataLoader(train["annotation_file"], C, anchors, 8,
                            (SIZE, SIZE), mode="train", use_mix_up=True,
                            use_color_distort=True, seed=0)
        rate = loader_rate(loader)
        print(f"host loader alone ({loader.num_threads} threads, {SIZE}^2, "
              f"mixup and color distortion on, batch 8): {rate:.1f} "
              f"images/s; cli.train StepTimer p50 {p50:.1f} ms/step [{card}]")
    return host_steps


def data_path_check(dev: torch.device, card: str, ann: str,
                    anchors: np.ndarray) -> None:
    """Device data path, part 1: one device-mode loader batch with the
    reference recipe (mixup, colour distortion, multi-scale, tiles of the
    largest bucket). The label grids from encode_labels_device on the GPU
    must equal the host encode_labels on the same padded ground truth bit
    for bit; augment_batch on the GPU must agree with the same function on
    the CPU within 1/255 everywhere and exactly on PIXEL_EQUAL of the
    pixels."""
    from yolov3_tensorflow_tpu_torch.data.device_augment import augment_batch
    from yolov3_tensorflow_tpu_torch.data.device_encode import \
        encode_labels_device
    from yolov3_tensorflow_tpu_torch.data.encoder import encode_labels
    from yolov3_tensorflow_tpu_torch.data.loader import DataLoader
    loader = DataLoader(ann, C, anchors, 8, (SIZE, SIZE), mode="train",
                        multi_scale=True, use_mix_up=True,
                        use_color_distort=True, num_threads=8, seed=0,
                        device_augment=True, staged_size=STAGED,
                        device_encode=True)
    batch = next(iter(loader.epoch(0)))
    size, n = tuple(batch.img_size), len(batch.image_ids)
    gt = [torch.from_numpy(a).to(dev)
          for a in (batch.gt_boxes, batch.gt_labels, batch.gt_mask)]
    grids = encode_labels_device(*gt, size, C, anchors)
    host = [encode_labels(batch.gt_boxes[i][batch.gt_mask[i]],
                          batch.gt_labels[i][batch.gt_mask[i]], size, C,
                          anchors) for i in range(n)]
    for s, grid in enumerate(grids):
        want = np.stack([h[s] for h in host])
        check(np.array_equal(grid.cpu().numpy(), want),
              f"encode_labels_device: grid {s} differs from the host's")
    occupied = sum(int((g[..., 4] > 0).sum()) for g in grids)
    print(f"device data path, one loader batch of {n} at {size[0]}x{size[1]} "
          f"(multi-scale), tiles {STAGED}^2, {int(batch.gt_mask.sum())} boxes "
          f"({occupied} occupied slots), "
          f"{int((batch.params['lam'] < 1).sum())} mixup pairs, "
          f"interpolation codes "
          f"{batch.params['interp'].tolist()}: GPU grids == host grids")

    def pixels(device):
        return augment_batch(
            torch.from_numpy(batch.staged).to(device),
            torch.from_numpy(batch.staged2).to(device),
            {k: torch.from_numpy(v).to(device)
             for k, v in batch.params.items()}, size, mixup=True,
            distort=True)
    got = torch.round(pixels(dev).cpu() * 255.0)
    want = torch.round(pixels(torch.device("cpu")) * 255.0)
    diff = (got - want).abs()
    share = float((diff == 0).double().mean())
    print(f"augment_batch GPU against CPU: max |diff| {float(diff.max()):.0f}"
          f" of 255, equal on {share * 100:.4f}% of {diff.numel()} values "
          f"(limits 1 and {PIXEL_EQUAL * 100:.1f}%) [{card}]")
    check(float(diff.max()) <= 1.0, "augment_batch: GPU and CPU differ by "
                                    "more than 1/255")
    check(share >= PIXEL_EQUAL, f"augment_batch: GPU equals CPU on only "
                                f"{share * 100:.3f}% of the values")


def copy_bytes(batch) -> int:
    """Bytes the trainer copies to the device for one loader batch: the
    arrays `Trainer._train_args` copies (`trainer.copied_arrays`)."""
    from yolov3_tensorflow_tpu_torch.train.trainer import copied_arrays
    return sum(a.nbytes for a in copied_arrays(batch).values())


def device_timings(dev: torch.device, card: str, ann: str,
                   anchors: np.ndarray, host_steps: dict) -> None:
    """Device data path, part 2: the bf16 train step in device mode at
    batch 8 and 32 beside phase 12's host-mode step, the prologue
    (augmentation and label grids) alone, the loader alone in both modes
    with the same threads and recipe (416^2, mixup and colour distortion,
    no multi-scale) and the bytes each mode copies per batch."""
    from yolov3_tensorflow_tpu_torch.data.device_augment import augment_batch
    from yolov3_tensorflow_tpu_torch.data.device_encode import \
        encode_labels_device
    from yolov3_tensorflow_tpu_torch.data.loader import DataLoader
    from yolov3_tensorflow_tpu_torch.utils.profiling import device_busy_ms

    def loader(device_mode: bool) -> DataLoader:
        return DataLoader(ann, C, anchors, 8, (SIZE, SIZE), mode="train",
                          multi_scale=False, use_mix_up=True,
                          use_color_distort=True, seed=0,
                          device_augment=device_mode, staged_size=STAGED,
                          device_encode=device_mode)

    dev_loader, host_loader = loader(True), loader(False)
    batch = next(iter(dev_loader.epoch(0)))
    host_batch = next(iter(host_loader.epoch(0)))
    step, opt = train_step_fn(train_config("bfloat16", "momentum"),
                              device_augment=True, device_encode=True)
    fresh = fresh_state(opt, dev)
    out_size = (SIZE, SIZE)
    for b in TRAIN_BATCHES:
        reps = b // len(batch.image_ids)

        def tiled(a):
            return torch.from_numpy(np.tile(a, (reps,) + (1,) * (a.ndim - 1))
                                    ).to(dev)
        staged = tiled(batch.staged)
        images = (staged, tiled(batch.staged2),
                  {k: tiled(v) for k, v in batch.params.items()})
        gt = (tiled(batch.gt_boxes), tiled(batch.gt_labels),
              tiled(batch.gt_mask))
        fn = functools.partial(step, fresh, images, gt, out_size=out_size)
        ms, busy, _ = step_timing(
            dev, card, fn, b, f"device data path: {STAGED}^2 uint8 tiles "
                              f"and padded ground truth on the device")
        h_ms, h_busy, _, h_fn = host_steps[b]
        print(f"  beside phase 12's host-mode step at batch {b}: {h_ms:.3f} "
              f"ms/step, busy {h_busy:.3f} ms; device mode +{ms - h_ms:.3f} "
              f"ms wall, +{busy - h_busy:.3f} ms busy [{card}]")
        # the host's wall time swings by tens of ms between calls (its cores
        # are shared): 4 turns of each mode, in the order h d d h h d d h
        turns = {"host": [], "device": []}
        for mode in ("host", "device", "device", "host") * 2:
            turns[mode].append(call_ms(h_fn if mode == "host" else fn, 10))
        med = {k: float(np.median(v)) for k, v in turns.items()}
        low = {k: min(v) for k, v in turns.items()}
        print(f"  in turns at batch {b} (h d d h h d d h, 10 steps each): "
              f"host mode {', '.join(f'{t:.3f}' for t in turns['host'])}, "
              f"device mode {', '.join(f'{t:.3f}' for t in turns['device'])}"
              f" ms/step; device mode {med['device'] - med['host']:+.3f} ms "
              f"by the medians, {low['device'] - low['host']:+.3f} ms by the "
              f"fastest turns [{card}]")

        def prologue():
            augment_batch(*images, out_size, mixup=True, distort=True)
            encode_labels_device(*gt, out_size, C, anchors)
        for _ in range(3):
            prologue()
        p_ms = call_ms(prologue, 10)
        p_busy = device_busy_ms(prologue, 3)
        print(f"  prologue alone at batch {b} (augment_batch + "
              f"encode_labels_device): {p_ms:.3f} ms (host gaps included), "
              f"device busy {p_busy:.3f} ms [{card}]")
    d_rate, h_rate = loader_rate(dev_loader), loader_rate(host_loader)
    print(f"loader alone ({dev_loader.num_threads} threads, {SIZE}^2, mixup "
          f"and color distortion on, batch 8): device mode {d_rate:.1f} "
          f"images/s, host mode {h_rate:.1f} images/s; copied per batch: "
          f"device mode {copy_bytes(batch) / 1e6:.3f} MB, host mode "
          f"{copy_bytes(host_batch) / 1e6:.3f} MB [{card}]")


def convert_check(dev: torch.device, variables: dict, tmp: Path) -> None:
    """Device data path, part 4a: cli.convert_weights of a .weights file of
    phase 4's tree into a checkpoint directory, whose tensors must equal the
    file's; cli.detect_image must draw the same boxes from both."""
    import contextlib
    import io

    import cv2

    from yolov3_tensorflow_tpu_torch.cli import convert_weights, detect_image
    from yolov3_tensorflow_tpu_torch.cli.common import load_variables
    from yolov3_tensorflow_tpu_torch.train.optimizers import flatten
    from yolov3_tensorflow_tpu_torch.utils.weights import save_darknet_weights

    weights = tmp / "spread_coco80.weights"
    save_darknet_weights(variables, str(weights), C)
    converted = tmp / "converted"
    with contextlib.redirect_stdout(io.StringIO()):
        rc = convert_weights.main(["--weights", str(weights), "--output",
                                   str(converted), "--num_classes", str(C),
                                   "--device", str(dev)])
    check(rc == 0, f"convert_weights returned {rc}")
    a = flatten(load_variables(str(weights), C, dev))
    b = flatten(load_variables(str(converted), C, dev))
    check(a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a),
          "convert_weights: the checkpoint's tensors differ from the "
          ".weights file's")
    image = tmp / "frame.jpg"
    rng = np.random.default_rng(11)
    check(cv2.imwrite(str(image), rng.integers(
        0, 256, CLI_SRC_HW + (3,), dtype=np.uint8)), "cv2 cannot write a jpg")
    drawn = []
    for source in (weights, converted):
        rc, _, boxes, k1, k2, _ = run_cli(
            detect_image.main, [str(image), "--restore_path", str(source),
                                "--device", str(dev), "--new_size",
                                str(SIZE), str(SIZE), "--output",
                                str(tmp / "out.jpg")], detect_image)
        check(rc == 0 and (k1, k2) == (1, 0),
              f"detect_image from {source.name}: rc {rc}, launches {(k1, k2)}")
        drawn.append([tuple(map(float, c)) for c in boxes])
    check(drawn[0] and drawn[0] == drawn[1],
          f"detect_image: {len(drawn[0])} boxes from the .weights file, "
          f"{len(drawn[1])} from its checkpoint, or not the same")
    print(f"convert_weights -> {len(a)} tensors equal; detect_image "
          f"--restore_path <.weights> and <checkpoint>: the same "
          f"{len(drawn[0])} boxes")


def gate_check(dev: torch.device, card: str, tmp: Path) -> float:
    """Device data path, parts 3 and 4b: the reduced overfit gate in device
    mode, graded by cli.evaluate.run_eval with the per-group kernel once per
    evaluate batch; then cli.strip_checkpoint of the gate's best checkpoint
    (written at its last epoch, with the optimizer state) and cli.evaluate
    of the stripped one, which must give the gate's mAP. The mAP limit is
    checked last, so that a gate short of it still tests the CLIs. Returns
    the gate's mAP."""
    import contextlib
    import io
    import math

    from yolov3_tensorflow_tpu_torch.cli import evaluate, strip_checkpoint
    from yolov3_tensorflow_tpu_torch.ops import nms_cuda
    from yolov3_tensorflow_tpu_torch.scripts import overfit_gate
    from yolov3_tensorflow_tpu_torch.train.checkpoint import CheckpointStore

    run_eval, evals = evaluate.run_eval, []

    def counted_eval(args):
        torch.cuda.synchronize()
        nms_cuda.nms_keep_mask.launches = 0
        nms_cuda.nms_keep_mask_shared.launches = 0
        result = run_eval(args)
        torch.cuda.synchronize()
        evals.append((result, nms_cuda.nms_keep_mask.launches,
                      nms_cuda.nms_keep_mask_shared.launches))
        return result

    # validation at the last epoch only: the trainer then also writes a
    # best checkpoint of the final state, with the optimizer state
    gate_dir = tmp / "gate"
    argv = ["--num_images", str(GATE_IMAGES), "--epochs", str(GATE_EPOCHS),
            "--img_size", str(SIZE), "--val_every", str(GATE_EPOCHS - 1),
            "--device_augment", "true", "--device_encode", "true",
            "--device", str(dev), "--out_dir", str(gate_dir)]
    out = io.StringIO()
    evaluate.run_eval = counted_eval
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = overfit_gate.main(argv)
        wall = time.perf_counter() - t0
    finally:
        evaluate.run_eval = run_eval
    summary = json.loads(out.getvalue().strip().splitlines()[-1])
    batches = math.ceil(GATE_IMAGES / 8)       # eval.batch_size 8
    result, k2, k1 = evals[0]
    print(f"overfit gate (adam, {summary['img_size']}^2, batch 8, "
          f"{GATE_IMAGES} images, {GATE_EPOCHS} epochs, {summary['steps']} "
          f"steps, device_augment and device_encode): rc {rc}, mAP "
          f"{result['mAP']:.6f}, recall {summary['recall']}, precision "
          f"{summary['precision']}, per-class AP {summary['per_class_ap']}, "
          f"final loss {summary['final_loss']}, train "
          f"{summary['train_seconds']} s, {wall:.1f} s wall; cli.evaluate "
          f"nms launches {k2} ({batches} batches), nms_shared {k1} [{card}]")
    check((k2, k1) == (batches, 0), f"overfit gate: cli.evaluate launched "
                                    f"(nms, nms_shared) {(k2, k1)}, want "
                                    f"{(batches, 0)}")

    store = CheckpointStore(str(gate_dir / "ckpt"))
    best = [n for n in store.list() if n.startswith("best_model_")]
    check(len(best) == 1, f"overfit gate: best checkpoints {best}")
    check("opt_state" in store.restore(best[0]),
          f"{best[0]} holds no optimizer state")
    stripped = tmp / "stripped"
    with contextlib.redirect_stdout(io.StringIO()):
        rc_strip = strip_checkpoint.main(["--input", store.path(best[0]),
                                          "--output", str(stripped)])
    keys = sorted(CheckpointStore(str(tmp)).restore(str(stripped)))
    check(rc_strip == 0 and "opt_state" not in keys,
          f"strip_checkpoint: rc {rc_strip}, keys {keys}")
    data = gate_dir / "data"
    again = counted_eval(evaluate.build_parser().parse_args([
        "--eval_file", str(data / "train.txt"), "--restore_path",
        str(stripped), "--class_name_path", str(data / "synth.names"),
        "--img_size", str(SIZE), str(SIZE), "--device", str(dev)]))
    print(f"strip_checkpoint {best[0]}: keys {keys}; cli.evaluate of it: "
          f"mAP {again['mAP']:.6f} (the gate's {result['mAP']:.6f}), nms "
          f"launches {evals[-1][1]}")
    check(again["mAP"] == result["mAP"] and evals[-1][1:] == (batches, 0),
          "cli.evaluate of the stripped checkpoint differs from the gate's")
    check(rc == 0 and summary["passed"] and result["mAP"] >= 0.95,
          f"overfit gate: rc {rc}, mAP {result['mAP']}")
    return result["mAP"]


def device_data_phase(dev: torch.device, card: str, anchors: np.ndarray,
                      variables: dict, host_steps: dict, tmp: Path
                      ) -> Tuple[Path, float]:
    """Phase 13: the device data path, the reduced overfit gate and the
    checkpoint CLIs (see the module docstring), in the directory `tmp`.
    Returns the gate's directory (its data and checkpoints) and its
    mAP."""
    from yolov3_tensorflow_tpu_torch.data.synthetic import generate_dataset
    train = generate_dataset(str(tmp / "train"), TRAIN_IMAGES, seed=0,
                             img_size=(SIZE, SIZE), prefix="train")
    data_path_check(dev, card, train["annotation_file"], anchors)
    device_timings(dev, card, train["annotation_file"], anchors, host_steps)
    convert_check(dev, variables, tmp)
    gate_map = gate_check(dev, card, tmp)
    return tmp / "gate", gate_map


def int8_gemm_check(dev: torch.device, qp: dict, qc: dict) -> None:
    """Phase 14, part 1: the int8 GEMM route (im2col + torch._int_mm)
    against the float64 reference, bit for bit, at batch 8 on seeded int8
    inputs, with the quantized weights of conv_0 (K = 27 padded to 32), the
    stride-2 conv_1, the 1x1 conv_2, head conv_1 (3x3 at 13^2) and both
    halves of the chained head conv_8."""
    from yolov3_tensorflow_tpu_torch.ops import int8_conv as I8
    gen = torch.Generator(device=dev).manual_seed(14)
    s = SIZE

    def int8(shape):
        n, c, h, w = shape
        return torch.randint(-127, 128, (n, h, w, c), generator=gen,
                             device=dev, dtype=torch.int8).permute(0, 3, 1, 2)

    conv8 = qc["head"]["conv_8"]
    cases = [("backbone/conv_0", qp["backbone"]["conv_0"], 1, (8, 3, s, s)),
             ("backbone/conv_1 (stride 2)", qp["backbone"]["conv_1"], 2,
              (8, 32, s, s)),
             ("backbone/conv_2 (1x1)", qp["backbone"]["conv_2"], 1,
              (8, 64, s // 2, s // 2)),
             ("head/conv_1 (3x3 at 13^2)", qp["head"]["conv_1"], 1,
              (8, 512, s // 32, s // 32))]
    for name, entry, stride, shape in cases:
        x8 = int8(shape)
        got = I8.conv_int8(x8, entry["wt"], entry["w8"].shape[1], stride)
        want = I8.conv_int8_reference(x8, entry["w8"], stride)
        torch.cuda.synchronize()
        print(f"int8 GEMM {name}: x {tuple(shape)}, wt "
              f"{tuple(entry['wt'].shape)} -> {tuple(got.shape)} int32; "
              f"equal to the float64 reference: {torch.equal(got, want)}")
        check(torch.equal(got, want), f"int8 GEMM {name} differs from the "
                                      f"float64 reference")
    ca = 256
    for half, x8, wt, w8 in (
            ("a (upsampled lateral)", int8((8, ca, s // 16, s // 16)),
             conv8["wt"][:, :ca].contiguous(), conv8["w8"][..., :ca]),
            ("b (route_2)", int8((8, 512, s // 16, s // 16)),
             conv8["wt"][:, ca:].contiguous(), conv8["w8"][..., ca:])):
        got = I8.conv_int8(x8, wt, 1, 1)
        want = I8.conv_int8_reference(x8, w8, 1)
        torch.cuda.synchronize()
        print(f"int8 GEMM chained head/conv_8, half {half}: "
              f"{tuple(got.shape)} int32; equal to the float64 reference: "
              f"{torch.equal(got, want)}")
        check(torch.equal(got, want), f"int8 GEMM head/conv_8 half {half} "
                                      f"differs from the float64 reference")


def int8_detectors(dev: torch.device, variables: dict, anchors: np.ndarray,
                   calib: torch.Tensor) -> dict:
    """Phase 14, part 2: every quantized detector of the slice, built from
    the entry points on `calib`, with its int8 GEMMs per request: name ->
    (detector, GEMMs)."""
    from yolov3_tensorflow_tpu_torch.ops.postprocess import (
        build_auto_detector, build_detector)
    from yolov3_tensorflow_tpu_torch.ops.quantize import build_detector_int8
    kw = dict(device=dev, **SERVING)
    dets = {}
    for mode, gemms in (("packed", 72), ("prefilter", 72), ("chained", 74)):
        dets[f"int8 {mode}"] = (build_detector_int8(
            variables, anchors, C, (SIZE, SIZE), calibration_images=calib,
            mode=mode, **kw)[0], gemms)
    for upto in (12, 9):
        dets[f"stem8 upto {upto}"] = (build_detector(
            variables, anchors, C, (SIZE, SIZE), mode="stem8",
            calibration_images=calib, stem_int8_upto=upto, **kw), upto)
    # on CUDA every budget serves bf16 packed (the H100 mode table, phase 15)
    for quantize, gemms in (("none", 0), ("hybrid", 0), ("full", 0)):
        dets[f"auto {quantize}"] = (build_auto_detector(
            variables, anchors, C, (SIZE, SIZE), quantize=quantize,
            calibration_images=calib, **kw), gemms)
    return dets


def int8_candidates(det, images: torch.Tensor):
    """The shared-candidate kernel's inputs of one request of `det` (a
    QuantizedDetector, or the bf16 PackedDetector of auto under none)."""
    from yolov3_tensorflow_tpu_torch.ops.fast_postprocess import (
        packed_candidates, prefilter_candidates, yolov3_forward_packed)
    with torch.inference_mode():
        if hasattr(det, "forward_fn"):
            outs = det.forward_fn(det.params, images)
        else:
            outs = yolov3_forward_packed(det.packed, images,
                                         compute_dtype=torch.bfloat16)
        pick = prefilter_candidates if getattr(det, "post", "") == \
            "prefilter" else packed_candidates
        return pick(outs, C, det.tables, det.box_topk)


def int8_requests(dets: dict, batches: dict, max_err: dict) -> None:
    """Phase 14, part 3: each detector answers a request at batch 8 and one
    at batch 128, with the kernel counts and the int8 GEMM count set to 0
    just before each and read just after: finite outputs of the right
    shape, a detection in every image, one shared-candidate launch and the
    detector's int8 GEMMs per request; then the kernel against its plain
    version on the last request's own candidates."""
    from yolov3_tensorflow_tpu_torch.ops import int8_conv as I8
    from yolov3_tensorflow_tpu_torch.ops import nms_cuda
    st, it = SERVING["score_thresh"], SERVING["iou_thresh"]
    for name, (det, gemms) in dets.items():
        for b in INT8_BATCHES:
            torch.cuda.synchronize()
            nms_cuda.nms_keep_mask_shared.launches = 0
            nms_cuda.nms_keep_mask.launches = 0
            I8.int8_gemm.calls = 0
            out = det(batches[b])
            torch.cuda.synchronize()
            k1, k2 = (nms_cuda.nms_keep_mask_shared.launches,
                      nms_cuda.nms_keep_mask.launches)
            calls = I8.int8_gemm.calls
            check_requests([out], [b], SERVING["max_out"], name)
            print(f"{name} request batch {b}: nms_shared launches {k1}, nms "
                  f"launches {k2}, int8 GEMMs (torch._int_mm) {calls}")
            check((k1, k2) == (1, 0), f"{name}: launches (nms_shared, nms) "
                                      f"{(k1, k2)} per request, want (1, 0)")
            check(calls == gemms, f"{name}: {calls} int8 GEMMs per request, "
                                  f"want {gemms}")
        boxes, scores = int8_candidates(det, batches[INT8_BATCHES[-1]])
        keep = nms_cuda.nms_keep_mask_shared(boxes, scores, st, it)
        want = nms_cuda.nms_keep_mask_shared_reference(boxes, scores, st, it)
        torch.cuda.synchronize()
        err = float((keep.float() - want.float()).abs().max())
        max_err["nms_shared"] = max(max_err["nms_shared"], err)
        print(f"{name} candidates B={boxes.shape[0]} K={boxes.shape[1]}: "
              f"kept {int(want.sum())} of {int((scores >= st).sum())} valid; "
              f"kernel == plain: {err == 0.0}")
        check(err == 0.0, f"{name}: kernel and plain keep masks differ")


def stem_handoff(hp: dict, images: torch.Tensor) -> torch.Tensor:
    """The stem8 forward's int8 region alone: conv_{upto-1}'s bf16 output,
    which the forward hands to its first bf16 conv (caught there)."""
    from yolov3_tensorflow_tpu_torch.ops import quantize

    class Handoff(Exception):
        pass

    def first_bf16_conv(x, *args, **kw):
        raise Handoff(x)

    folded_conv = quantize.conv_folded
    quantize.conv_folded = first_bf16_conv
    try:
        with torch.inference_mode():
            quantize.yolov3_forward_stem_int8_packed(hp, images)
    except Handoff as h:
        return h.args[0]
    finally:
        quantize.conv_folded = folded_conv
    raise AssertionError("the stem8 forward never reached a bf16 conv")


def int8_gpu_vs_cpu(dev: torch.device, variables: dict, anchors: np.ndarray,
                    calib: torch.Tensor, images: torch.Tensor) -> None:
    """Phase 14, part 4: the int8 detectors (packed, prefilter, chained) on
    the GPU and on the CPU (plain NMS) on 2 images: same label, IoU >= 0.9,
    for every detection scored at least 0.02 above the threshold. stem8
    (upto 12): its int8 region's output (conv_11's bf16 handoff) bit-equal
    on both devices; its detections, whose 63 later convs run in bf16
    (cuDNN's sums against the CPU's, as the bf16 packed detector, which
    phase 4 compares in fp32), are counted and printed. Both devices
    quantize with the GPU's activation scales (the calibration is a bf16
    forward, which the devices sum differently)."""
    from yolov3_tensorflow_tpu_torch.ops import postprocess, quantize
    from yolov3_tensorflow_tpu_torch.testing import match_detections
    cpu = torch.device("cpu")
    scales = quantize.calibrate_activation_scales(variables, calib)
    host_vars = to_device(variables, cpu)
    original = quantize.calibrate_activation_scales
    try:
        for module in (quantize, postprocess):
            module.calibrate_activation_scales = lambda *a, **k: scales
        for mode in ("packed", "prefilter", "chained", "stem8"):
            pair, handoff = [], []
            for d, v in ((dev, variables), (cpu, host_vars)):
                if mode == "stem8":
                    det = postprocess.build_detector(
                        v, anchors, C, (SIZE, SIZE), device=d, mode="stem8",
                        calibration_images=calib, **SERVING)
                    handoff.append(stem_handoff(det.params, images.to(d)))
                else:
                    det = quantize.build_detector_int8(
                        v, anchors, C, (SIZE, SIZE), device=d, mode=mode,
                        calibration_images=calib, **SERVING)[0]
                pair.append(detections(det(images.to(d)), 2))
            if mode != "stem8":
                same_detections(pair[1], pair[0],
                                SERVING["score_thresh"] + 0.02,
                                f"int8 {mode} GPU vs CPU")
                continue
            equal = torch.equal(handoff[0].cpu(), handoff[1])
            n1, f1 = match_detections(pair[1], pair[0],
                                      SERVING["score_thresh"] + 0.02)
            n2, f2 = match_detections(pair[0], pair[1],
                                      SERVING["score_thresh"] + 0.02)
            print(f"stem8 GPU vs CPU: the int8 region's output "
                  f"{tuple(handoff[1].shape)} bf16 bit-equal: {equal}; "
                  f"detections after the bf16 remainder {f1}/{n1} found one "
                  f"way, {f2}/{n2} the other (score >= 0.32)")
            check(equal, "stem8: the int8 region's output differs between "
                         "the GPU and the CPU")
    finally:
        quantize.calibrate_activation_scales = original
        postprocess.calibrate_activation_scales = original


def int8_accuracy(dev: torch.device, card: str, gate_dir: Path) -> None:
    """Phase 14, part 5: scripts/validate_quantized.py on the reduced
    overfit gate's checkpoint and its GATE_IMAGES images (phase 13), twice:
    calibrated on the first 8 images, as the JAX script calibrates, and on
    all of them. Both: int8, int8-chained and stem8 (upto 12) mAP through
    the exact eval path within INT8_MAP_DELTA of bf16's, packed detection
    identity at least IDENTITY_MIN, and the per-group kernel once per
    exact-eval batch (4 forwards x the batches). stem8's identity is held
    to IDENTITY_MIN when the calibration covers every evaluated image; with
    8 it is printed (the other 8 images clip at the 8-image scales and move
    boxes, PERF.md). Then the identity of the int8 packed and chained
    detectors (calibrated on all the images) against the same prefilter
    path, printed."""
    import argparse
    import math

    from yolov3_tensorflow_tpu_torch.cli.common import load_variables
    from yolov3_tensorflow_tpu_torch.config import Config
    from yolov3_tensorflow_tpu_torch.data.loader import DataLoader
    from yolov3_tensorflow_tpu_torch.ops import nms_cuda
    from yolov3_tensorflow_tpu_torch.ops.postprocess import build_detector
    from yolov3_tensorflow_tpu_torch.ops.quantize import build_detector_int8
    from yolov3_tensorflow_tpu_torch.scripts import validate_quantized
    data = gate_dir / "data"
    ckpt, names = gate_dir / "ckpt" / "overfit_final", data / "synth.names"
    for calib_images in (8, GATE_IMAGES):
        args = argparse.Namespace(
            ckpt=str(ckpt), data=str(data / "train.txt"), names=str(names),
            img_size=SIZE, stem_upto=12, calib_images=calib_images,
            device=str(dev), out="")
        torch.cuda.synchronize()
        nms_cuda.nms_keep_mask.launches = 0
        t0 = time.perf_counter()
        summary = validate_quantized.run(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k2 = nms_cuda.nms_keep_mask.launches
        batches = math.ceil(summary["images"] / 8)
        print(f"validate_quantized on the reduced gate "
              f"({summary['images']} images, {SIZE}^2, calibrated on "
              f"{calib_images}): {json.dumps(summary)}; nms launches {k2} "
              f"({batches} batches x 4 exact-eval forwards); {wall:.1f} s "
              f"wall [{card}]")
        check(k2 == 4 * batches, f"validate_quantized: {k2} nms launches, "
                                 f"want {4 * batches}")
        for key in ("mAP_int8", "mAP_int8_chained", "mAP_stem_int8"):
            check(abs(summary[key] - summary["mAP_bf16"]) <= INT8_MAP_DELTA,
                  f"validate_quantized: {key} {summary[key]} against "
                  f"bf16's {summary['mAP_bf16']}")
        held = ["packed_serving_identity"]
        if calib_images == summary["images"]:
            held.append("stem_int8_identity")
        for key in held:
            check(summary[key] >= IDENTITY_MIN,
                  f"validate_quantized (calibrated on {calib_images}): "
                  f"{key} {summary[key]}")

    cfg = Config()
    cfg.data.class_name_path = str(names)
    cfg.finalize()
    anchors = np.asarray(cfg.anchors, np.float32)
    n_cls = cfg.model.num_classes
    variables = load_variables(str(ckpt), n_cls, dev)
    loader = DataLoader(str(data / "train.txt"), n_cls, anchors, 8,
                        (SIZE, SIZE), mode="val", letterbox=True,
                        num_threads=8)
    images = [torch.from_numpy(b.images).to(dev) for b in loader.epoch(0)]
    exact = build_detector(variables, anchors, n_cls, (SIZE, SIZE),
                           device=dev, mode="prefilter", max_out=50,
                           box_topk=128, pre_topk=128, score_thresh=0.3,
                           iou_thresh=0.45)
    for mode in ("packed", "chained"):
        det = build_detector_int8(variables, anchors, n_cls, (SIZE, SIZE),
                                  calibration_images=torch.cat(images),
                                  device=dev, mode=mode, **SERVING)[0]
        total, matched, dev_max = validate_quantized.identity_vs_exact(
            exact, det, images)
        print(f"int8 {mode} against the prefilter path on the reduced gate "
              f"(calibrated on all {GATE_IMAGES}): identity "
              f"{matched / max(total, 1):.4f} ({matched} of {total} at IoU "
              f">= 0.98), max score deviation {dev_max:.5f} [{card}]")


def int8_split(card: str, det, images: torch.Tensor) -> None:
    """Phase 14, part 7: torch.profiler's split of the int8 packed forward
    (`det.forward_fn`) at `images`' batch into the integer GEMMs, the
    quantize passes, the patch builds and the rest (the epilogues, the
    bf16 detection convs, upsamples and casts): each of
    ops.int8_conv.{int8_gemm, quantize, im2col} runs inside a named
    record_function while the forward is traced
    (utils.profiling.device_events), and its device time is that of the
    kernels inside the range's device spans."""
    import bisect
    import itertools

    from yolov3_tensorflow_tpu_torch.ops import int8_conv as I8
    from yolov3_tensorflow_tpu_torch.utils.profiling import (device_events,
                                                             union_length)
    names = {"int8_gemm": "int8/gemm", "quantize": "int8/quantize",
             "im2col": "int8/im2col"}
    originals = {n: getattr(I8, n) for n in names}

    def named(fn, label):
        @functools.wraps(fn)             # int8_gemm's count lives on it
        def wrapper(*args, **kw):
            with torch.profiler.record_function(label):
                return fn(*args, **kw)
        return wrapper

    iters = 3
    with torch.inference_mode():
        try:
            for n, label in names.items():
                setattr(I8, n, named(originals[n], label))
            device = device_events(lambda: det.forward_fn(det.params, images),
                                   iters, record_ranges=True)
        finally:
            for n, fn in originals.items():
                setattr(I8, n, fn)
    # on the device timeline each named range is an annotation spanning the
    # kernels launched inside it (one stream: nothing else runs there); a
    # range's time is the kernel time inside its spans, the rest is busy
    # time outside every span
    labels = set(names.values())
    kernels = sorted((lo, hi) for name, lo, hi in device
                     if name not in labels)
    busy = union_length(kernels) / 1e3 / iters
    starts = [k0 for k0, _ in kernels]
    reach = list(itertools.accumulate((k1 for _, k1 in kernels), max))
    parts = dict.fromkeys(sorted(labels), 0.0)
    for name, lo, hi in device:
        if name in labels:
            inside = kernels[bisect.bisect_right(reach, lo):
                             bisect.bisect_left(starts, hi)]
            parts[name] += union_length(
                [(max(k0, lo), min(k1, hi)) for k0, k1 in inside]
            ) / 1e3 / iters
    check(busy > 0 and parts["int8/gemm"] > 0,
          "the profiler saw no device time in the int8 forward")
    rest = busy - sum(parts.values())
    shares = ", ".join(f"{k} {v:.3f} ms ({v / busy:.1%})"
                       for k, v in parts.items())
    print(f"int8 packed forward at batch {images.shape[0]}, torch.profiler: "
          f"device busy {busy:.3f} ms per forward: {shares}; epilogues, "
          f"bf16 detection convs and the rest {rest:.3f} ms "
          f"({rest / busy:.1%}) [{card}]")


def int_mm_rate(dev: torch.device, card: str) -> None:
    """Phase 14, part 8: torch._int_mm's rate at a large square shape
    (both operands K-major, as the convs call it) against the data sheet's
    dense int8 peak, beside the weight row-major and torch.mm in bf16 at
    the same shape."""
    from yolov3_tensorflow_tpu_torch.utils.profiling import cuda_ms
    m = INT_MM_SIZE
    gen = torch.Generator(device=dev).manual_seed(8)
    a = torch.randint(-127, 128, (m, m), generator=gen, device=dev,
                      dtype=torch.int8)
    bt = torch.randint(-127, 128, (m, m), generator=gen, device=dev,
                       dtype=torch.int8)
    ms = cuda_ms(lambda: torch._int_mm(a, bt.t()), 20)
    b = bt.t().contiguous()
    row_ms = cuda_ms(lambda: torch._int_mm(a, b), 5)
    ah, bh = a.bfloat16(), bt.bfloat16()
    bf_ms = cuda_ms(lambda: torch.mm(ah, bh.t()), 20)
    ops = 2.0 * m ** 3
    print(f"torch._int_mm {m}x{m}x{m} int8 -> int32: {ms:.4f} ms, "
          f"{ops / ms / 1e9:.1f} TOPS, {ops / ms / 1e9 / INT8_PEAK_TOPS:.1%} "
          f"of the {INT8_PEAK_TOPS:.0f} TOPS dense int8 peak (the weight "
          f"row-major instead of K-major: {row_ms:.4f} ms, "
          f"{ops / row_ms / 1e9:.1f} TOPS); torch.mm bf16 at the same shape "
          f"{bf_ms:.4f} ms, {ops / bf_ms / 1e9:.1f} TF/s [{card}]")
    del a, b, bt, ah, bh


def int8_timings(card: str, dets: dict, packed, batches: dict) -> dict:
    """Phase 14, part 6: ms per batch (back-to-back calls, host gaps
    included) of the int8 packed, chained and stem8 (upto 12) detectors
    in turns with the bf16 packed detector (order p x y z z y x p, the two
    readings of each averaged), then each detector's device busy time,
    idle share and peak memory (the call's own above what is resident).
    Returns name -> batch -> ms."""
    from yolov3_tensorflow_tpu_torch.utils.profiling import device_busy_ms
    named = {"bf16 packed": packed}
    for name in ("int8 packed", "int8 chained", "stem8 upto 12"):
        named[name] = dets[name][0]
    order = list(named) + list(named)[::-1]
    out = {name: {} for name in named}
    for b in INT8_BATCHES:
        images = batches[b]
        iters = 20 if b == 8 else 8
        for name in named:
            for _ in range(3):
                named[name](images)
        runs = {name: [] for name in named}
        for name in order:
            runs[name].append(call_ms(lambda: named[name](images), iters))
        for name, det in named.items():
            ms = out[name][b] = sum(runs[name]) / len(runs[name])
            busy = device_busy_ms(lambda: det(images), 5)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            det(images)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            print(f"{name} detector batch {b}: {ms:.3f} ms/batch (turns "
                  f"{', '.join(f'{r:.3f}' for r in runs[name])}), "
                  f"{b * 1000.0 / ms:.1f} img/s; device busy {busy:.3f} "
                  f"ms/batch, idle share {1 - busy / ms:.3f}; peak "
                  f"memory {peak / 2**30:.2f} GiB ({(peak - base) / 2**30:.2f}"
                  f" GiB above the resident) [{card}]")
        base_ms = out["bf16 packed"][b]
        print(f"batch {b}, ms against bf16 packed's {base_ms:.3f}: "
              + ", ".join(f"{n} {out[n][b] / base_ms:.3f}x"
                          for n in named if n != "bf16 packed"))
    return out


def mode_table(dev: torch.device, card: str, variables: dict,
               anchors: np.ndarray) -> None:
    """Phase 14, part 9: packed (bf16), stem8 (upto 12) and full int8
    (packed head) img/s at the JAX package's benched sizes (MODE_TABLE),
    each detector calibrated on 8 seeded images of its size and timed by
    `call_ms`, beside the mode select_serving_mode picks under the hybrid
    and full budgets."""
    from yolov3_tensorflow_tpu_torch.ops.postprocess import (
        build_detector, select_serving_mode)
    from yolov3_tensorflow_tpu_torch.ops.quantize import build_detector_int8
    gen = torch.Generator(device=dev).manual_seed(15)
    for (h, w), b in MODE_TABLE:
        images = torch.rand((b, h, w, 3), generator=gen, device=dev)
        calib = images[:CALIB_IMAGES]
        rates = {}
        for mode in ("packed", "stem8", "int8"):
            if mode == "int8":
                det = build_detector_int8(variables, anchors, C, (h, w),
                                          device=dev, mode="packed",
                                          calibration_images=calib,
                                          **SERVING)[0]
            else:
                det = build_detector(variables, anchors, C, (h, w),
                                     device=dev, mode=mode,
                                     calibration_images=calib, **SERVING)
            for _ in range(2):
                det(images)
            rates[mode] = b * 1000.0 / call_ms(lambda: det(images), 5)
            del det
        best = max(rates, key=rates.get)
        print(f"mode table {h}x{w} batch {b}: "
              + ", ".join(f"{m} {r:.1f} img/s" for m, r in rates.items())
              + f"; fastest {best}; select_serving_mode on {dev} picks "
              f"{select_serving_mode((h, w), quantize='full', device=dev)} "
              f"(full), "
              f"{select_serving_mode((h, w), quantize='hybrid', device=dev)}"
              f" (hybrid) [{card}]")
        del images, calib
        torch.cuda.empty_cache()


def int8_cli(dev: torch.device, tmp: Path) -> None:
    """Phase 14, part 10: cli.detect_image at 416^2 on phase 13's .weights
    file and 480x640 jpg in --mode int8, --mode stem8 and --mode auto under
    each --quantize: rc 0, an output of the input's shape, boxes drawn,
    one shared-candidate launch per call."""
    import cv2

    from yolov3_tensorflow_tpu_torch.cli import detect_image
    image, weights = tmp / "frame.jpg", tmp / "spread_coco80.weights"
    runs = (["--mode", "int8"], ["--mode", "stem8"],
            ["--mode", "auto", "--quantize", "full"],
            ["--mode", "auto", "--quantize", "hybrid"],
            ["--mode", "auto", "--quantize", "none"])
    for extra in runs:
        out = tmp / "out_int8.jpg"
        rc, _, boxes, k1, k2, wall = run_cli(
            detect_image.main, [str(image), "--restore_path", str(weights),
                                "--device", str(dev), "--new_size",
                                str(SIZE), str(SIZE), "--output", str(out),
                                *extra], detect_image)
        what = " ".join(extra)
        print(f"detect_image {what} ({SIZE}^2, calibrated on the input): rc "
              f"{rc}, {len(boxes)} boxes drawn, nms_shared launches {k1}, "
              f"nms launches {k2}, {wall:.2f} s wall (weights load, "
              f"calibration and first call included)")
        got = cv2.imread(str(out))
        check(rc == 0 and got is not None and got.shape == CLI_SRC_HW + (3,),
              f"detect_image {what}: rc {rc}")
        check(len(boxes) > 0, f"detect_image {what}: no detections")
        check((k1, k2) == (1, 0), f"detect_image {what}: launches "
                                  f"(nms_shared, nms) {(k1, k2)}")


def int8_phase(dev: torch.device, card: str, variables: dict,
               anchors: np.ndarray, tmp: Path, gate_dir: Path,
               max_err: dict) -> None:
    """Phase 14: int8 serving (see the module docstring)."""
    from yolov3_tensorflow_tpu_torch.ops.postprocess import build_detector
    gen = torch.Generator(device=dev).manual_seed(14)
    calib = torch.rand((CALIB_IMAGES, SIZE, SIZE, 3), generator=gen,
                       device=dev)
    batches = {b: torch.rand((b, SIZE, SIZE, 3), generator=gen, device=dev)
               for b in INT8_BATCHES}
    t0 = time.perf_counter()
    dets = int8_detectors(dev, variables, anchors, calib)
    print(f"int8 detectors: {len(dets)} built in "
          f"{time.perf_counter() - t0:.1f} s (each calibrates on "
          f"{CALIB_IMAGES} seeded images and quantizes)")
    qp = dets["int8 packed"][0].params
    qc = dets["int8 chained"][0].params
    int8_gemm_check(dev, qp, qc)
    int8_requests(dets, batches, max_err)
    int8_gpu_vs_cpu(dev, variables, anchors, calib, batches[8][:2])
    int8_accuracy(dev, card, gate_dir)
    packed = build_detector(variables, anchors, C, (SIZE, SIZE), device=dev,
                            mode="packed", **SERVING)
    int8_timings(card, dets, packed, batches)
    int8_split(card, dets["int8 packed"][0], batches[INT8_BATCHES[-1]])
    del dets, packed
    torch.cuda.empty_cache()
    int_mm_rate(dev, card)
    mode_table(dev, card, variables, anchors)
    int8_cli(dev, tmp)


def policy_phase(dev: torch.device, card: str, tmp: Path) -> None:
    """Phase 15: the serving policy on CUDA. select_serving_mode on the card
    follows the H100's measured table: packed under every budget at the
    mode table's sizes (no int8 mode beat bf16 there, phase 14), and
    cli.detect_image --mode int8 at 416^2 on phase 13's .weights file and
    jpg warns that full int8 is slower here, naming that table."""
    import contextlib
    import io

    from yolov3_tensorflow_tpu_torch.cli import detect_image
    from yolov3_tensorflow_tpu_torch.ops.postprocess import (
        SERVING_TABLES, select_serving_mode)
    for (h, w), _ in MODE_TABLE:
        picks = {q: select_serving_mode((h, w), quantize=q, device=dev)
                 for q in ("none", "hybrid", "full")}
        print(f"serving policy on {dev} at {h}x{w}: {picks}")
        check(set(picks.values()) == {"packed"},
              f"serving policy on CUDA at {h}x{w}: {picks}")
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc, _, boxes, k1, _, _ = run_cli(
            detect_image.main,
            [str(tmp / "frame.jpg"), "--restore_path",
             str(tmp / "spread_coco80.weights"), "--device", str(dev),
             "--new_size", str(SIZE), str(SIZE), "--output",
             str(tmp / "out_policy.jpg"), "--mode", "int8"], detect_image)
    warning = [line for line in err.getvalue().splitlines()
               if "SLOWER" in line]
    print(f"detect_image --mode int8 at {SIZE}^2: rc {rc}, {len(boxes)} "
          f"boxes, nms_shared launches {k1}; warning: {warning}")
    check(rc == 0 and k1 == 1, f"detect_image --mode int8: rc {rc}, "
                               f"nms_shared launches {k1}")
    check(len(warning) == 1 and SERVING_TABLES["cuda"] in warning[0],
          f"detect_image --mode int8 at {SIZE}^2 gave no warning naming "
          f"the H100 table: {err.getvalue()!r}")


def dp_batch(b: int, seed: int, anchors: np.ndarray):
    """b seeded 416^2 images and their label grids (4 boxes each, labels
    0..2 under the COCO-80 head), CPU tensors."""
    from yolov3_tensorflow_tpu_torch.data.encoder import encode_labels
    rng = np.random.default_rng(seed)
    images = rng.uniform(0, 1, (b, SIZE, SIZE, 3)).astype(np.float32)
    grids = []
    for _ in range(b):
        xy = rng.uniform(0, 0.6 * SIZE, (4, 2))
        boxes = np.concatenate([xy, xy + rng.uniform(0.04 * SIZE,
                                                     0.3 * SIZE, (4, 2))], 1)
        grids.append(encode_labels(boxes.astype(np.float32),
                                   rng.integers(0, 3, 4), (SIZE, SIZE), C,
                                   anchors))
    return (torch.from_numpy(images),
            [torch.from_numpy(np.stack([g[s] for g in grids]))
             for s in range(3)])


def run_digest(state: dict, metrics: list) -> str:
    """tree_digest of a train run's params, statistics, optimizer slots
    and every step's metrics (the learning rate as a tensor)."""
    from yolov3_tensorflow_tpu_torch.testing import tree_digest
    steps = {f"{i}": {k: torch.as_tensor(v) for k, v in m.items()}
             for i, m in enumerate(metrics)}
    slots = {k: v for k, v in state["opt_state"].items() if k != "count"}
    return tree_digest(state["params"], state["batch_stats"], slots, steps)


def dp_world1(dev: torch.device, card: str, tmp: Path,
              anchors: np.ndarray, max_err: dict) -> None:
    """Phase 16, part 1: data parallelism at world size 1 over NCCL in this
    process. make_dp_train_step against make_train_step for DP_STEPS steps
    at batch 8 in bf16 and in fp32 (momentum, seed-0 init, deterministic
    algorithms): params, BN statistics, optimizer slots and every step's
    metrics bit-equal (the plain step run twice shows it is itself
    repeatable); make_dp_eval_forward against the eval step's detections,
    bit-equal, with one per-group kernel launch, and that kernel bit-equal
    to its plain version on the eval's candidates. Then the bf16 step at
    batch 8, plain and DP in turns: the collectives' cost."""
    import torch.distributed as dist

    from yolov3_tensorflow_tpu_torch.models.decode import predict_boxes
    from yolov3_tensorflow_tpu_torch.ops import nms_cuda
    from yolov3_tensorflow_tpu_torch.ops.nms import select_per_class
    from yolov3_tensorflow_tpu_torch.parallel.data_parallel import (
        make_dp_eval_forward, make_dp_train_step)
    from yolov3_tensorflow_tpu_torch.parallel.mesh import make_data_mesh
    from yolov3_tensorflow_tpu_torch.parallel.multihost import \
        initialize_distributed
    from yolov3_tensorflow_tpu_torch.train.optimizers import flatten
    from yolov3_tensorflow_tpu_torch.train.schedules import build_schedule
    from yolov3_tensorflow_tpu_torch.train.trainer import (make_eval_forward,
                                                           make_eval_step)
    got = initialize_distributed(f"file://{tmp / 'nccl_rendezvous'}", 1, 0,
                                 device=torch.device(dev.type))
    try:
        check(dist.get_backend() == "nccl" and got == dev,
              f"world size 1: backend {dist.get_backend()} on {got}")
        mesh = make_data_mesh(1)
        cpu_images, cpu_y = dp_batch(DP_BATCH, 16, anchors)
        images = cpu_images.to(dev)
        y_true = tuple(y.to(dev) for y in cpu_y)
        torch.use_deterministic_algorithms(True, warn_only=True)
        torch.backends.cudnn.deterministic = True
        try:
            for dtype in ("bfloat16", "float32"):
                cfg = train_config(dtype, "momentum")
                plain, opt = train_step_fn(cfg)
                dp = make_dp_train_step(cfg, opt, mesh,
                                        schedule=build_schedule(cfg))
                digests = {}
                for name, fn in (("plain", plain), ("dp", dp),
                                 ("plain again", plain)):
                    state, metrics = fresh_state(opt, dev), []
                    for _ in range(DP_STEPS):
                        state, m = fn(state, images, y_true)
                        metrics.append(m)
                    torch.cuda.synchronize()
                    digests[name] = run_digest(state, metrics)
                print(f"DP world size 1 (NCCL) {dtype}, {DP_STEPS} momentum "
                      f"steps at batch {DP_BATCH}, {SIZE}^2: DP == plain "
                      f"{digests['dp'] == digests['plain']}, plain repeats "
                      f"{digests['plain again'] == digests['plain']}; last "
                      f"total loss {float(metrics[-1]['total']):.4f}")
                check(digests["dp"] == digests["plain"],
                      f"DP at world size 1 ({dtype}) differs from the plain "
                      f"step (the plain step repeats: "
                      f"{digests['plain again'] == digests['plain']})")
            _, want = make_eval_step(cfg)(state, images, y_true)
            torch.cuda.synchronize()
            nms_cuda.nms_keep_mask.launches = 0
            dets = make_dp_eval_forward(cfg, mesh)(state, images)
            torch.cuda.synchronize()
            k2 = nms_cuda.nms_keep_mask.launches
            same = all(torch.equal(dets[k], want[k]) for k in want)
            print(f"make_dp_eval_forward (fp32, eval config, batch "
                  f"{DP_BATCH}): detections == eval step's {same}, "
                  f"{int(dets['valid'].sum())} valid; nms launches {k2}")
            check(same and k2 == 1, f"make_dp_eval_forward: equal {same}, "
                                    f"nms launches {k2}")
            with torch.no_grad():
                fmaps, _ = make_eval_forward(cfg)(state, images)
                boxes, confs, probs = predict_boxes(fmaps, anchors, C,
                                                    (SIZE, SIZE))
                _, top_boxes, valid = select_per_class(
                    boxes, confs * probs, cfg.eval.pre_nms_topk,
                    cfg.eval.score_threshold)
            b, _, k = valid.shape
            max_err["nms"] = max(max_err["nms"], keep_mask_error(
                top_boxes.reshape(b * C, k, 4), valid.reshape(b * C, k),
                cfg.eval.nms_threshold, "DP eval candidates"))
        finally:
            torch.use_deterministic_algorithms(False)
            torch.backends.cudnn.deterministic = False

        cfg = train_config("bfloat16", "momentum")
        plain, opt = train_step_fn(cfg)
        dp = make_dp_train_step(cfg, opt, mesh, schedule=build_schedule(cfg))
        state = fresh_state(opt, dev)
        steps = {"plain": lambda: plain(state, images, y_true),
                 "dp": lambda: dp(state, images, y_true)}
        for fn in steps.values():
            for _ in range(2):
                fn()
        ms = {"plain": [], "dp": []}
        for name in ("plain", "dp", "dp", "plain"):
            ms[name].append(call_ms(steps[name], 5))
        p_ms, d_ms = (sum(ms[n]) / 2 for n in ("plain", "dp"))
        print(f"bf16 train step batch {DP_BATCH} at {SIZE}^2, in turns: "
              f"plain {p_ms:.3f} ms (runs {ms['plain'][0]:.3f}, "
              f"{ms['plain'][1]:.3f}), DP at world size 1 over NCCL "
              f"{d_ms:.3f} ms (runs {ms['dp'][0]:.3f}, {ms['dp'][1]:.3f}): "
              f"the collectives (72 batch-norm all-reduces forward and "
              f"backward, one gradient and one metric all-reduce) "
              f"{d_ms - p_ms:+.3f} ms a step [{card}]")
        # the collectives alone: a batch-norm sized one and the gradient's
        small = torch.zeros((2, 512), device=dev)
        flat = torch.zeros(sum(t.numel() for t in
                               flatten(state["params"]).values()),
                           device=dev)
        for t in (small, flat):
            dist.all_reduce(t)
        small_ms = call_ms(lambda: dist.all_reduce(small), 146)
        t0 = time.perf_counter()
        for _ in range(146):
            dist.all_reduce(small)
        host_ms = (time.perf_counter() - t0) * 1e3 / 146
        torch.cuda.synchronize()
        flat_ms = call_ms(lambda: dist.all_reduce(flat), 5)
        print(f"NCCL at world size 1: an all-reduce of [2, 512] fp32 takes "
              f"{small_ms:.4f} ms back to back ({host_ms:.4f} ms of host "
              f"time to enqueue), 146 of them {146 * small_ms:.3f} ms; the "
              f"gradient's {flat.numel()} fp32 {flat_ms:.3f} ms [{card}]")
        del flat
    finally:
        dist.destroy_process_group()


def dp_rank(rank: int, world: int, directory: str) -> None:
    """Phase 16, part 2: one rank of the two-rank run on the one card over
    gloo (a spawned process; see dp_two_ranks). Writes rank{rank}.pt."""
    import torch.distributed as dist

    from yolov3_tensorflow_tpu_torch.ops import nms_cuda
    from yolov3_tensorflow_tpu_torch.ops.postprocess import build_detector
    from yolov3_tensorflow_tpu_torch.parallel.data_parallel import \
        make_dp_train_step
    from yolov3_tensorflow_tpu_torch.parallel.mesh import (make_data_mesh,
                                                           replicate,
                                                           shard_batch)
    from yolov3_tensorflow_tpu_torch.parallel.multihost import \
        initialize_distributed
    from yolov3_tensorflow_tpu_torch.parallel.serving import \
        make_sharded_detector
    from yolov3_tensorflow_tpu_torch.testing import tree_digest
    from yolov3_tensorflow_tpu_torch.train.optimizers import build_optimizer
    from yolov3_tensorflow_tpu_torch.train.schedules import build_schedule
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    d = Path(directory)
    inp = torch.load(d / "inputs.pt", weights_only=True)
    dev = initialize_distributed(f"file://{d / 'rendezvous'}", world, rank,
                                 device=torch.device(inp["device"]))
    cpu = torch.device("cpu")
    out = {"device": str(dev), "backend": dist.get_backend()}
    try:
        mesh = make_data_mesh(world)
        cfg = train_config("float32", "momentum")
        sched = build_schedule(cfg)
        opt = build_optimizer(cfg.train.optimizer, sched)
        step = make_dp_train_step(cfg, opt, mesh, schedule=sched)
        v = to_device(inp["train_variables"], dev)

        def args(order):
            state = replicate(mesh, {"params": v["params"],
                                     "batch_stats": v["batch_stats"],
                                     "opt_state": opt.init(v["params"]),
                                     "step": 0})
            return (state, shard_batch(mesh, inp["images"][order]).to(dev),
                    tuple(shard_batch(mesh, y[order]).to(dev)
                          for y in inp["y_true"]))

        for name, order in inp["orders"].items():
            new, metrics = step(*args(torch.as_tensor(order)))
            torch.cuda.synchronize()
            out[name] = {"digest": tree_digest(new["params"],
                                               new["batch_stats"])}
            if rank == 0:
                out[name].update(
                    params=to_device(new["params"], cpu),
                    batch_stats=to_device(new["batch_stats"], cpu),
                    metrics={k: m.cpu() for k, m in metrics.items()
                             if k != "lr"})
        a = args(torch.as_tensor(inp["orders"]["batch"]))
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(DP2_TIMED):
            step(*a)
        torch.cuda.synchronize()
        out["step_ms"] = (time.perf_counter() - t0) * 1e3 / DP2_TIMED
        del a, new, v
        torch.cuda.empty_cache()

        spread = to_device(inp["serve_variables"], dev)
        anchors = inp["anchors"].numpy()
        images = inp["serve_images"].to(dev)
        calib = inp["calib"].to(dev)
        rows = shard_batch(mesh, images)
        per = rows.shape[0]
        for mode in ("packed", "stem8"):
            det = make_sharded_detector(spread, anchors, C,
                                        (SIZE, SIZE), mesh, device=dev,
                                        mode=mode, calibration_images=calib,
                                        **SERVING)
            torch.cuda.synchronize()
            nms_cuda.nms_keep_mask_shared.launches = 0
            whole = det(images)
            torch.cuda.synchronize()
            k1 = nms_cuda.nms_keep_mask_shared.launches
            alone = build_detector(
                spread, anchors, C, (SIZE, SIZE), device=dev,
                mode=mode, calibration_images=calib if mode == "stem8"
                else None, **SERVING)
            mine = alone(rows)
            equal = all(torch.equal(whole[k][rank * per:(rank + 1) * per],
                                    mine[k]) for k in whole)
            boxes, scores = int8_candidates(alone, rows)
            st, it = SERVING["score_thresh"], SERVING["iou_thresh"]
            keep = nms_cuda.nms_keep_mask_shared(boxes, scores, st, it)
            plain = nms_cuda.nms_keep_mask_shared_reference(boxes, scores,
                                                            st, it)
            out[mode] = {
                "whole": {k: t.cpu() for k, t in whole.items()},
                "k1": k1, "slice_equal": equal,
                "k1_err": float((keep.float() - plain.float()).abs().max())}
            del det, alone
    finally:
        dist.destroy_process_group()
    torch.save(out, d / f"rank{rank}.pt")


def dp_two_ranks(dev: torch.device, card: str, tmp: Path,
                 anchors: np.ndarray, variables: dict, max_err: dict) -> None:
    """Phase 16, part 2: two ranks on the one card over gloo (NCCL refuses
    two ranks on one GPU), spawned processes. This process first computes
    the references on the card: the fp32 train step on the DP2_BATCH
    images and on them reversed (the GPU's own reordering noise), and the
    packed and stem8 detectors on the whole SHARD_BATCH batch. The ranks
    then run one DP step at global batch DP2_BATCH (fp32, momentum, seed-0
    init), and again with the batch re-partitioned over the ranks; then
    make_sharded_detector in packed and stem8 (stem8 calibrated on rank 0
    and broadcast) on the whole batch, SHARD_BATCH / 2 rows a rank. Checks:
    the DP step against the single-device step as
    tests/test_torch_train_model.py holds a step (loss terms and BN
    statistics within 1e-4 of their largest, detection-conv updates within
    1e-4, every leaf's and all updates in norm) or within twice the GPU's
    own noise (the larger of the reversed single-device step's and the
    re-partitioned DP step's), whichever is larger; both ranks' new
    parameters and statistics bit-equal; each rank's rows of the gathered
    detections bit-equal to build_detector on them, the gathered batch the
    same on both ranks, one shared-candidate launch a rank a request, that
    kernel bit-equal to its plain version on each rank's candidates, and
    at least 99% of the whole batch's detections found in the gathered
    ones both ways (same label, IoU >= 0.9; the counts printed). The
    two-rank step's time is a same-card functional run, not a scaling
    number."""
    import multiprocessing

    from yolov3_tensorflow_tpu_torch.models.yolov3 import (DETECTION_CONVS,
                                                           init_yolov3)
    from yolov3_tensorflow_tpu_torch.ops.postprocess import build_detector
    from yolov3_tensorflow_tpu_torch.testing import match_detections
    from yolov3_tensorflow_tpu_torch.train.optimizers import flatten
    cpu = torch.device("cpu")
    d = tmp / "dp2"
    d.mkdir()
    images, y_true = dp_batch(DP2_BATCH, 17, anchors)
    n = DP2_BATCH
    orders = {"batch": list(range(n)),
              # rows {0, 2, ...} on rank 0, {1, 3, ...} on rank 1
              "repartitioned": list(range(0, n, 2)) + list(range(1, n, 2))}
    train_vars = init_yolov3(torch.Generator().manual_seed(0), C, device=cpu)
    gen = torch.Generator().manual_seed(18)
    serve = torch.rand((SHARD_BATCH, SIZE, SIZE, 3), generator=gen)
    calib = torch.rand((CALIB_IMAGES, SIZE, SIZE, 3), generator=gen)

    # the references on the card, in this process
    step, opt = train_step_fn(train_config("float32", "momentum"))
    single = {}
    for name, order in (("batch", torch.arange(n)),
                        ("reversed", torch.arange(n).flip(0))):
        new, metrics = step(fresh_state(opt, dev), images[order].to(dev),
                            tuple(y[order].to(dev) for y in y_true))
        single[name] = (to_device(new["params"], cpu),
                        to_device(new["batch_stats"], cpu),
                        {k: m.cpu() for k, m in metrics.items()
                         if k != "lr"})
        del new
    whole = {}
    for mode in ("packed", "stem8"):
        det = build_detector(variables, anchors, C, (SIZE, SIZE), device=dev,
                             mode=mode, calibration_images=calib.to(dev),
                             **SERVING)
        whole[mode] = detections(det(serve.to(dev)), SHARD_BATCH)
        del det
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    torch.save({"train_variables": train_vars, "images": images,
                "y_true": y_true, "orders": orders,
                "serve_variables": to_device(variables, cpu),
                "serve_images": serve, "calib": calib,
                "anchors": torch.from_numpy(anchors), "device": dev.type},
               d / "inputs.pt")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=dp_rank, args=(r, 2, str(d)))
             for r in range(2)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=600)
    for p in procs:
        if p.is_alive():
            p.kill()
    codes = [p.exitcode for p in procs]
    print(f"two ranks on {torch.cuda.get_device_name(0)} over gloo: exit "
          f"codes {codes}, {time.perf_counter() - t0:.1f} s wall")
    check(codes == [0, 0], f"a rank of the two-rank run failed: {codes}")
    ranks = [torch.load(d / f"rank{r}.pt", weights_only=True)
             for r in range(2)]
    check([r["backend"] for r in ranks] == ["gloo", "gloo"]
          and [r["device"] for r in ranks] == [str(dev)] * 2,
          f"two ranks: {[(r['backend'], r['device']) for r in ranks]}")

    # the DP step against the single-device step
    r0 = ranks[0]
    check(all(ranks[0][k]["digest"] == ranks[1][k]["digest"]
              for k in orders), "the two ranks' parameters differ")
    before = flatten(train_vars["params"])

    def updates(params):
        return {p: t.double() - before[p].double()
                for p, t in flatten(params).items()}
    u_dp, u_part = (updates(r0[k]["params"]) for k in orders)
    u_one, u_rev = (updates(single[k][0]) for k in ("batch", "reversed"))
    leaf_noise = max(max(fro(u_rev[p], u_one[p]) for p in before),
                     max(fro(u_part[p], u_dp[p]) for p in before))

    def whole_of(u):
        return torch.cat([u[p].reshape(-1) for p in before])
    all_noise = max(fro(whole_of(u_rev), whole_of(u_one)),
                    fro(whole_of(u_part), whole_of(u_dp)))
    stats_noise = max(rel_err(single["reversed"][1][s][n][k],
                              single["batch"][1][s][n][k])
                      for s in single["batch"][1]
                      for n in single["batch"][1][s] for k in ("mean", "var"))

    def within(err, tol, noise, what):
        check(err <= max(tol, 2 * noise), f"two-rank DP step: {what} "
              f"{err:.3g} against the single-device step, over {tol} and "
              f"twice the GPU's noise {noise:.3g}")

    for k in ("total", "xy", "wh", "conf", "class", "l2"):
        within(rel_err(r0["batch"]["metrics"][k], single["batch"][2][k]),
               1e-4, rel_err(single["reversed"][2][k],
                             single["batch"][2][k]), f"loss {k}")
    stats_err = 0.0
    for s, tree in single["batch"][1].items():
        for n_, st in tree.items():
            for k in ("mean", "var"):
                err = rel_err(r0["batch"]["batch_stats"][s][n_][k], st[k])
                stats_err = max(stats_err, err)
                within(err, 1e-4, stats_noise, f"BN statistics {s}/{n_}")
    det_err = max(rel_err(u_dp[f"head/{n_}/{k}"], u_one[f"head/{n_}/{k}"])
                  for n_ in DETECTION_CONVS for k in ("w", "b"))
    within(det_err, 1e-4, leaf_noise, "detection-conv updates")
    leaf_err = max(fro(u_dp[p], u_one[p]) for p in before)
    within(leaf_err, 1e-4, leaf_noise, "the worst leaf's update (norm)")
    all_err = fro(whole_of(u_dp), whole_of(u_one))
    within(all_err, 1e-4, all_noise, "all updates (norm)")
    print(f"two-rank DP step (gloo, fp32, momentum, global batch {n}, "
          f"{SIZE}^2) against the single-device step: loss total "
          f"{float(r0['batch']['metrics']['total']):.6f} / "
          f"{float(single['batch'][2]['total']):.6f}, BN statistics worst "
          f"{stats_err:.3g} (noise {stats_noise:.3g}), detection convs "
          f"{det_err:.3g}, worst leaf {leaf_err:.3g} and all updates "
          f"{all_err:.3g} in norm (GPU noise {leaf_noise:.3g} / "
          f"{all_noise:.3g}); the ranks' parameters bit-equal; "
          f"{r0['step_ms']:.3f} / {ranks[1]['step_ms']:.3f} ms a step on "
          f"ranks 0 / 1 (a same-card functional run: two ranks share one "
          f"GPU, gloo stages the collectives, not a scaling number) [{card}]")

    for mode in ("packed", "stem8"):
        got = [r[mode] for r in ranks]
        same = all(torch.equal(got[0]["whole"][k], got[1]["whole"][k])
                   for k in got[0]["whole"])
        for r in got:
            max_err["nms_shared"] = max(max_err["nms_shared"], r["k1_err"])
        gathered = detections(got[0]["whole"], SHARD_BATCH)
        n1, f1 = match_detections(whole[mode], gathered, 0.0)
        n2, f2 = match_detections(gathered, whole[mode], 0.0)
        print(f"make_sharded_detector {mode}, batch {SHARD_BATCH} "
              f"({SHARD_BATCH // 2} a rank): nms_shared launches "
              f"{[r['k1'] for r in got]} a rank, each rank's rows == "
              f"build_detector's {[r['slice_equal'] for r in got]}, kernel "
              f"== plain on its candidates {[r['k1_err'] == 0 for r in got]}"
              f", gathered batch the same on both ranks {same}; against the "
              f"whole batch on one device: {f1}/{n1} found, {f2}/{n2} the "
              f"other way")
        check(same and all(r["slice_equal"] and r["k1"] == 1
                           and r["k1_err"] == 0 for r in got),
              f"make_sharded_detector {mode}: a rank's check failed")
        check(n1 > 0 and f1 >= 0.99 * n1 and f2 >= 0.99 * n2,
              f"make_sharded_detector {mode}: {f1}/{n1}, {f2}/{n2} against "
              f"the whole batch")


def dp_cli_train(dev: torch.device, card: str, tmp: Path) -> None:
    """Phase 16, part 3: cli.train --num_processes 2 (two processes on the
    one card over gloo, a file:// rendezvous) on DP_TRAIN_IMAGES + 8
    synthetic 416^2 images: batch 8 (4 a rank), one epoch and its
    validation (batch 2: two batches a rank), the default recipe without
    multi-scale (bf16, the head trained). Each process
    reports its kernel counts: rc 0 on both, the same mAP line on both,
    one per-group launch per validation batch a rank and no
    shared-candidate launch, one best_model_ checkpoint, events from rank
    0 only."""
    import re

    from yolov3_tensorflow_tpu_torch.data.synthetic import generate_dataset
    d = tmp / "dp_cli"
    train = generate_dataset(str(d / "train"), DP_TRAIN_IMAGES, seed=5,
                             img_size=(SIZE, SIZE), prefix="train")
    val = generate_dataset(str(d / "val"), 8, seed=6, img_size=(SIZE, SIZE),
                           prefix="val")
    launcher = ("import sys\n"
              "from yolov3_tensorflow_tpu_torch.cli import train\n"
              "from yolov3_tensorflow_tpu_torch.ops import nms_cuda\n"
              "rc = train.main(sys.argv[1:])\n"
              "print('kernel launches: nms', nms_cuda.nms_keep_mask.launches,"
              " 'nms_shared', nms_cuda.nms_keep_mask_shared.launches)\n"
              "sys.exit(rc)\n")

    def argv(pid):
        return [sys.executable, "-c", launcher, "--device", dev.type,
                "--coordinator_address", f"file://{d / 'rendezvous'}",
                "--num_processes", "2", "--process_id", str(pid),
                f"data.train_file={train['annotation_file']}",
                f"data.val_file={val['annotation_file']}",
                "data.multi_scale_train=false", "train.batch_size=8",
                "train.total_epochs=1", "train.train_evaluation_step=8",
                "train.val_evaluation_epoch=1", "train.warm_up_epoch=0",
                "train.use_warm_up=false", "train.num_data_parallel=2",
                "eval.batch_size=2",
                f"train.save_dir={d / 'ckpt'}",
                f"train.log_dir={d / f'logs_p{pid}'}",
                f"train.progress_log_path={d / f'progress_p{pid}.log'}"]

    t0 = time.perf_counter()
    procs = [subprocess.Popen(argv(pid), cwd=str(ROOT), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for pid in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            p.kill()
    wall = time.perf_counter() - t0
    rcs = [p.returncode for p in procs]
    for pid, out in enumerate(outs):
        print(f"--- cli.train rank {pid} (last lines)")
        print("\n".join(out.splitlines()[-6:]))
    check(rcs == [0, 0], f"cli.train --num_processes 2: rcs {rcs}")
    maps = [re.findall(r"EVAL: Recall.*mAP: \S+", out) for out in outs]
    launches = [re.search(r"kernel launches: nms (\d+) nms_shared (\d+)",
                          out) for out in outs]
    check(all(launches), "cli.train: a rank printed no kernel counts")
    k2 = [int(m.group(1)) for m in launches]
    k1 = [int(m.group(2)) for m in launches]
    ckpts = sorted(os.listdir(d / "ckpt"))
    logs = sorted(p.name for p in d.iterdir() if p.name.startswith("logs_"))
    print(f"cli.train --num_processes 2 ({DP_TRAIN_IMAGES} images, batch 8 "
          f"over 2 ranks on one card, gloo, 1 epoch + validation): rcs "
          f"{rcs}, {wall:.1f} s wall; mAP lines {maps}; nms launches {k2} "
          f"(2 validation batches a rank), nms_shared {k1}; checkpoints "
          f"{ckpts}; log dirs {logs} [{card}]")
    check(maps[0] and maps[0] == maps[1], f"cli.train: mAP lines {maps}")
    check(k2 == [2, 2] and k1 == [0, 0],
          f"cli.train: nms launches {k2}, nms_shared {k1}")
    check(len(ckpts) == 1 and ckpts[0].startswith("best_model_"),
          f"cli.train: checkpoints {ckpts}")
    check(logs == ["logs_p0"] and not (d / "progress_p1.log").exists(),
          f"cli.train: rank 1 wrote logs: {logs}")


def dp_phase(dev: torch.device, card: str, tmp: Path, anchors: np.ndarray,
             variables: dict, max_err: dict) -> None:
    """Phase 16: data parallelism on the card (see the module docstring)."""
    dp_world1(dev, card, tmp, anchors, max_err)
    dp_two_ranks(dev, card, tmp, anchors, variables, max_err)
    dp_cli_train(dev, card, tmp)


def split_requests(dev: torch.device, variables: dict, anchors: np.ndarray,
                   launches: dict, max_err: dict) -> dict:
    """Phase 17, part 1: build_detector(mode="split") in bf16 answers
    SPLIT_REQUESTS with one shared-candidate launch each, and the kernel
    equals its plain version on the last request's candidates. Adds the
    launches to the record's. Returns the detector and the requests."""
    from yolov3_tensorflow_tpu_torch.ops import nms_cuda
    from yolov3_tensorflow_tpu_torch.ops.fast_postprocess import (
        split_candidates, yolov3_forward_split)
    from yolov3_tensorflow_tpu_torch.ops.postprocess import build_detector

    det = build_detector(variables, anchors, C, (SIZE, SIZE), device=dev,
                         compute_dtype=torch.bfloat16, mode="split",
                         **SERVING)
    gen = torch.Generator(device=dev).manual_seed(17)
    batches = [torch.rand((b, SIZE, SIZE, 3), generator=gen, device=dev)
               for b in SPLIT_REQUESTS]
    torch.cuda.synchronize()
    nms_cuda.nms_keep_mask_shared.launches = 0
    nms_cuda.nms_keep_mask.launches = 0
    t0 = time.perf_counter()
    results = [det(images) for images in batches]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1 = nms_cuda.nms_keep_mask_shared.launches
    print(f"split: served {len(SPLIT_REQUESTS)} requests "
          f"({sum(SPLIT_REQUESTS)} images) in {wall:.3f} s wall, first calls "
          f"included; nms_shared launches {k1}, nms launches "
          f"{nms_cuda.nms_keep_mask.launches}")
    check(k1 == len(SPLIT_REQUESTS) and nms_cuda.nms_keep_mask.launches == 0,
          f"split: nms_shared launched {k1} times for "
          f"{len(SPLIT_REQUESTS)} requests")
    launches["nms_shared"] += k1
    check_requests(results, SPLIT_REQUESTS, SERVING["max_out"], "split")

    st, it = SERVING["score_thresh"], SERVING["iou_thresh"]
    with torch.inference_mode():
        outs = yolov3_forward_split(det.split, batches[-1],
                                    compute_dtype=torch.bfloat16)
        boxes, scores = split_candidates(outs, C, det.tables,
                                         SERVING["box_topk"])
        keep = nms_cuda.nms_keep_mask_shared(boxes, scores, st, it)
        want = nms_cuda.nms_keep_mask_shared_reference(boxes, scores, st, it)
        torch.cuda.synchronize()
    err = float((keep.float() - want.float()).abs().max())
    max_err["nms_shared"] = max(max_err["nms_shared"], err)
    print(f"split candidates B={boxes.shape[0]} K={boxes.shape[1]} C={C}: "
          f"kept {int(want.sum())} of {int((scores >= st).sum())} valid; "
          f"kernel == plain: {err == 0.0}")
    check(err == 0.0, "split: kernel and plain keep masks differ")
    return {"det": det, "batches": batches}


def split_identity(dev: torch.device, variables: dict, anchors: np.ndarray,
                   images: torch.Tensor) -> None:
    """Phase 17, part 2, fp32 with TF32 off: the split detector on the GPU
    against the CPU on 2 images, and against the prefilter mode (the same
    math, box_topk alike) on the images where no more than box_topk boxes
    pass, at phase 7's threshold choice."""
    from yolov3_tensorflow_tpu_torch.models.decode import predict_boxes
    from yolov3_tensorflow_tpu_torch.models.yolov3 import \
        yolov3_forward_folded
    from yolov3_tensorflow_tpu_torch.ops.postprocess import build_detector

    def build(mode, device, **kw):
        return build_detector(variables, anchors, C, (SIZE, SIZE),
                              device=device, compute_dtype=torch.float32,
                              mode=mode, **dict(SERVING, **kw))

    small = images[:2]
    same_detections(detections(build("split", torch.device("cpu"))(
                        small.cpu()), 2),
                    detections(build("split", dev)(small), 2),
                    SERVING["score_thresh"] + 0.02,
                    "split fp32 GPU vs fp32 CPU")

    pre = build("prefilter", dev)
    with torch.inference_mode():
        fmaps = yolov3_forward_folded(pre.folded, images,
                                      compute_dtype=torch.float32)
        _, confs, probs = predict_boxes(fmaps, anchors, C, (SIZE, SIZE))
        best = (confs * probs).amax(dim=-1)
    k = SERVING["box_topk"]
    thresh, fits = None, None
    for t in (0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9):
        passing = (best >= t).sum(dim=1)
        print(f"split vs prefilter: boxes passing score {t:.1f} per image "
              f"(fp32): {passing.tolist()} (box_topk {k})")
        fits = ((passing > 0) & (passing <= k)).nonzero()[:, 0]
        if len(fits):
            thresh = t
            break
    check(thresh is not None, f"split vs prefilter: no threshold leaves an "
                              f"image with 1..{k} passing boxes")
    sel = images[fits]
    same_detections(
        detections(build("split", dev, score_thresh=thresh)(sel), len(fits)),
        detections(build("prefilter", dev, score_thresh=thresh)(sel),
                   len(fits)),
        thresh, f"split vs prefilter, fp32, images {fits.tolist()} at score "
                f"{thresh:.1f}")


def s2d_check(dev: torch.device, variables: dict, anchors: np.ndarray,
              images: torch.Tensor) -> None:
    """Phase 17, part 3, fp32 with TF32 off: space_to_depth_stem's two
    convs against the original two on a batch (max |diff| <= S2D_ATOL),
    and yolov3_forward_packed with stem_s2d against without: the same
    detections (SERVING's postprocess)."""
    from yolov3_tensorflow_tpu_torch.models.layers import (conv_folded,
                                                           conv_folded_asym,
                                                           space_to_depth_2x)
    from yolov3_tensorflow_tpu_torch.models.yolov3 import (
        channels_last_weights, fold_batch_norm, space_to_depth_stem)
    from yolov3_tensorflow_tpu_torch.ops.fast_postprocess import (
        decode_tables, pack_serving_head, postprocess_packed,
        yolov3_forward_packed)

    f32 = dict(compute_dtype=torch.float32)
    packed = channels_last_weights(pack_serving_head(
        fold_batch_norm(variables, dtype=torch.float32), C))
    s2d = channels_last_weights(space_to_depth_stem(packed))
    p0, p1 = packed["backbone"]["conv_0"], packed["backbone"]["conv_1"]
    q0, q1 = s2d["backbone"]["conv_0"], s2d["backbone"]["conv_1"]
    with torch.inference_mode():
        y_ref = conv_folded(images.permute(0, 3, 1, 2), p0, **f32)
        y_got = conv_folded(space_to_depth_2x(images).permute(0, 3, 1, 2),
                            q0, **f32)
        err0 = float((space_to_depth_2x(y_ref.permute(0, 2, 3, 1))
                      - y_got.permute(0, 2, 3, 1)).abs().max())
        z_ref = conv_folded(y_ref, p1, stride=2, **f32)
        z_got = conv_folded_asym(y_got, q1, padding=((1, 0), (1, 0)), **f32)
        err1 = float((z_ref - z_got).abs().max())
        scale = float(z_ref.abs().max())
    print(f"space_to_depth_stem fp32, batch {images.shape[0]} at {SIZE}^2: "
          f"conv_0 max |diff| {err0:.3g}, conv_1 max |diff| {err1:.3g} "
          f"(|conv_1| up to {scale:.3g}; limit {S2D_ATOL})")
    check(max(err0, err1) <= S2D_ATOL, "space_to_depth_stem differs from "
                                       "the original stem")

    tables = decode_tables((SIZE, SIZE), anchors, device=dev)
    with torch.inference_mode():
        dets = [postprocess_packed(yolov3_forward_packed(
                    tree, images, stem_s2d=flag, out_dtype=torch.float32,
                    **f32), None, C, (SIZE, SIZE), tables=tables, **SERVING)
                for tree, flag in ((packed, False), (s2d, True))]
    n = images.shape[0]
    same_detections(detections(dets[0], n), detections(dets[1], n),
                    SERVING["score_thresh"] + 0.02,
                    "packed fp32 stem_s2d vs the plain stem")


def split_timings(dev: torch.device, card: str, variables: dict,
                  anchors: np.ndarray, det, batches: list) -> None:
    """Phase 17, part 4: the split detector beside the packed one in turns
    at batch 8 and 128 (ms per batch with host gaps, img/s, device busy,
    idle share); its stages at batch 128 with each detection conv's
    boxconf and cls halves beside the packed conv; the packed forward with
    and without stem_s2d in turns; conv_0 + conv_1 alone in both forms,
    the input preparation of each, and conv_1's two asymmetric-padding
    forms, each beside its bound."""
    import torch.nn.functional as F

    from yolov3_tensorflow_tpu_torch.models.layers import (conv2d,
                                                           conv_folded,
                                                           conv_folded_asym,
                                                           leaky_relu,
                                                           space_to_depth_2x)
    from yolov3_tensorflow_tpu_torch.models.yolov3 import (
        channels_last_weights, folded_body, space_to_depth_stem)
    from yolov3_tensorflow_tpu_torch.ops import nms_cuda
    from yolov3_tensorflow_tpu_torch.ops.fast_postprocess import (
        apply_packed_output_conv, apply_split_output_conv, split_candidates,
        yolov3_forward_packed, yolov3_forward_split)
    from yolov3_tensorflow_tpu_torch.ops.postprocess import build_detector
    from yolov3_tensorflow_tpu_torch.scripts.roofline import (conv_cost,
                                                              kernel_bound)
    from yolov3_tensorflow_tpu_torch.utils.profiling import (cuda_ms,
                                                             device_busy_ms)

    packed = build_detector(variables, anchors, C, (SIZE, SIZE), device=dev,
                            compute_dtype=torch.bfloat16, mode="packed",
                            **SERVING)
    for images in (batches[0], batches[-1]):
        b = images.shape[0]
        iters = 30 if b == 8 else 10
        for _ in range(2):
            packed(images), det(images)
        s_ms, p_ms, s_runs, p_runs = in_turns(
            lambda: det(images), lambda: packed(images), iters, iters,
            timer=call_ms)
        p_busy = device_busy_ms(lambda: packed(images), 5)
        s_busy = device_busy_ms(lambda: det(images), 5)
        print(f"split detector batch {b}: {s_ms:.3f} ms/batch (runs "
              f"{s_runs[0]:.3f}, {s_runs[1]:.3f}), {b * 1000.0 / s_ms:.1f} "
              f"img/s, device busy {s_busy:.3f} ms, idle share "
              f"{1 - s_busy / s_ms:.3f}; packed in turns "
              f"{p_ms:.3f} ms/batch (runs {p_runs[0]:.3f}, {p_runs[1]:.3f}), "
              f"{b * 1000.0 / p_ms:.1f} img/s, busy {p_busy:.3f} ms, idle "
              f"share {1 - p_busy / p_ms:.3f}; split / packed "
              f"{s_ms / p_ms:.4f} [{card}]")

    images = batches[-1]
    b = images.shape[0]
    bf = dict(compute_dtype=torch.bfloat16)
    with torch.inference_mode():
        fwd_ms = call_ms(lambda: yolov3_forward_split(det.split, images,
                                                      **bf), 10)
        outs = yolov3_forward_split(det.split, images, **bf)
        cand_ms = call_ms(lambda: split_candidates(
            outs, C, det.tables, SERVING["box_topk"]), 20)
        boxes, scores = split_candidates(outs, C, det.tables,
                                         SERVING["box_topk"])
        nms_ms = call_ms(lambda: nms_cuda.batched_nms_shared(
            boxes, scores, max_out=SERVING["max_out"],
            score_thresh=SERVING["score_thresh"],
            iou_thresh=SERVING["iou_thresh"]), 20)
        print(f"split stages at batch {b}: forward {fwd_ms:.3f} ms, "
              f"prefilter+decode {cand_ms:.3f} ms, batched_nms_shared "
              f"{nms_ms:.3f} ms [{card}]")
        heads = {}
        folded_body(det.split, images,
                    lambda i, x: heads.setdefault(i, x), **bf)
        for i, x in sorted(heads.items()):
            p = det.split["head"][f"conv_{i}"]
            q = packed.packed["head"][f"conv_{i}"]
            bc_ms = cuda_ms(lambda: conv2d(x, p["boxconf"]["w"]).float()
                            + p["boxconf"]["b"].view(1, -1, 1, 1), 20)
            both_ms = cuda_ms(lambda: apply_split_output_conv(p, x), 20)
            pk_ms = cuda_ms(lambda: apply_packed_output_conv(q, x), 20)
            print(f"split head conv_{i} at {x.shape[2]}^2 (cin "
                  f"{x.shape[1]}): boxconf (15 ch) {bc_ms:.4f} ms, boxconf "
                  f"+ cls (384 ch) {both_ms:.4f} ms; packed conv (384 ch) "
                  f"{pk_ms:.4f} ms [{card}]")
        del heads, outs

    tree = channels_last_weights(space_to_depth_stem(packed.packed))
    with torch.inference_mode():
        s2d_ms, plain_ms, sr, pr = in_turns(
            lambda: yolov3_forward_packed(tree, images, stem_s2d=True, **bf),
            lambda: yolov3_forward_packed(packed.packed, images, **bf),
            10, 10, timer=call_ms)
    print(f"packed forward batch {b}: plain stem {plain_ms:.3f} ms (runs "
          f"{pr[0]:.3f}, {pr[1]:.3f}), stem_s2d {s2d_ms:.3f} ms (runs "
          f"{sr[0]:.3f}, {sr[1]:.3f}); s2d / plain {s2d_ms / plain_ms:.4f} "
          f"[{card}]")

    p0, p1 = packed.packed["backbone"]["conv_0"], \
        packed.packed["backbone"]["conv_1"]
    q0, q1 = tree["backbone"]["conv_0"], tree["backbone"]["conv_1"]
    pad = ((1, 0), (1, 0))
    plain_cost = [conv_cost(SIZE, SIZE, 3, 32, 3, 1, b),
                  conv_cost(SIZE, SIZE, 32, 64, 3, 2, b)]
    s2d_cost = [conv_cost(SIZE // 2, SIZE // 2, 12, 128, 3, 1, b),
                conv_cost(SIZE // 2, SIZE // 2, 128, 64, 2, 1, b)]
    with torch.inference_mode():
        x_plain = images.to(torch.bfloat16).permute(0, 3, 1, 2)
        x_s2d = space_to_depth_2x(images, dtype=torch.bfloat16
                                  ).permute(0, 3, 1, 2)
        y_plain = conv_folded(x_plain, p0, **bf)
        y_s2d = conv_folded(x_s2d, q0, **bf)
        prep = in_turns(
            lambda: space_to_depth_2x(images, dtype=torch.bfloat16),
            lambda: images.to(torch.bfloat16), 20, 20)
        print(f"stem input at batch {b}: fp32 -> bf16 cast {prep[1]:.4f} ms, "
              f"space_to_depth_2x with the cast {prep[0]:.4f} ms; bound "
              f"{kernel_bound(0, 6 * b * SIZE * SIZE * 3, 'bf16')[0]:.4f} ms "
              f"each [{card}]")
        rows = (
            ("conv_0", lambda: conv_folded(x_plain, p0, **bf),
             plain_cost[0]),
            ("conv_0 s2d", lambda: conv_folded(x_s2d, q0, **bf), s2d_cost[0]),
            ("conv_1", lambda: conv_folded(y_plain, p1, stride=2, **bf),
             plain_cost[1]),
            ("conv_1 s2d", lambda: conv_folded_asym(y_s2d, q1, padding=pad,
                                                    **bf), s2d_cost[1]),
            ("conv_0+conv_1", lambda: conv_folded(conv_folded(
                x_plain, p0, **bf), p1, stride=2, **bf),
             [sum(v) for v in zip(*plain_cost)]),
            ("conv_0+conv_1 s2d", lambda: conv_folded_asym(conv_folded(
                x_s2d, q0, **bf), q1, padding=pad, **bf),
             [sum(v) for v in zip(*s2d_cost)]))
        for name, fn, (flops, bytes_) in rows:
            ms = cuda_ms(fn, 10)
            # the same convs with cuDNN's algorithm chosen by timing, not
            # by its heuristics (the port's setting)
            torch.backends.cudnn.benchmark = True
            try:
                tuned_ms = cuda_ms(fn, 10)
            finally:
                torch.backends.cudnn.benchmark = False
            bound, by = kernel_bound(flops, bytes_, "bf16")
            print(f"stem {name} at batch {b}: {ms:.4f} ms ({tuned_ms:.4f} ms "
                  f"with cudnn.benchmark), bound {bound:.4f} ms ({by}: "
                  f"{flops / 1e9:.1f} GFLOP, {bytes_ / 1e9:.3f} GB), "
                  f"{bound / ms * 100:.1f}% [{card}]")

        # conv_1's asymmetric padding: pad 1 and crop (conv_folded_asym)
        # against F.pad first
        def pad_first():
            y = F.conv2d(F.pad(y_s2d, (1, 0, 1, 0)), q1["w"])
            return leaky_relu(y + q1["b"].to(y.dtype).view(1, -1, 1, 1))

        crop_ms, pad_ms, _, _ = in_turns(
            lambda: conv_folded_asym(y_s2d, q1, padding=pad, **bf),
            pad_first, 10, 10)
        diff = float((conv_folded_asym(y_s2d, q1, padding=pad, **bf).float()
                      - pad_first().float()).abs().max())
        print(f"conv_1 s2d padding at batch {b}: pad 1 and crop "
              f"{crop_ms:.4f} ms, F.pad first {pad_ms:.4f} ms; max |diff| "
              f"{diff:.3g} [{card}]")


def split_phase(dev: torch.device, card: str, variables: dict,
                anchors: np.ndarray, launches: dict, max_err: dict) -> None:
    """Phase 17: the split head and the space-to-depth stem (see the module
    docstring)."""
    served = split_requests(dev, variables, anchors, launches, max_err)
    split_identity(dev, variables, anchors, served["batches"][0])
    s2d_check(dev, variables, anchors, served["batches"][0])
    split_timings(dev, card, variables, anchors, served["det"],
                  served["batches"])


def run_script(module, argv: list) -> str:
    """module.main(argv) in this process on the card: its exit code must be
    0. Returns its standard output, which is also printed (its standard
    error passes through)."""
    import contextlib
    import io
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = module.main(argv)
    out = buf.getvalue()
    print(out, end="")
    name = module.__name__.rsplit(".", 1)[-1]
    print(f"{name} {' '.join(argv)}: rc {rc}, "
          f"{time.perf_counter() - t0:.1f} s")
    check(rc == 0, f"{name} exited {rc}")
    return out


def last_json(text: str, what: str) -> dict:
    try:
        return json.loads(text.strip().splitlines()[-1])
    except (IndexError, json.JSONDecodeError) as e:
        fail(f"{what}: its last line is not a JSON object ({e})")


def bench_check(dev: torch.device, card: str, tmp: Path, launches: dict,
                max_err: dict, packed_ms: float) -> dict:
    """Phase 18, part 1: scripts.bench (its contract, the shared-candidate
    kernel once a request, the kernel on the decode+NMS p50's own K=128
    candidates: bit-equal to its plain version, timed in turns, with its
    bound). Returns K1's K=128 entry of the kernel record."""
    from yolov3_tensorflow_tpu_torch.config import DEFAULT_ANCHORS
    from yolov3_tensorflow_tpu_torch.models.yolov3 import (
        fold_batch_norm, yolov3_forward_folded)
    from yolov3_tensorflow_tpu_torch.ops import nms_cuda
    from yolov3_tensorflow_tpu_torch.ops.fast_postprocess import (
        decode_tables, prefilter_candidates)
    from yolov3_tensorflow_tpu_torch.scripts import bench, roofline
    record_path = tmp / "bench.json"
    nms_cuda.nms_keep_mask_shared.launches = 0
    out = run_script(bench, BENCH_ARGS + ["--record", str(record_path)])
    n = nms_cuda.nms_keep_mask_shared.launches
    record = json.loads(record_path.read_text())
    contract = last_json(out, "bench")
    check(set(contract) == {"metric", "value", "unit", "vs_baseline",
                            "mode"}, f"bench's keys: {sorted(contract)}")
    check(contract["metric"] == "images_per_sec_416_inference"
          and contract["unit"] == "img/s" and contract["value"] > 0
          and contract["mode"] in ("bf16", "stem_int8_hybrid"),
          f"bench's contract: {contract}")
    check(n == record["requests"], f"nms_shared launched {n} times for "
          f"bench's {record['requests']} requests")
    launches["nms_shared"] += n
    rows = {r["batch"]: r for r in record["bf16"]}
    print(f"bench: nms_shared launched {n} times, once for each of its "
          f"{record['requests']} requests; knee (best of "
          f"{sorted(rows)}) at batch {record['best_batch']}: "
          f"{record['value']:.1f} img/s ({contract['mode']}); batch "
          f"{ROOF_BATCH} {rows[ROOF_BATCH]['ms']:.3f} ms/batch (busy "
          f"{rows[ROOF_BATCH]['busy_ms']:.3f} ms) beside phase 8's packed "
          f"{packed_ms:.3f} ms [{card}]")

    p50 = record["p50"]
    b, k = p50["batch"], bench.P50["box_topk"]
    st, it = bench.P50["score_thresh"], bench.P50["iou_thresh"]
    anchors = np.asarray(DEFAULT_ANCHORS, np.float32)
    with torch.inference_mode():
        variables = bench.serving_variables(dev)
        images = bench.bench_images(b, (SIZE, SIZE), dev)
        fmaps = yolov3_forward_folded(
            fold_batch_norm(variables, dtype=torch.bfloat16), images,
            compute_dtype=torch.bfloat16)
        boxes, scores = prefilter_candidates(
            fmaps, C, decode_tables((SIZE, SIZE), anchors, device=dev), k)
        del variables, images, fmaps
    check(tuple(scores.shape) == (b, k, C),
          f"p50 candidates {tuple(scores.shape)}")
    got = nms_cuda.nms_keep_mask_shared(boxes, scores, st, it)
    want = nms_cuda.nms_keep_mask_shared_reference(boxes, scores, st, it)
    check(torch.equal(got, want), "nms_shared keep masks differ on the "
          "decode+NMS p50's K=128 candidates")
    max_err["nms_shared"] = max(max_err["nms_shared"], float(
        (got.float() - want.float()).abs().max()))
    counts = roofline.shared_counts(scores, want, st)
    k_ms, p_ms, k_runs, p_runs = in_turns(
        lambda: nms_cuda.nms_keep_mask_shared(boxes, scores, st, it),
        lambda: nms_cuda.nms_keep_mask_shared_reference(boxes, scores, st,
                                                        it), 200, 3)
    bound = roofline.bound_nms_shared(b, k, C)
    print(f"decode+NMS p50 {p50['ms']:.3f} ms per batch of {b} "
          f"({p50['ms_per_img']:.4f} ms/img, p90 {p50['p90_ms']:.3f}); its "
          f"nms_shared B={b} K={k} C={C}: valid per class mean "
          f"{counts['valid_mean']:.2f} max {counts['valid_max']}, kept mean "
          f"{counts['kept_mean']:.2f} max {counts['kept_max']}; kernel == "
          f"plain; kernel {k_ms:.4f} ms (runs {k_runs[0]:.4f}, "
          f"{k_runs[1]:.4f}), plain {p_ms:.4f} ms (runs {p_runs[0]:.4f}, "
          f"{p_runs[1]:.4f}); bound {bound[0]:.4f} ms ({bound[1]}): "
          f"{bound[0] / k_ms * 100:.1f}% [{card}]")
    return {"shape": f"B={b} K={k} C={C}", "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": bound[0], "bound_by": bound[1]}


def train_scripts_check(card: str, tmp: Path) -> None:
    """Phase 18, part 2: scripts.bench_train (its contract; no MFU above
    MFU_MAX) and scripts.profile_train (every stage, MFU within MFU_MAX,
    busy time and host gap per stage)."""
    from yolov3_tensorflow_tpu_torch.scripts import (bench_train,
                                                     profile_train)
    out = last_json(run_script(bench_train, BENCH_TRAIN_ARGS), "bench_train")
    check(out.get("metric") == "train_step_416", f"bench_train: {out}")
    keys = {"batch", "ms_per_step", "img_per_sec", "model_flops_per_step",
            "mfu_vs_bf16_peak", "busy_ms", "idle_share"}
    for row in out["rows"]:
        check(set(row) == keys, f"bench_train row keys {sorted(row)}")
        mfu = row["mfu_vs_bf16_peak"]
        check(mfu is not None and 0 < mfu <= MFU_MAX,
              f"bench_train MFU {row['mfu_vs_bf16_peak']} at batch "
              f"{row['batch']}: outside (0, {MFU_MAX}]")
        print(f"bench_train batch {row['batch']}: {row['ms_per_step']} "
              f"ms/step, {row['img_per_sec']} img/s, MFU "
              f"{row['mfu_vs_bf16_peak']}, busy {row['busy_ms']} ms, idle "
              f"{row['idle_share']} [{card}]")
    path = tmp / "profile_train.json"
    run_script(profile_train, PROFILE_TRAIN_ARGS + ["--record", str(path)])
    rows = json.loads(path.read_text())["rows"]
    check([r["stage"] for r in rows] == [
        "fwd(train)", "loss(fmaps)", "fwd+loss", "grad(fwd+bwd)",
        "opt(grads)", "l2(params)", "full step"],
        f"profile_train stages {[r['stage'] for r in rows]}")
    for r in rows:
        check(r["mfu"] is not None and r["mfu"] <= MFU_MAX
              and r["busy_ms"] > 0,
              f"profile_train {r['stage']}: MFU {r['mfu']}, busy "
              f"{r['busy_ms']} ms")


def host_scripts_check(card: str, tmp: Path) -> None:
    """Phase 18, part 3: scripts.bench_loader (a rate for every mode at
    each thread count) and scripts.bench_video (rc 0 and a steady-state
    and overall FPS at every frame batch)."""
    import re

    from yolov3_tensorflow_tpu_torch.scripts import bench_loader, bench_video
    out = run_script(bench_loader, LOADER_ARGS)
    lines = [line for line in out.splitlines() if line.startswith("threads")]
    threads = LOADER_ARGS[LOADER_ARGS.index("--threads") + 1].split(",")
    check(len(lines) == len(threads), f"bench_loader lines: {lines}")
    for line in lines:
        # "threads N: train R img/s | train+mixup R | val R | ..."
        rates = [float(re.findall(r"[0-9.]+", part)[-1])
                 for part in line.split(":", 1)[1].split("|")]
        check(len(rates) == 5 and all(r > 0 for r in rates),
              f"bench_loader: {line}")
    path = tmp / "video.json"
    run_script(bench_video, VIDEO_ARGS + ["--out", str(path)])
    results = json.loads(path.read_text())["results"]
    batches = VIDEO_ARGS[VIDEO_ARGS.index("--batches") + 1].split(",")
    check(sorted(results) == sorted(batches), f"bench_video: {results}")
    for fb, r in results.items():
        check(r["rc"] == 0 and r["steady_fps"] and r["overall_fps"],
              f"bench_video frame batch {fb}: {r}")
        print(f"bench_video frame batch {fb}: steady {r['steady_fps']} FPS, "
              f"overall {r['overall_fps']} FPS [{card}]")


def measure_phase(dev: torch.device, card: str, launches: dict,
                  max_err: dict, packed_ms: float) -> dict:
    """Phase 18: the measurement scripts (see the module docstring).
    Returns K1's K=128 entry of the kernel record."""
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        k128 = bench_check(dev, card, tmp, launches, max_err, packed_ms)
        train_scripts_check(card, tmp)
        host_scripts_check(card, tmp)
    return k128


def experiment_scripts(dev: torch.device, card: str, tmp: Path,
                       launches: dict, max_err: dict,
                       packed_ms: float) -> dict:
    """Phase 19, part 1: the seven serving experiments at EXP_ARGS, each
    main in this process: rc 0, its record last and in its --out file, a
    device busy time beside every timed row, the shared-candidate kernel
    once for each call its record counts (joining the kernel record's
    launches), and on exp_topk's synthetic candidates that kernel bit-equal
    to its plain version; exp_pp_incr's full row within PP_INCR_TOL of
    phase 8's packed detector at batch 128. Returns the records by
    script."""
    from yolov3_tensorflow_tpu_torch.ops import nms_cuda
    from yolov3_tensorflow_tpu_torch.scripts import (
        exp_highres_int8, exp_postprocess, exp_pp_incr, exp_score,
        exp_stem_int8, exp_tail, exp_topk)
    modules = {m.__name__.rsplit(".", 1)[-1]: m for m in (
        exp_score, exp_topk, exp_tail, exp_pp_incr, exp_postprocess,
        exp_stem_int8, exp_highres_int8)}
    records = {}
    for name, argv in EXP_ARGS.items():
        torch.cuda.empty_cache()
        path = tmp / "experiments" / f"{name}.json"
        torch.cuda.synchronize()
        nms_cuda.nms_keep_mask_shared.launches = 0
        nms_cuda.nms_keep_mask.launches = 0
        record = last_json(run_script(modules[name],
                                      argv + ["--out", str(path)]), name)
        torch.cuda.synchronize()
        k1, k2 = (nms_cuda.nms_keep_mask_shared.launches,
                  nms_cuda.nms_keep_mask.launches)
        check(record == json.loads(path.read_text()),
              f"{name}: its last line is not its --out record")
        timed = [r for r in record["rows"] if r["ms"] is not None]
        check(bool(timed) and all(r["ms"] > 0 and r["busy_ms"] is not None
                                  for r in timed),
              f"{name}: a timed row without a time or a busy time")
        check((k1, k2) == (record["nms_calls"], 0),
              f"{name}: (nms_shared, nms) launched {(k1, k2)} times for "
              f"its {record['nms_calls']} calls through the kernel")
        launches["nms_shared"] += k1
        print(f"{name}: nms_shared launched {k1} times, once for each of "
              f"its {record['nms_calls']} calls through it [{card}]")
        records[name] = record

    b = records["exp_topk"]["batch"]
    boxes, scores = exp_topk.synthetic_candidates(b, C, dev)
    st, it = exp_topk.NMS["score_thresh"], exp_topk.NMS["iou_thresh"]
    got = nms_cuda.nms_keep_mask_shared(boxes, scores, st, it)
    want = nms_cuda.nms_keep_mask_shared_reference(boxes, scores, st, it)
    check(torch.equal(got, want), "nms_shared keep masks differ on "
                                  "exp_topk's synthetic candidates")
    max_err["nms_shared"] = max(max_err["nms_shared"], float(
        (got.float() - want.float()).abs().max()))
    d = records["exp_topk"]["differences"]
    print(f"exp_topk: nms_shared == plain on its synthetic candidates B={b} "
          f"K={boxes.shape[1]} C={C} (kept {int(want.sum())}); torch.topk "
          f"against the stable sort: {d['indices_differ']} of "
          f"{d['indices']} indices, {d['detections_only_sort']} / "
          f"{d['detections_only_topk']} of {d['detections']} detections "
          f"differ [{card}]")
    full = records["exp_pp_incr"]["rows"][-1]
    check(full["name"] == "full" and full["batch"] == ROOF_BATCH,
          f"exp_pp_incr's last row: {full['name']} at {full['batch']}")
    rel = abs(full["ms"] - packed_ms) / packed_ms
    print(f"exp_pp_incr: full {full['ms']:.3f} ms at batch {ROOF_BATCH} "
          f"beside phase 8's packed {packed_ms:.3f} ms ({rel * 100:.2f}% "
          f"apart); increments {records['exp_pp_incr']['increments']}; "
          f"decode+NMS p50 {records['exp_pp_incr']['p50']['ms']:.3f} ms "
          f"[{card}]")
    check(rel <= PP_INCR_TOL, f"exp_pp_incr's full row {full['ms']:.3f} ms "
                              f"is {rel * 100:.1f}% off phase 8's packed "
                              f"{packed_ms:.3f} ms")
    return records


def recipe_and_native(dev: torch.device, card: str, tmp: Path,
                      gate_dir: Path, gate_map: float,
                      launches: dict) -> None:
    """Phase 19, part 2: scripts.analyze_recipe_precision on phase 13's
    gate (the per-group kernel once per eval batch, joining the kernel
    record's launches; its mAP at cutoff 0.01 the gate's), then the host
    library (utils/native.py): built from csrc/postprocess.cc, its NMS and
    IoU equal to the numpy oracles, and its IoU timed beside numpy's on
    cli.evaluate's shapes (IOU_SHAPES)."""
    from yolov3_tensorflow_tpu_torch.evaluation.metrics import \
        _iou_matrix as iou_matrix
    from yolov3_tensorflow_tpu_torch.ops import nms_cuda
    from yolov3_tensorflow_tpu_torch.scripts import analyze_recipe_precision
    from yolov3_tensorflow_tpu_torch.utils import native
    torch.cuda.synchronize()
    nms_cuda.nms_keep_mask_shared.launches = 0
    nms_cuda.nms_keep_mask.launches = 0
    out = last_json(run_script(analyze_recipe_precision, [
        "--gate", f"device={gate_dir}", "--img_size", str(SIZE),
        "--out", str(tmp / "recipe.json"), "--note",
        str(tmp / "recipe.md")]), "analyze_recipe_precision")
    torch.cuda.synchronize()
    k1, k2 = (nms_cuda.nms_keep_mask_shared.launches,
              nms_cuda.nms_keep_mask.launches)
    gate = out["gates"]["device"]
    check((k1, k2) == (0, gate["eval_batches"]),
          f"analyze_recipe_precision launched (nms_shared, nms) {(k1, k2)}, "
          f"want (0, {gate['eval_batches']})")
    launches["nms"] += k2
    at001 = gate["sweep"]["0.01"]
    print(f"analyze_recipe_precision on the gate: nms launched {k2} times "
          f"({gate['eval_batches']} eval batches); cut 0.01 mAP "
          f"{at001['mAP']:.6f} (the gate's {gate_map:.6f}), precision "
          f"{at001['precision']:.4f}, recall {at001['recall']:.4f}, "
          f"{at001['n_dets']} detections; cut 0.3 precision "
          f"{gate['sweep']['0.3']['precision']:.4f}; decomposition "
          f"{gate['decomposition']} [{card}]")
    check(at001["mAP"] == gate_map,
          f"analyze_recipe_precision's mAP at 0.01 {at001['mAP']} is not the "
          f"gate's {gate_map}")

    t0 = time.perf_counter()
    lib = native.library_path()
    build_s = time.perf_counter() - t0
    check(lib.parent == ROOT / "build" / "torch_kernels",
          f"the host library was built at {lib}")
    native.self_test()
    n_det, n_gt, n_img = IOU_SHAPES
    rng = np.random.default_rng(0)
    pairs = []
    for _ in range(n_img):
        xy = rng.uniform(0, SIZE, (n_det + n_gt, 2))
        wh = rng.uniform(4, 200, (n_det + n_gt, 2))
        bx = np.concatenate([xy, xy + wh], 1).astype(np.float32)
        pairs.append((bx[:n_det], bx[n_det:]))
    for a, b in pairs:
        check(np.array_equal(native.iou_matrix(a, b), iou_matrix(a, b)),
              "the native IoU differs from the numpy IoU")
    ms = {}
    for name, fn in (("numpy", iou_matrix), ("native", native.iou_matrix),
                     ("native", native.iou_matrix), ("numpy", iou_matrix)):
        t0 = time.perf_counter()
        for _ in range(IOU_REPS):
            for a, b in pairs:
                fn(a, b)
        ms.setdefault(name, []).append(
            (time.perf_counter() - t0) * 1e3 / IOU_REPS)
    print(f"host library {lib.relative_to(ROOT)} (g++ route, {build_s:.2f} "
          f"s): NMS == py_nms at offsets 0 and 1, nms_multiclass == cpu_nms, "
          f"IoU == numpy, bit for bit; the IoU of {n_img} images x {n_det} "
          f"detections x {n_gt} GT boxes: native "
          f"{min(ms['native']):.4f} ms, numpy {min(ms['numpy']):.4f} ms per "
          f"batch (the least of 2 turns of {IOU_REPS}, host clock) [{card}]")


def eval_iou_share(dev: torch.device, card: str) -> None:
    """Phase 19, part 3: evaluation.metrics.evaluate_batch, the in-train
    evaluation's host metric, at its own shapes: the eval step's
    detections (eval config) of the seed-0 COCO-80 tree on EVAL_BATCH
    seeded 416^2 images with 4 ground-truth boxes each, timed on this
    host with each IoU route (the host library's, its default here, and
    numpy's) and each route's IoU matrices alone, in turns (the least of
    2, host clock); both routes give the same recall and precision."""
    from yolov3_tensorflow_tpu_torch.config import DEFAULT_ANCHORS
    from yolov3_tensorflow_tpu_torch.evaluation.metrics import (
        _iou_matrix, evaluate_batch, extract_gt_from_y_true)
    from yolov3_tensorflow_tpu_torch.train.trainer import (make_eval_step,
                                                           to_host)
    from yolov3_tensorflow_tpu_torch.utils import native
    cfg = train_config("bfloat16", "momentum")
    _, opt = train_step_fn(cfg)
    images, y_true = dp_batch(EVAL_BATCH, 19,
                              np.asarray(DEFAULT_ANCHORS, np.float32))
    _, dets = make_eval_step(cfg)(fresh_state(opt, dev), images.to(dev),
                                  tuple(y.to(dev) for y in y_true))
    dets = to_host(dets)[0]
    y_np = [y.numpy() for y in y_true]
    pairs = []
    for i in range(EVAL_BATCH):
        valid = dets["valid"][i].astype(bool)
        pairs.append((dets["boxes"][i][valid],
                      extract_gt_from_y_true(y_np, i)[0]))
    check(all(len(a) and len(b) for a, b in pairs),
          "evaluate_batch timing: an image without detections or GT boxes")
    check(native.available(), "the host library does not load here")
    available = native.available

    def metric(route):
        native.available = (available if route == "native"
                            else lambda: False)
        try:
            return evaluate_batch(dets, y_np, C, cfg.eval.eval_threshold)
        finally:
            native.available = available

    check(metric("native") == metric("numpy"),
          "evaluate_batch differs between the IoU routes")
    runs = {"evaluate_batch native": lambda: metric("native"),
            "evaluate_batch numpy": lambda: metric("numpy"),
            "IoU native": lambda: [native.iou_matrix(a, b) for a, b in pairs],
            "IoU numpy": lambda: [_iou_matrix(a, b) for a, b in pairs]}
    ms = {name: [] for name in runs}
    for name in list(runs) + list(reversed(runs)):
        t0 = time.perf_counter()
        runs[name]()
        ms[name].append((time.perf_counter() - t0) * 1e3)
    ms = {name: min(v) for name, v in ms.items()}
    print(f"evaluate_batch at the in-train evaluation's shapes (batch "
          f"{EVAL_BATCH}, {SIZE}^2, COCO-80 seed-0 eval-step detections: "
          f"{[len(a) for a, _ in pairs]} valid, {len(pairs[0][1])} GT "
          f"boxes an image): {ms['evaluate_batch native']:.3f} ms a batch "
          f"with the host library's IoU ({ms['IoU native']:.3f} ms of IoU "
          f"matrices), {ms['evaluate_batch numpy']:.3f} ms with numpy's "
          f"({ms['IoU numpy']:.3f} ms, "
          f"{ms['IoU numpy'] / ms['evaluate_batch numpy']:.2%}); the same "
          f"recall and precision (host clock) [{card}]")


def experiments_phase(dev: torch.device, card: str, tmp: Path,
                      gate_dir: Path, gate_map: float, launches: dict,
                      max_err: dict, packed_ms: float) -> dict:
    """Phase 19: the serving experiments, the recipe-precision analyzer
    and the host library (see the module docstring). Returns the
    experiments' records by script."""
    records = experiment_scripts(dev, card, tmp, launches, max_err,
                                 packed_ms)
    recipe_and_native(dev, card, tmp, gate_dir, gate_map, launches)
    eval_iou_share(dev, card)
    return records


def entry_program(dev: torch.device, card: str, launches: dict,
                  max_err: dict) -> None:
    """Phase 20, part 1: entry() on the card (its default device). The
    example is JAX's (8 zero 416^2 images, float32 on the card); fn on it
    and twice on a seeded batch of 8 keeps the contract (keys, shapes,
    dtypes, finite boxes and scores) and launches the shared-candidate
    kernel once a call (the launches join the kernel record's); that
    kernel is bit-equal to its plain version on the program's own
    candidates; make_entry_fn in fp32 on the card and on the CPU, on the
    same seed-0 tree with the spread head (whose detections clear the
    threshold), finds the same detections on 2 images (the fp32 GPU ==
    CPU rule); the bf16 program on the card and on the CPU, printed. Then
    fn's ms a call at batch 8 (differential_ms, host gaps included) with
    its device busy time."""
    from yolov3_tensorflow_tpu_torch import entry as E
    from yolov3_tensorflow_tpu_torch.config import DEFAULT_ANCHORS
    from yolov3_tensorflow_tpu_torch.models.convert import spread_head
    from yolov3_tensorflow_tpu_torch.models.yolov3 import (fold_batch_norm,
                                                           init_yolov3)
    from yolov3_tensorflow_tpu_torch.ops import nms_cuda
    from yolov3_tensorflow_tpu_torch.ops.fast_postprocess import (
        decode_tables, pack_serving_head, packed_candidates,
        yolov3_forward_packed)
    from yolov3_tensorflow_tpu_torch.testing import match_detections
    from yolov3_tensorflow_tpu_torch.utils.profiling import (device_busy_ms,
                                                             differential_ms)
    cpu = torch.device("cpu")
    fn, example = E.entry()
    check(len(example) == 1 and example[0].shape == (8, SIZE, SIZE, 3)
          and example[0].dtype == torch.float32
          and example[0].device == dev and not bool(example[0].any()),
          f"entry()'s example: {[(tuple(x.shape), x.dtype, x.device) for x in example]}")
    gen = torch.Generator(device=dev).manual_seed(20)
    images = torch.rand((8, SIZE, SIZE, 3), generator=gen, device=dev)
    torch.cuda.synchronize()
    nms_cuda.nms_keep_mask_shared.launches = 0
    nms_cuda.nms_keep_mask.launches = 0
    outs = [fn(*example), fn(images), fn(images)]
    torch.cuda.synchronize()
    k1, k2 = (nms_cuda.nms_keep_mask_shared.launches,
              nms_cuda.nms_keep_mask.launches)
    launches["nms_shared"] += k1
    print(f"entry(): fn on its example and twice on a seeded batch of 8: "
          f"nms_shared launched {k1} times, nms {k2}")
    check((k1, k2) == (len(outs), 0),
          f"entry()'s fn launched (nms_shared, nms) {(k1, k2)} times in "
          f"{len(outs)} calls")
    for out in outs:
        check(set(out) == {"boxes", "scores", "labels", "valid"},
              f"entry()'s fn returned keys {sorted(out)}")
        check(out["boxes"].shape == (8, C * 128, 4)
              and out["boxes"].dtype == torch.float32,
              f"entry() boxes {tuple(out['boxes'].shape)} "
              f"{out['boxes'].dtype}")
        for key, dtype in (("scores", torch.float32), ("labels",
                                                       torch.int32),
                           ("valid", torch.bool)):
            check(out[key].shape == (8, C * 128) and out[key].dtype == dtype,
                  f"entry() {key} {tuple(out[key].shape)} {out[key].dtype}")
        check(bool(torch.isfinite(out["boxes"]).all()
                   and torch.isfinite(out["scores"]).all()),
              "entry(): non-finite detections")
    check(torch.equal(outs[1]["valid"], outs[2]["valid"])
          and torch.equal(outs[1]["boxes"], outs[2]["boxes"]),
          "entry()'s fn answered one batch two ways")
    print(f"entry(): valid detections per image on the example "
          f"{outs[0]['valid'].sum(1).tolist()}, on the seeded batch "
          f"{outs[1]['valid'].sum(1).tolist()}")

    # the kernel on the program's own candidates (calls for the comparison
    # only: the count above is read)
    v = init_yolov3(torch.Generator().manual_seed(0), C, device=cpu)
    anchors = np.asarray(DEFAULT_ANCHORS, np.float32)
    with torch.inference_mode():
        packed = pack_serving_head(fold_batch_norm(to_device(v, dev),
                                                   dtype=torch.bfloat16), C)
        boxes, scores = packed_candidates(
            yolov3_forward_packed(packed, images), C,
            decode_tables((SIZE, SIZE), anchors, device=dev),
            E.SERVING["box_topk"])
        st, it = E.SERVING["score_thresh"], E.SERVING["iou_thresh"]
        got = nms_cuda.nms_keep_mask_shared(boxes, scores, st, it)
        want = nms_cuda.nms_keep_mask_shared_reference(boxes, scores, st, it)
    err = float((got.float() - want.float()).abs().max())
    max_err["nms_shared"] = max(max_err["nms_shared"], err)
    print(f"entry(): nms_shared == plain on its candidates B=8 K="
          f"{boxes.shape[1]} C={C}: {err == 0.0} (kept {int(want.sum())} of "
          f"{int((scores >= st).sum())} valid)")
    check(err == 0.0, "nms_shared keep masks differ on entry()'s candidates")

    small = images[:2]
    spread = spread_head(v, seed=0)
    g32 = E.make_entry_fn(spread, dev, compute_dtype=torch.float32)(small)
    c32 = E.make_entry_fn(spread, cpu, compute_dtype=torch.float32)(
        small.cpu())
    same_detections(detections(c32, 2), detections(g32, 2),
                    E.SERVING["score_thresh"] + 0.02,
                    "entry program (spread head) fp32 GPU vs fp32 CPU")
    cb = detections(E.make_entry_fn(v, cpu)(small.cpu()), 2)
    gb = detections({k: t[:2] for k, t in outs[1].items()}, 2)
    print(f"entry program bf16 (the seed-0 tree): the card finds "
          f"{match_detections(cb, gb, 0.0)[::-1]} of the CPU's detections, "
          f"the CPU {match_detections(gb, cb, 0.0)[::-1]} of the card's "
          f"(found, of)")

    ms = differential_ms(lambda: fn(images), dev, *ENTRY_ITERS)
    busy = device_busy_ms(lambda: fn(images), 5)
    print(f"entry()'s fn at batch 8: {ms:.3f} ms a call (differential "
          f"{ENTRY_ITERS}, host gaps included), {8e3 / ms:.1f} img/s; device "
          f"busy {busy:.3f} ms, idle share {1 - busy / ms:.3f} [{card}]")


def entry_dryruns(card: str, launches: dict, max_err: dict) -> None:
    """Phase 20, part 2: dryrun_multichip over every card of this host
    (NCCL, a card a rank), then over 2 ranks (gloo where they share a
    card): finite losses, JAX's 99% rule on the sharded detections
    against the single-device detector on the plain keep mask, with at
    least one confident detection, the backend, the shared-candidate
    kernel once a rank in the sharded detector (those launches join the
    kernel record's) and equal to its plain version on every rank's
    candidates (B=1, K=64, C=4; joining the record's max_abs_err)."""
    from yolov3_tensorflow_tpu_torch import entry as E
    cards = torch.cuda.device_count()
    for n in sorted({cards, 2}):
        want = "nccl" if cards >= n else "gloo"
        t0 = time.perf_counter()
        got = E.dryrun_multichip(n)
        wall = time.perf_counter() - t0
        print(f"dryrun_multichip({n}): {got} in {wall:.1f} s wall "
              f"[{card}]")
        check(got["backend"] == want,
              f"dryrun_multichip({n}) ran over {got['backend']}, not {want}")
        check(bool(np.isfinite(got["loss"]) and np.isfinite(got["loss_aug"])),
              f"dryrun_multichip({n}): non-finite losses")
        check(got["total"] > 0 and got["found"] >= E.FOUND_SHARE * got["total"],
              f"dryrun_multichip({n}): {got['found']}/{got['total']} "
              f"detections reproduced")
        check(got["nms_shared_launches"] == n,
              f"dryrun_multichip({n}): nms_shared launched "
              f"{got['nms_shared_launches']} times over its ranks")
        check(got["nms_shared_max_err"] == 0.0,
              f"dryrun_multichip({n}): nms_shared differs from its plain "
              f"version by {got['nms_shared_max_err']}")
        launches["nms_shared"] += got["nms_shared_launches"]
        max_err["nms_shared"] = max(max_err["nms_shared"],
                                    got["nms_shared_max_err"])


def busy_checks(dev: torch.device, card: str, tmp: Path,
                records: dict) -> None:
    """Phase 20, part 3: the device busy time inside this long process
    (utils.profiling.device_busy_ms). Every K1 row of phase 19's exp_tail
    reads a busy time above 0; phase 19's exp_pp_incr forward-only row at
    batch 128 has the idle share (1 - busy / ms) of the same script run
    alone in a fresh process, within IDLE_ALONE_TOL; and a device-bound
    call, the packed forward at batch 128, reads a busy time short of the
    device's time of the same calls (between the session's two markers,
    utils.profiling.device_timeline) by at most GAP_FLOORS launch floors
    an event: the gaps between its kernels, and no lost event. Its device
    time alone (cuda_ms, another reading) is printed beside: with the card
    at its power limit two readings of the forward differ by up to 4%."""
    from yolov3_tensorflow_tpu_torch.models.yolov3 import (fold_batch_norm,
                                                           init_yolov3)
    from yolov3_tensorflow_tpu_torch.ops.fast_postprocess import (
        pack_serving_head, yolov3_forward_packed)
    from yolov3_tensorflow_tpu_torch.utils.profiling import (
        cuda_ms, device_timeline, union_length)
    k1_rows = [r for r in records["exp_tail"]["rows"]
               if r["name"].startswith("K1")]
    print("exp_tail's K1 rows in phase 19: " + "; ".join(
        f"{r['name']} {r['ms']:.4f} ms, busy {r['busy_ms']:.4f} ms"
        for r in k1_rows) + f" [{card}]")
    check(bool(k1_rows) and all(r["busy_ms"] > 0 for r in k1_rows),
          "a K1 row of exp_tail read no device busy time")
    path = tmp / "exp_pp_incr_alone.json"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "yolov3_tensorflow_tpu_torch.scripts."
         "exp_pp_incr", *EXP_ARGS["exp_pp_incr"], "--out", str(path)],
        cwd=str(ROOT), capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0,
          f"exp_pp_incr alone exited {proc.returncode}: {proc.stderr[-2000:]}")
    alone = json.loads(path.read_text())

    def idle(record):
        row = next(r for r in record["rows"] if r["name"] == "fwd only")
        return row, 1 - row["busy_ms"] / row["ms"]

    (here, i_here), (there, i_there) = idle(records["exp_pp_incr"]), idle(
        alone)
    print(f"exp_pp_incr fwd only at batch {ROOF_BATCH}: in this process "
          f"{here['ms']:.3f} ms, busy {here['busy_ms']:.3f} ms, idle share "
          f"{i_here:.4f}; alone ({time.perf_counter() - t0:.1f} s) "
          f"{there['ms']:.3f} ms, busy {there['busy_ms']:.3f} ms, idle share "
          f"{i_there:.4f} [{card}]")
    check(abs(i_here - i_there) <= IDLE_ALONE_TOL,
          f"the forward's idle share {i_here:.4f} here and {i_there:.4f} "
          f"alone differ by more than {IDLE_ALONE_TOL}")

    gen = torch.Generator(device=dev).manual_seed(21)
    with torch.inference_mode():
        packed = pack_serving_head(fold_batch_norm(init_yolov3(
            torch.Generator().manual_seed(0), C, device=dev),
            dtype=torch.bfloat16), C)
        images = torch.rand((ROOF_BATCH, SIZE, SIZE, 3), generator=gen,
                            device=dev)

        def fwd():
            return yolov3_forward_packed(packed, images)

        alone_ms = cuda_ms(fwd, BUSY_DEVICE_ITERS)
        floor_us = cuda_ms(lambda: torch.cuda._sleep(0), 200) * 1e3
        events, calls_us = device_timeline(fwd, BUSY_DEVICE_ITERS)
    n = BUSY_DEVICE_ITERS
    busy = union_length([(lo, hi) for _, lo, hi in events]) / 1e3 / n
    calls = calls_us / 1e3 / n
    per_call = len(events) / n
    gap_us = (calls - busy) * 1e3 / per_call
    print(f"packed forward at batch {ROOF_BATCH}: in one profiler session "
          f"{calls:.3f} ms a call of device time between the markers, busy "
          f"{busy:.3f} ms ({busy / calls:.4f}), {per_call:.0f} device events "
          f"a call, {gap_us:.2f} us between events against a launch floor "
          f"of {floor_us:.2f} us; device time alone {alone_ms:.3f} ms "
          f"(cuda_ms, before the session) [{card}]")
    check(gap_us <= GAP_FLOORS * floor_us,
          f"the forward's busy time {busy:.3f} ms leaves {gap_us:.2f} us an "
          f"event of its {calls:.3f} ms, more than {GAP_FLOORS} launch "
          f"floors ({floor_us:.2f} us): the profiler lost device time")


def entry_phase(dev: torch.device, card: str, tmp: Path, launches: dict,
                max_err: dict, records: dict) -> None:
    """Phase 20: the graft entry points (see the module docstring)."""
    entry_program(dev, card, launches, max_err)
    entry_dryruns(card, launches, max_err)
    busy_checks(dev, card, tmp, records)


def epilogue_calls(packed: dict, images: torch.Tensor) -> list:
    """One packed forward with every conv epilogue caught: per call (the
    kernel's mode, a copy of y, bias, shortcut, low), the copy taken
    before the kernel writes y over."""
    from yolov3_tensorflow_tpu_torch.models import layers
    from yolov3_tensorflow_tpu_torch.ops import conv_epilogue as ce
    from yolov3_tensorflow_tpu_torch.ops import fast_postprocess as fp
    calls = []

    def caught(y, bias, *, leaky=True, shortcut=None, low=None,
               mish=False):
        calls.append((ce._mode(leaky, shortcut, low, mish), y.clone(), bias,
                      shortcut, low))
        return ce.conv_epilogue(y, bias, leaky=leaky, shortcut=shortcut,
                                low=low, mish=mish)
    kept = layers.conv_epilogue, fp.conv_epilogue
    layers.conv_epilogue = fp.conv_epilogue = caught
    try:
        with torch.inference_mode():
            fp.yolov3_forward_packed(packed, images)
    finally:
        layers.conv_epilogue, fp.conv_epilogue = kept
    torch.cuda.synchronize()
    return calls


def epilogue_phase(dev: torch.device, card: str, variables: dict,
                   launches: dict, max_err: dict, kernel_ms: dict,
                   bounds: dict, library: dict) -> None:
    """Phase 21: the folded conv's epilogue at the offline cell's shapes
    (see the module docstring). Fills the records' time, bound and
    library entries; its launches are counted in phase 4."""
    from yolov3_tensorflow_tpu_torch.models import layers
    from yolov3_tensorflow_tpu_torch.models.yolov3 import fold_batch_norm
    from yolov3_tensorflow_tpu_torch.ops import conv_epilogue as ce
    from yolov3_tensorflow_tpu_torch.ops import fast_postprocess as fp
    from yolov3_tensorflow_tpu_torch.scripts import roofline
    from yolov3_tensorflow_tpu_torch.utils.profiling import cuda_ms
    names = {ce.BIAS: "bias", ce.LEAKY: "leaky", ce.RESIDUAL: "residual",
             ce.JUNCTION: "junction"}
    packed = fp.pack_serving_head(fold_batch_norm(variables), C)
    gen = torch.Generator(device=dev).manual_seed(21)
    max_err["conv_epilogue"] = 0.0
    for b in EPILOGUE_BATCHES:
        images = torch.rand((b, SIZE, SIZE, 3), generator=gen, device=dev)
        ce.conv_epilogue.launches = 0
        calls = epilogue_calls(packed, images)
        n = ce.conv_epilogue.launches
        modes = [m for m, *_ in calls]
        print(f"conv_epilogue at batch {b}: {len(calls)} calls, {n} "
              f"launches (" + ", ".join(
                  f"{modes.count(m)} {names[m]}" for m in names) + ")")
        check(len(calls) == n == EPILOGUE_CALLS,
              f"a packed forward made {len(calls)} epilogue calls and "
              f"{n} launches, not {EPILOGUE_CALLS}")
        rows = {}
        k_sum = p_sum = bound_sum = gb_sum = 0.0
        for mode, y, bias, shortcut, low in calls:
            kw = dict(leaky=mode != ce.BIAS, shortcut=shortcut, low=low)
            want = ce.conv_epilogue_reference(y, bias, **kw)
            got = ce.conv_epilogue(y.clone(), bias, **kw)
            bits = torch.int16 if y.dtype == torch.bfloat16 else torch.int32
            same = torch.equal(got.view(bits), want.view(bits))
            check(same, f"conv_epilogue {names[mode]} {tuple(y.shape)}: "
                        f"kernel and plain version differ")
            if b != EPILOGUE_BATCHES[0]:
                continue
            extra = shortcut if low is None else low
            extra_n = 0 if extra is None else extra.numel()
            gb = (2 * y.numel() + extra_n) * y.element_size() / 1e9
            bound = roofline.bound_conv_epilogue(y.numel(),
                                                 y.element_size(), extra_n)
            buf = y.clone()
            k_ms = cuda_ms(lambda: ce.conv_epilogue(buf, bias, **kw), 5)
            p_ms = cuda_ms(lambda: ce.conv_epilogue_reference(y, bias, **kw),
                           3)
            del buf
            key = (names[mode], tuple(y.shape))
            r = rows.setdefault(key, [0, 0.0, 0.0, 0.0])
            r[0] += 1
            r[1] += k_ms
            r[2] += p_ms
            r[3] += gb
            k_sum, p_sum, gb_sum = k_sum + k_ms, p_sum + p_ms, gb_sum + gb
            bound_sum += bound[0]
        del calls
        if b == EPILOGUE_BATCHES[0]:
            for (mode, shape), (cnt, k_ms, p_ms, gb) in rows.items():
                print(f"  {mode} {shape} x{cnt}: kernel {k_ms:.4f} ms, "
                      f"{gb / k_ms * 1e3:.0f} GB/s, plain chain {p_ms:.4f} "
                      f"ms, {gb:.3f} GB")
            kernel_ms["conv_epilogue"] = (k_sum, p_sum)
            bounds["conv_epilogue"] = (bound_sum, "bytes")
            library["conv_epilogue"] = None     # no single torch call
            print(f"conv_epilogue over the {EPILOGUE_CALLS} calls at batch "
                  f"{b}: kernel {k_sum:.4f} ms ({gb_sum:.3f} GB, "
                  f"{gb_sum / k_sum * 1e3:.0f} GB/s), plain chain "
                  f"{p_sum:.4f} ms; "
                  f"bound {bound_sum:.4f} ms (bytes at "
                  f"{roofline.H100_PEAKS['hbm'] / 1e9:.0f} GB/s): "
                  f"{bound_sum / k_sum * 100:.1f}% [{card}]")

        def forward():
            with torch.inference_mode():
                return fp.yolov3_forward_packed(packed, images)

        def plain_forward():
            kept = layers.conv_epilogue, fp.conv_epilogue
            layers.conv_epilogue = fp.conv_epilogue = \
                ce.conv_epilogue_reference
            try:
                return forward()
            finally:
                layers.conv_epilogue, fp.conv_epilogue = kept

        got, want = forward(), plain_forward()
        check(all(torch.equal(g, w) for g, w in zip(got, want)),
              f"the packed forward at batch {b} differs from the plain "
              f"chain's")
        del got, want
        k_ms, p_ms, k_runs, p_runs = in_turns(forward, plain_forward, 5, 5)
        host = {}
        for name, fn in (("kernel", forward), ("plain", plain_forward)):
            torch.cuda.synchronize()
            torch.cuda._sleep(int(200 * 2e6))   # the host issues ahead
            t0 = time.perf_counter()
            fn()
            host[name] = (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize()
        print(f"packed forward at batch {b}, 416^2: with the epilogue "
              f"kernel {k_ms:.3f} ms (runs {k_runs[0]:.3f}, "
              f"{k_runs[1]:.3f}), with the plain chain {p_ms:.3f} ms (runs "
              f"{p_runs[0]:.3f}, {p_runs[1]:.3f}), device alone; the host "
              f"issues it in {host['kernel']:.2f} ms and "
              f"{host['plain']:.2f} ms [{card}]")
        del images
        torch.cuda.empty_cache()


def mish_calls(packed: dict, images: torch.Tensor) -> list:
    """One YOLOv4 packed forward with its Mish epilogues caught: per call
    (a copy of y, bias, shortcut), the copy taken before the kernel writes
    y over."""
    from yolov3_tensorflow_tpu_torch.models import layers, yolov4
    from yolov3_tensorflow_tpu_torch.ops import conv_epilogue as ce
    calls = []

    def caught(y, bias, *, shortcut=None, mish=False, **kw):
        if mish:
            calls.append((y.clone(), bias, shortcut))
        return ce.conv_epilogue(y, bias, shortcut=shortcut, mish=mish, **kw)
    kept = layers.conv_epilogue
    layers.conv_epilogue = caught
    try:
        with torch.inference_mode():
            yolov4.yolov4_forward_packed(packed, images)
    finally:
        layers.conv_epilogue = kept
    torch.cuda.synchronize()
    return calls


def yolov4_phase(dev: torch.device, card: str, launches: dict,
                 max_err: dict, kernel_ms: dict, bounds: dict,
                 library: dict) -> None:
    """Phase 22: YOLOv4's Mish epilogues on the main path (see the module
    docstring). Fills the records of conv_epilogue_mish."""
    from yolov3_tensorflow_tpu_torch.models.yolov4 import init_yolov4
    from yolov3_tensorflow_tpu_torch.ops import conv_epilogue as ce
    from yolov3_tensorflow_tpu_torch.ops.postprocess import build_detector
    from yolov3_tensorflow_tpu_torch.scripts import roofline
    from yolov3_tensorflow_tpu_torch.utils.profiling import cuda_ms
    hw = (YOLOV4_SIZE, YOLOV4_SIZE)
    anchors = np.asarray([[12, 16], [19, 36], [40, 28], [36, 75], [76, 55],
                          [72, 146], [142, 110], [192, 243], [459, 401]],
                         np.float32)
    variables = init_yolov4(torch.Generator().manual_seed(0), C, device=dev)
    det = build_detector(variables, anchors, C, hw, device=dev,
                         compute_dtype=torch.bfloat16, mode="packed",
                         arch="yolov4", **SERVING)
    gen = torch.Generator(device=dev).manual_seed(22)
    images = torch.rand((YOLOV4_BATCH,) + hw + (3,), generator=gen,
                        device=dev)
    det(images)                              # the first call builds
    torch.cuda.synchronize()
    # the table the first bf16 Mish call built, once, against the plain
    # version on this card at each of its 65,536 codes
    codes = torch.arange(1 << 16, dtype=torch.int32, device=dev).to(
        torch.int16).view(torch.bfloat16)
    table = ce._mish_table(dev)
    builds = ce._mish_table.cache_info().currsize
    launches["conv_epilogue_mish_table"] = builds
    check(builds == 1, f"the Mish table was built {builds} times on one "
                       f"device, not once")
    check(torch.equal(table, ce.mish_activation(codes).view(torch.int16)),
          "the device's Mish table differs from mish_activation")
    build = ce._launchers().mish_table
    again = torch.empty_like(table)
    stream = torch.cuda.current_stream(dev).cuda_stream
    check(build(again.data_ptr(), stream) == 0, "mish_table_build failed")
    t_ms = cuda_ms(lambda: build(again.data_ptr(), stream), 20)
    check(torch.equal(again, table), "mish_table_build's two tables differ")
    max_err["conv_epilogue_mish_table"] = 0.0
    kernel_ms["conv_epilogue_mish_table"] = (
        t_ms, cuda_ms(lambda: ce.mish_activation(codes), 20))
    bounds["conv_epilogue_mish_table"] = roofline.kernel_bound(
        0.0, float(table.numel() * table.element_size()), "fp32")
    library["conv_epilogue_mish_table"] = None
    print(f"Mish table ({table.numel()} bf16 codes) built {builds} time(s) "
          f"on the device, equal to mish_activation at every code: "
          f"{t_ms * 1e3:.2f} us a build, plain version "
          f"{kernel_ms['conv_epilogue_mish_table'][1] * 1e3:.2f} us [{card}]")
    del codes, again
    by_mode = ce.conv_epilogue.launches_by_mode
    by_route = ce.conv_epilogue.mish_launches_by_route
    for counts in (by_mode, by_route):
        for key in counts:
            counts[key] = 0
    out = det(images)
    torch.cuda.synchronize()
    n = by_mode["mish"] + by_mode["mish_residual"]
    launches["conv_epilogue_mish"] = n
    print(f"YOLOv4 packed detector at batch {YOLOV4_BATCH}, "
          f"{YOLOV4_SIZE}^2: epilogue launches by mode {dict(by_mode)}, "
          f"Mish launches by route {dict(by_route)}; "
          f"{int(out['valid'].sum())} detections")
    check(n == YOLOV4_MISH_CALLS == by_route["table"]
          and by_route["chain"] == 0,
          f"a YOLOv4 request launched the Mish modes {n} times, by route "
          f"{dict(by_route)}, not {YOLOV4_MISH_CALLS} on the table")
    check(bool(torch.isfinite(out["boxes"]).all()
               and torch.isfinite(out["scores"]).all()),
          "YOLOv4: non-finite detections")
    del out

    calls = mish_calls(det.packed, images)
    del det, images
    check(len(calls) == YOLOV4_MISH_CALLS,
          f"a YOLOv4 packed forward made {len(calls)} Mish epilogue calls, "
          f"not {YOLOV4_MISH_CALLS}")
    k_sum = p_sum = bound_sum = gb_sum = neg = 0.0
    elems = 0
    with torch.inference_mode():
        for y, bias, shortcut in calls:
            kw = dict(shortcut=shortcut, mish=True)
            want = ce.conv_epilogue_reference(y, bias, **kw)
            got = ce.conv_epilogue(y.clone(), bias, **kw)
            check(torch.equal(got.view(torch.int16), want.view(torch.int16)),
                  f"conv_epilogue mish {tuple(y.shape)} shortcut "
                  f"{shortcut is not None}: kernel and plain version differ")
            # the activation's input, y + b, as the kernel forms it
            neg += float(((y.float() + bias.float().view(1, -1, 1, 1))
                          < 0).sum())
            elems += y.numel()
            del got, want
            extra_n = 0 if shortcut is None else shortcut.numel()
            buf = y.clone()
            k_sum += cuda_ms(lambda: ce.conv_epilogue(buf, bias, **kw), 5)
            p_sum += cuda_ms(
                lambda: ce.conv_epilogue_reference(y, bias, **kw), 3)
            del buf
            gb_sum += (2 * y.numel() + extra_n) * y.element_size() / 1e9
            bound_sum += roofline.bound_conv_epilogue(
                y.numel(), y.element_size(), extra_n)[0]
    del calls
    torch.cuda.empty_cache()
    max_err["conv_epilogue_mish"] = 0.0
    kernel_ms["conv_epilogue_mish"] = (k_sum, p_sum)
    bounds["conv_epilogue_mish"] = (bound_sum, "bytes")
    library["conv_epilogue_mish"] = None     # no single torch call
    print(f"conv_epilogue mish over the {YOLOV4_MISH_CALLS} calls at batch "
          f"{YOLOV4_BATCH}, {YOLOV4_SIZE}^2, each bit-equal to its plain "
          f"version ({neg / elems:.3f} of their inputs below 0): kernel "
          f"{k_sum:.4f} ms ({gb_sum:.3f} GB, {gb_sum / k_sum * 1e3:.0f} "
          f"GB/s), plain chain {p_sum:.4f} ms; bound {bound_sum:.4f} ms "
          f"(bytes at {roofline.H100_PEAKS['hbm'] / 1e9:.0f} GB/s): "
          f"{bound_sum / k_sum * 100:.1f}% [{card}]")
    epilogue_machine_code()


def epilogue_machine_code() -> None:
    """Phase 22's reading of conv_epilogue.cu's machine code (cuobjdump
    -sass of this build): the kernels off the Mish table route against
    E1_BEFORE_TABLE, where the installed nvcc is the one it was recorded
    with; the MUFU operations of each Mish instance."""
    from yolov3_tensorflow_tpu_torch.utils import kernels
    code = {E1_ANON.sub("", name): lines for name, lines in
            kernels.sass_functions(kernels.build_kernel(
                "conv_epilogue")).items()}
    nvcc = kernels.nvcc_version()
    if nvcc == E1_BEFORE_TABLE_NVCC:
        digest = {name: hashlib.sha256("\n".join(code.get(name, ())).encode()
                                       ).hexdigest()[:16]
                  for name in E1_BEFORE_TABLE}
        changed = [name for name in E1_BEFORE_TABLE
                   if digest[name] != E1_BEFORE_TABLE[name]]
        check(not changed, f"conv_epilogue's machine code changed off the "
                           f"Mish table route: {changed}")
        print(f"conv_epilogue machine code: the {len(E1_BEFORE_TABLE)} "
              f"kernels off the Mish table route equal to the build before "
              f"the table, instruction for instruction ({nvcc})")
    else:
        print(f"conv_epilogue machine code off the Mish table route: not "
              f"compared (recorded with nvcc {E1_BEFORE_TABLE_NVCC}, this "
              f"is {nvcc})")
    mish = sorted(name for name in code
                  if name.startswith("conv_epilogue_mish_kernel"))
    check(len(mish) == 8, f"conv_epilogue holds {len(mish)} Mish "
                          f"instances, not 8")
    for name in mish:
        # MUFU.RCP* serve the integer divisions of every instance's walk;
        # the others (EX2, LG2, ...) mish()'s expf, log1pf and tanhf
        mufu = [line for line in code[name]
                if kernels.sass_opcode(line) == "MUFU"]
        math = sum(".RCP" not in line for line in mufu)
        print(f"  {name}: MUFU {len(mufu)}, of them for mish() {math}; "
              f"{len(code[name])} lines of SASS")
        check(math == 0 if "bfloat16" in name else math > 0,
              f"{name}: {math} MUFU for mish()")

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
    from yolov3_tensorflow_tpu_torch.models.decode import predict_boxes
    from yolov3_tensorflow_tpu_torch.models.yolov3 import (
        init_yolov3, yolov3_forward_folded)
    from yolov3_tensorflow_tpu_torch.ops import nms_cuda
    from yolov3_tensorflow_tpu_torch.ops.conv_epilogue import conv_epilogue
    from yolov3_tensorflow_tpu_torch.ops.fast_postprocess import (
        packed_candidates, prefilter_candidates, yolov3_forward_packed)
    from yolov3_tensorflow_tpu_torch.ops.nms import (compact_per_class,
                                                     select_per_class)
    from yolov3_tensorflow_tpu_torch.ops.postprocess import build_detector
    from yolov3_tensorflow_tpu_torch.scripts import roofline
    from yolov3_tensorflow_tpu_torch.testing import (bench_case, card_cases,
                                                     nms_cases,
                                                     per_class_cases)
    from yolov3_tensorflow_tpu_torch.utils import kernels
    from yolov3_tensorflow_tpu_torch.utils.profiling import (cuda_ms,
                                                             device_busy_ms)
    from yolov3_tensorflow_tpu_torch.utils.weights import (
        load_darknet_weights, save_darknet_weights)
    check_no_jax()

    dev = torch.device("cuda", 0)
    cpu = torch.device("cpu")
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]} device {torch.cuda.get_device_name(0)}")
    # every fp32 comparison below runs in full fp32 (cuDNN defaults to TF32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # ---- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    libs = kernels.build_kernels(*BUILDS)
    print(f"build {', '.join(BUILDS)} (one nvcc each, in parallel): "
          f"{time.perf_counter() - t0:.2f} s")
    for name, lib in libs.items():
        print(f"  {name} -> {lib.relative_to(ROOT)}")
        log = lib.with_suffix(".so.log")
        if log.exists():
            for line in log.read_text().splitlines():
                if any(w in line for w in ("registers", "spill", "Compiling")):
                    print(f"  ptxas: {line.strip()}")
    sass = kernels.sass_counts(libs["mma_rate"])
    print(f"mma_rate machine code: {sass['HGMMA']} HGMMA (wgmma), "
          f"{sass['HMMA']} HMMA (mma.sync)")
    check(sass["HGMMA"] > 0 and sass["HMMA"] == 0,
          f"mma_rate must run on wgmma alone, got {sass}")

    # ---- 3. kernels against their plain versions -------------------------
    cases = (nms_cases(batch=16, seed=1) + [bench_case(seed=2)]
             + card_cases(seed=3))
    max_err = {"nms_shared": kernel_cases(dev, cases), "nms": 0.0}
    for case in per_class_cases(groups=16, seed=1):
        max_err["nms"] = max(max_err["nms"], keep_mask_error(
            torch.from_numpy(case.boxes).to(dev),
            torch.from_numpy(case.valid).to(dev), case.iou_thresh,
            f"case {case.name}"))
    launches = {}

    # ---- 4. the packed path at full width --------------------------------
    anchors = np.asarray(DEFAULT_ANCHORS, np.float32)
    variables = spread_head(
        init_yolov3(torch.Generator().manual_seed(0), C, device=dev), seed=0)
    det = build_detector(variables, anchors, C, (SIZE, SIZE), device=dev,
                         compute_dtype=torch.bfloat16, mode="packed",
                         **SERVING)
    gen = torch.Generator(device=dev).manual_seed(1)
    batches = [torch.rand((b, SIZE, SIZE, 3), generator=gen, device=dev)
               for b in REQUESTS]
    torch.cuda.synchronize()

    nms_cuda.nms_keep_mask_shared.launches = 0
    nms_cuda.nms_keep_mask.launches = 0
    conv_epilogue.launches = 0
    results = []
    t0 = time.perf_counter()
    for images in batches:
        results.append(det(images))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches["nms_shared"] = nms_cuda.nms_keep_mask_shared.launches
    launches["conv_epilogue"] = conv_epilogue.launches
    check_requests(results, REQUESTS, SERVING["max_out"], "packed")
    print(f"packed: served {len(REQUESTS)} requests ({sum(REQUESTS)} images) "
          f"in {wall:.3f} s wall, first calls included; nms_shared launches "
          f"{launches['nms_shared']}, nms launches "
          f"{nms_cuda.nms_keep_mask.launches}, conv_epilogue launches "
          f"{launches['conv_epilogue']}")
    check(launches["nms_shared"] == len(REQUESTS),
          f"nms_shared launched {launches['nms_shared']} times for "
          f"{len(REQUESTS)} requests")
    check(launches["conv_epilogue"] == EPILOGUE_CALLS * len(REQUESTS),
          f"conv_epilogue launched {launches['conv_epilogue']} times for "
          f"{len(REQUESTS)} packed forwards, not {EPILOGUE_CALLS} each")

    with torch.inference_mode():
        outs = yolov3_forward_packed(det.packed, batches[-1],
                                     compute_dtype=torch.bfloat16)
        boxes_p, scores_p = packed_candidates(outs, C, det.tables,
                                              SERVING["box_topk"])
        keep = nms_cuda.nms_keep_mask_shared(boxes_p, scores_p, 0.3, 0.45)
        want = nms_cuda.nms_keep_mask_shared_reference(boxes_p, scores_p,
                                                       0.3, 0.45)
        torch.cuda.synchronize()
    err = float((keep.float() - want.float()).abs().max())
    max_err["nms_shared"] = max(max_err["nms_shared"], err)
    print(f"main-path candidates B={boxes_p.shape[0]} K={boxes_p.shape[1]} "
          f"C={scores_p.shape[2]}: kept {int(want.sum())} of "
          f"{int((scores_p >= 0.3).sum())} valid; kernel == plain: "
          f"{err == 0.0}")
    check(err == 0.0, "kernel and plain keep masks differ on the main path")

    # fp32 on the GPU against fp32 on the CPU, 2 images
    small = batches[0][:2]
    g32 = build_detector(variables, anchors, C, (SIZE, SIZE), device=dev,
                         compute_dtype=torch.float32, mode="packed",
                         **SERVING)(small)
    c32 = build_detector(variables, anchors, C, (SIZE, SIZE), device=cpu,
                         compute_dtype=torch.float32, mode="packed",
                         **SERVING)(small.cpu())
    same_detections(detections(c32, 2), detections(g32, 2), 0.32,
                    "packed fp32 GPU vs fp32 CPU")

    # ---- 5. weights ------------------------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "yolov3_seeded.weights"
        t0 = time.perf_counter()
        save_darknet_weights(variables, str(path), C)
        t1 = time.perf_counter()
        loaded = load_darknet_weights(
            init_yolov3(torch.Generator().manual_seed(7), C, device=dev),
            str(path), C)
        t2 = time.perf_counter()
        size_mb = path.stat().st_size / 1e6
    n_tensors = 0
    for part in ("params", "batch_stats"):
        for scope, tree in variables[part].items():
            for name, p in tree.items():
                for key, v in p.items():
                    got = loaded[part][scope][name][key]
                    check(got.device == v.device and torch.equal(got, v),
                          f"weights: {part}/{scope}/{name}/{key} differs "
                          f"after the round trip")
                    n_tensors += 1
    print(f"weights: wrote {size_mb:.1f} MB in {t1 - t0:.2f} s, loaded in "
          f"{t2 - t1:.2f} s; {n_tensors} tensors equal")

    # ---- 6. the exact path at full width ---------------------------------
    exact = build_detector(loaded, anchors, C, (SIZE, SIZE), device=dev,
                           compute_dtype=torch.bfloat16, mode="exact", **EVAL)
    requests = batches[:EXACT_REQUESTS]
    check(all(b.shape[0] == 8 for b in requests), "exact requests are batch 8")
    torch.cuda.synchronize()
    nms_cuda.nms_keep_mask_shared.launches = 0
    nms_cuda.nms_keep_mask.launches = 0
    results = []
    t0 = time.perf_counter()
    for images in requests:
        results.append(exact(images))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches["nms"] = nms_cuda.nms_keep_mask.launches
    check_requests(results, [8] * EXACT_REQUESTS, EVAL["max_out"], "exact")
    print(f"exact: served {EXACT_REQUESTS} requests (batch 8) in {wall:.3f} s "
          f"wall, first calls included; nms launches {launches['nms']}, "
          f"nms_shared launches {nms_cuda.nms_keep_mask_shared.launches}")
    check(launches["nms"] == EXACT_REQUESTS,
          f"nms launched {launches['nms']} times for {EXACT_REQUESTS} "
          f"requests")

    with torch.inference_mode():
        fmaps = yolov3_forward_folded(exact.folded, requests[-1],
                                      compute_dtype=torch.bfloat16)
        boxes, confs, probs = predict_boxes(fmaps, anchors, C, (SIZE, SIZE))
        top_scores, top_boxes, valid = select_per_class(
            boxes, confs * probs, EVAL["pre_topk"], EVAL["score_thresh"])
        b, _, k = valid.shape
        gboxes, gvalid = top_boxes.reshape(b * C, k, 4), valid.reshape(b * C, k)
        max_err["nms"] = max(max_err["nms"], keep_mask_error(
            gboxes, gvalid, EVAL["iou_thresh"], "exact-path candidates"))
        nv = gvalid.sum(1).float()
        nk = nms_cuda.nms_keep_mask_reference(
            gboxes, gvalid, EVAL["iou_thresh"]).sum(1).float()
    print(f"nms inputs at the eval shape: valid per group mean "
          f"{float(nv.mean()):.1f} max {int(nv.max())}, kept per group mean "
          f"{float(nk.mean()):.1f} max {int(nk.max())} (of K={k})")

    # fp32 on the GPU against fp32 on the CPU, 2 images, demo config
    g32 = build_detector(loaded, anchors, C, (SIZE, SIZE), device=dev,
                         compute_dtype=torch.float32, mode="exact",
                         **DEMO)(small)
    c32 = build_detector(loaded, anchors, C, (SIZE, SIZE), device=cpu,
                         compute_dtype=torch.float32, mode="exact",
                         **DEMO)(small.cpu())
    same_detections(detections(c32, 2), detections(g32, 2),
                    DEMO["score_thresh"] + 0.02, "exact fp32 GPU vs fp32 CPU")

    # ---- 7. the prefilter path -------------------------------------------
    images = batches[0]
    pre = build_detector(loaded, anchors, C, (SIZE, SIZE), device=dev,
                         compute_dtype=torch.bfloat16, mode="prefilter",
                         box_topk=BOX_TOPK, **DEMO)
    torch.cuda.synchronize()
    nms_cuda.nms_keep_mask_shared.launches = 0
    nms_cuda.nms_keep_mask.launches = 0
    out = pre(images)
    torch.cuda.synchronize()
    print(f"prefilter: 1 request (batch 8); nms_shared launches "
          f"{nms_cuda.nms_keep_mask_shared.launches}, nms launches "
          f"{nms_cuda.nms_keep_mask.launches}")
    check(nms_cuda.nms_keep_mask_shared.launches == 1,
          "prefilter: nms_shared did not launch once")
    check_requests([out], [8], DEMO["max_out"], "prefilter")

    # the exactness check runs in fp32: bf16 logits tie often, and the two
    # paths order equal scores differently (candidate rank, anchor index)
    pre32 = build_detector(loaded, anchors, C, (SIZE, SIZE), device=dev,
                           compute_dtype=torch.float32, mode="prefilter",
                           box_topk=BOX_TOPK, **DEMO)
    with torch.inference_mode():
        fmaps = yolov3_forward_folded(pre32.folded, images,
                                      compute_dtype=torch.float32)
        _, confs, probs = predict_boxes(fmaps, anchors, C, (SIZE, SIZE))
        best = (confs * probs).amax(dim=-1)                      # [8, A]
    thresh, fits = None, None
    for t in (0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9):
        passing = (best >= t).sum(dim=1)
        print(f"prefilter: boxes passing score {t:.1f} per image (fp32): "
              f"{passing.tolist()} (box_topk {BOX_TOPK})")
        fits = ((passing > 0) & (passing <= BOX_TOPK)).nonzero()[:, 0]
        if len(fits):
            thresh = t
            break
    check(thresh is not None, "prefilter: no threshold leaves an image with "
          f"1..{BOX_TOPK} passing boxes")
    print(f"prefilter: {len(fits)} of 8 images meet the exactness condition "
          f"at score {thresh:.1f}: images {fits.tolist()}")
    kw = dict(DEMO, score_thresh=thresh)
    sel = images[fits]
    same_detections(
        detections(build_detector(
            loaded, anchors, C, (SIZE, SIZE), device=dev,
            compute_dtype=torch.float32, mode="prefilter", box_topk=BOX_TOPK,
            **kw)(sel), len(fits)),
        detections(build_detector(
            loaded, anchors, C, (SIZE, SIZE), device=dev,
            compute_dtype=torch.float32, mode="exact", **kw)(sel), len(fits)),
        thresh, "prefilter vs exact, fp32")

    # ---- 8. timings ------------------------------------------------------
    # every timed loop before the first profiler session: CUPTI's teardown
    # after a session can hold the host's next CUDA call until the device
    # drains (utils.profiling.SETTLE_MS)
    timings, busy_ms = {}, {}
    for b, iters in ((8, 30), (128, 10)):
        images = batches[0] if b == 8 else batches[-1]
        for _ in range(3):
            det(images)
        timings[b] = call_ms(lambda: det(images), iters)
    for b in (8, 128):
        images = batches[0] if b == 8 else batches[-1]
        ms, busy = timings[b], device_busy_ms(lambda: det(images), 5)
        busy_ms[b] = busy
        print(f"packed detector batch {b}: {ms:.3f} ms/batch, "
              f"{b * 1000.0 / ms:.1f} img/s; device busy {busy:.3f} "
              f"ms/batch [{card}]")

    with torch.inference_mode():
        images = batches[-1]
        fwd_ms = call_ms(lambda: yolov3_forward_packed(
            det.packed, images, compute_dtype=torch.bfloat16), 10)
        cand_ms = call_ms(lambda: packed_candidates(
            outs, C, det.tables, SERVING["box_topk"]), 20)
        nms_ms = call_ms(lambda: nms_cuda.batched_nms_shared(
            boxes_p, scores_p, max_out=128, score_thresh=0.3,
            iou_thresh=0.45), 20)
    print(f"packed stages at batch 128: forward {fwd_ms:.3f} ms, "
          f"prefilter+decode {cand_ms:.3f} ms, batched_nms_shared "
          f"{nms_ms:.3f} ms [{card}]")

    with torch.inference_mode():
        outs8 = yolov3_forward_packed(det.packed, batches[0],
                                      compute_dtype=torch.bfloat16)
        fmaps8 = yolov3_forward_folded(pre.folded, batches[0],
                                       compute_dtype=torch.bfloat16)
        shapes = {
            "packed_b128_k64": (boxes_p, scores_p, SERVING),
            "packed_b8_k64": (*packed_candidates(
                outs8, C, det.tables, SERVING["box_topk"]), SERVING),
            "prefilter_b8_k256": (*prefilter_candidates(
                fmaps8, C, pre.tables, BOX_TOPK), DEMO)}
        del outs8, fmaps8
    k1 = shared_timing(card, shapes, busy_ms[8])
    # the record keeps the packed request at the bench batch
    kernel_ms = {"nms_shared": k1["packed_b128_k64"][:2]}
    bounds = {"nms_shared": k1["packed_b128_k64"][2]}
    library = {"nms_shared": None, "nms": None}     # no single torch call

    images = batches[0]
    for name, cfg in (("eval", EVAL), ("demo", DEMO)):
        d = exact if name == "eval" else build_detector(
            loaded, anchors, C, (SIZE, SIZE), device=dev,
            compute_dtype=torch.bfloat16, mode="exact", **cfg)
        for _ in range(3):
            d(images)
        ms = call_ms(lambda: d(images), 10)
        busy = device_busy_ms(lambda: d(images), 5)
        print(f"exact detector batch 8, {name} config (pre_topk "
              f"{cfg['pre_topk']}, score {cfg['score_thresh']}): {ms:.3f} "
              f"ms/batch, {8 * 1000.0 / ms:.1f} img/s; device busy "
              f"{busy:.3f} ms/batch [{card}]")

    with torch.inference_mode():
        fwd_ms = call_ms(lambda: yolov3_forward_folded(
            exact.folded, images, compute_dtype=torch.bfloat16), 10)
        fmaps = yolov3_forward_folded(exact.folded, images,
                                      compute_dtype=torch.bfloat16)

        def select():
            bx, cf, pr = predict_boxes(fmaps, anchors, C, (SIZE, SIZE))
            return select_per_class(bx, cf * pr, EVAL["pre_topk"],
                                    EVAL["score_thresh"])

        sel_ms = call_ms(select, 10)
        top_scores, top_boxes, valid = select()
        b, _, k = valid.shape
        gboxes, gvalid = top_boxes.reshape(b * C, k, 4), valid.reshape(b * C, k)
        k2_ms = cuda_ms(lambda: nms_cuda.nms_keep_mask(
            gboxes, gvalid, EVAL["iou_thresh"]), 20)
        keep = nms_cuda.nms_keep_mask(gboxes, gvalid,
                                      EVAL["iou_thresh"]).view(b, C, k)
        compact_ms = call_ms(lambda: compact_per_class(
            keep, top_scores, top_boxes, EVAL["max_out"]), 20)
    print(f"exact stages at batch 8, eval config: forward {fwd_ms:.3f} ms, "
          f"decode+per-class sort+gather {sel_ms:.3f} ms, nms kernel "
          f"{k2_ms:.3f} ms, compaction {compact_ms:.3f} ms [{card}]")

    k_ms, p_ms, k_runs, p_runs = in_turns(
        lambda: nms_cuda.nms_keep_mask(gboxes, gvalid, EVAL["iou_thresh"]),
        lambda: nms_cuda.nms_keep_mask_reference(gboxes, gvalid,
                                                 EVAL["iou_thresh"]), 20, 2)
    kernel_ms["nms"] = (k_ms, p_ms)
    pairs = roofline.nms_pairs(gvalid, nms_cuda.nms_keep_mask_reference(
        gboxes, gvalid, EVAL["iou_thresh"]))
    bounds["nms"] = roofline.bound_nms(b * C, k, pairs)
    print(f"nms keep masks G={b * C} K={k}: kernel {k_ms:.4f} ms (runs "
          f"{k_runs[0]:.4f}, {k_runs[1]:.4f}), plain PyTorch {p_ms:.4f} ms "
          f"(runs {p_runs[0]:.4f}, {p_runs[1]:.4f}); {pairs} IoU tests "
          f"needed, bound {bounds['nms'][0]:.4f} ms ({bounds['nms'][1]}): "
          f"{bounds['nms'][0] / k_ms * 100:.1f}% [{card}]")

    # ---- 9. probes: K3 and K4 --------------------------------------------
    peak = probe_phase(dev, card, launches, max_err, kernel_ms, bounds,
                       library)

    # ---- 10. roofline ----------------------------------------------------
    roofline_phase(dev, card, variables, timings[ROOF_BATCH], peak)

    # ---- 11. the entry points --------------------------------------------
    t0 = time.perf_counter()
    cli_phase(dev, card, variables, anchors, max_err)
    print(f"entry points: {time.perf_counter() - t0:.1f} s wall")
    check_no_jax()

    # ---- 12. training ----------------------------------------------------
    t0 = time.perf_counter()
    host_steps = train_phase(dev, card, anchors, max_err)
    print(f"training: {time.perf_counter() - t0:.1f} s wall")
    check_no_jax()

    # phases 13-16 and 19 share a temporary directory: phase 13's gate is
    # read by phases 14 and 19
    tmp_dir = tempfile.TemporaryDirectory()
    tmp = Path(tmp_dir.name)
    # ---- 13. the device data path, the gate, the checkpoint CLIs ---------
    t0 = time.perf_counter()
    gate_dir, gate_map = device_data_phase(dev, card, anchors, variables,
                                           host_steps, tmp)
    print(f"device data path, overfit gate and checkpoint CLIs: "
          f"{time.perf_counter() - t0:.1f} s wall")
    check_no_jax()

    # ---- 14. int8 serving ------------------------------------------------
    t0 = time.perf_counter()
    int8_phase(dev, card, variables, anchors, tmp, gate_dir, max_err)
    print(f"int8 serving: {time.perf_counter() - t0:.1f} s wall")
    check_no_jax()

    # ---- 15. the serving policy on CUDA ----------------------------------
    policy_phase(dev, card, tmp)
    check_no_jax()

    # ---- 16. data parallelism --------------------------------------------
    t0 = time.perf_counter()
    dp_phase(dev, card, tmp, anchors, variables, max_err)
    print(f"data parallelism: {time.perf_counter() - t0:.1f} s wall")
    check_no_jax()

    # ---- 17. the split head and the space-to-depth stem ------------------
    t0 = time.perf_counter()
    split_phase(dev, card, variables, anchors, launches, max_err)
    print(f"split head and s2d stem: {time.perf_counter() - t0:.1f} s wall")
    check_no_jax()

    # ---- 18. the measurement scripts ------------------------------------
    t0 = time.perf_counter()
    k128 = measure_phase(dev, card, launches, max_err, timings[ROOF_BATCH])
    print(f"measurement scripts: {time.perf_counter() - t0:.1f} s wall")
    check_no_jax()

    # ---- 19. the serving experiments, the analyzer, the host library ----
    t0 = time.perf_counter()
    records = experiments_phase(dev, card, tmp, gate_dir, gate_map, launches,
                                max_err, timings[ROOF_BATCH])
    print(f"serving experiments, analyzer and host library: "
          f"{time.perf_counter() - t0:.1f} s wall")
    check_no_jax()

    # ---- 20. the graft entry points ---------------------------------------
    t0 = time.perf_counter()
    entry_phase(dev, card, tmp, launches, max_err, records)
    tmp_dir.cleanup()
    print(f"the graft entry points: {time.perf_counter() - t0:.1f} s wall")
    check_no_jax()

    # ---- 21. the conv epilogue --------------------------------------------
    t0 = time.perf_counter()
    epilogue_phase(dev, card, variables, launches, max_err, kernel_ms,
                   bounds, library)
    print(f"conv epilogue: {time.perf_counter() - t0:.1f} s wall")
    check_no_jax()

    # ---- 22. YOLOv4's Mish epilogues --------------------------------------
    t0 = time.perf_counter()
    yolov4_phase(dev, card, launches, max_err, kernel_ms, bounds, library)
    print(f"YOLOv4 Mish epilogues: {time.perf_counter() - t0:.1f} s wall")
    check_no_jax()

    # ---- 23. records -----------------------------------------------------
    extra = {"nms_shared": {"p50_k128": k128}}
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches[name],
        "max_abs_err": max_err[name], "ms": kernel_ms[name][0],
        "plain_ms": kernel_ms[name][1], "bound_ms": bounds[name][0],
        "bound_by": bounds[name][1], "library_ms": library[name],
        **extra.get(name, {})}
        for name, (source, replaces) in KERNELS.items()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def exit_now(code) -> None:
    """Flush and end the process with `code` (SystemExit's meaning),
    skipping the interpreter's and the C++ runtime's exit handlers: on the
    H100 machine a process that had torn down and re-initialised CUPTI
    (utils.profiling.device_events) after NCCL and spawned CUDA ranks hung
    in them for over 10 minutes after its last line. Every process this
    script starts has ended by then."""
    if code is None:
        code = 0
    elif not isinstance(code, int):
        print(code, file=sys.stderr)
        code = 1
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)


if __name__ == "__main__":
    try:
        exit_now(main())
    except SystemExit as e:
        exit_now(e.code)
    except Exception:                   # a failed phase: its traceback, rc 1
        traceback.print_exc()
        exit_now(1)
