#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: build, check, serve, time.

Run from the repository root, on a machine with a CUDA GPU:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the last line:

1. checks: a CUDA device is present; prints the card's name and power limit
   (nvidia-smi) and the toolchain.
2. build: compiles all four kernels (csrc/nms_shared.cu, csrc/nms.cu,
   csrc/mma_rate.cu and csrc/patch_build.cu) from the sources in this
   checkout, one nvcc each, started together; prints the build time and
   ptxas's register and spill lines, and the HGMMA and HMMA instruction
   counts of the tensor-core chain's library (cuobjdump -sass): it must run
   on wgmma (HGMMA) and hold no mma.sync (HMMA).
3. kernels against their plain versions, bit for bit: the shared-candidate
   kernel on the case list of yolov3_tensorflow_tpu_torch.testing.nms_cases
   (random sets at K in {8, 64, 256} x C in {6, 20, 80}, K=200 and K=1024,
   ties, zero-area boxes, all-invalid classes, IoU within 2 ulps of t) and
   the bench shape B=128, K=64, C=80; the per-group kernel on
   testing.per_class_cases (dense random sets at K in {64, 200, 256, 1024}
   with random validity and an all-invalid group, the three-box chain, IoU
   within 2 ulps of t).
4. packed path: build_detector(mode="packed") at COCO-80, 416x416, bf16,
   with the serving config (max_out 128, box_topk 64, score 0.3, iou 0.45)
   on seeded random weights plus the spread head, answers 3 requests at
   batch 8 and 2 at batch 128. Outputs must be finite and of the right
   shape, every image must have detections, the shared-candidate kernel
   must have launched once per request, and on the last request's
   candidates its keep masks must equal the plain version's. Then the fp32
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
   detector at batch 8 in both configs and its stages at the eval config;
   beside each detector's ms per batch, the device's busy time per batch
   (utils.profiling.device_busy_ms, torch.profiler): the difference is
   time the device waited for the host;
   each kernel against its plain version on its path's own candidates
   (B=128, K=64, C=80; G=640, K=1024), timed twice in turns.
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
11. prints the kernel record and the device record as JSON; the last line
   is {"ok": true, "device": {...}}. Each kernel's record carries its bound
   (scripts/roofline.py: the published H100 SXM peaks, from this run's
   inputs: K2 counts the IoU tests its candidates need) and its library
   yardstick's ms (null where no single PyTorch call computes the same
   function).
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

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
}
K3_RTOL = 1e-4                         # max|kernel - plain| / max|plain|
K3_RATIO = (1.7, 2.3)                  # time(2 x reps) / time(reps)
K3_RECORD = "ctrl 512x512"             # K3's shape in the kernel record
K4_RECORD = 128                        # K4's width in the kernel record
ROOF_BATCH = 128                       # batch of the roofline and profile


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


def in_turns(kernel, plain, kernel_iters: int, plain_iters: int):
    """Kernel and plain version timed twice each, in turns (plain, kernel,
    kernel, plain). Returns (kernel ms, plain ms, kernel runs, plain
    runs)."""
    kernel(), plain()
    runs = {"kernel": [], "plain": []}
    for name, fn, iters in (("plain", plain, plain_iters),
                            ("kernel", kernel, kernel_iters),
                            ("kernel", kernel, kernel_iters),
                            ("plain", plain, plain_iters)):
        runs[name].append(cuda_ms(fn, iters))
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
    from yolov3_tensorflow_tpu_torch.ops.fast_postprocess import (
        packed_candidates, yolov3_forward_packed)
    from yolov3_tensorflow_tpu_torch.ops.nms import (compact_per_class,
                                                     select_per_class)
    from yolov3_tensorflow_tpu_torch.ops.postprocess import build_detector
    from yolov3_tensorflow_tpu_torch.scripts import roofline
    from yolov3_tensorflow_tpu_torch.testing import (bench_case, nms_cases,
                                                     per_class_cases)
    from yolov3_tensorflow_tpu_torch.utils import kernels
    from yolov3_tensorflow_tpu_torch.utils.profiling import device_busy_ms
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
    libs = kernels.build_kernels(*KERNELS)
    print(f"build {', '.join(KERNELS)} (one nvcc each, in parallel): "
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
    cases = nms_cases(batch=16, seed=1) + [bench_case(seed=2)]
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
                         compute_dtype=torch.bfloat16, **SERVING)
    gen = torch.Generator(device=dev).manual_seed(1)
    batches = [torch.rand((b, SIZE, SIZE, 3), generator=gen, device=dev)
               for b in REQUESTS]
    torch.cuda.synchronize()

    nms_cuda.nms_keep_mask_shared.launches = 0
    nms_cuda.nms_keep_mask.launches = 0
    results = []
    t0 = time.perf_counter()
    for images in batches:
        results.append(det(images))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches["nms_shared"] = nms_cuda.nms_keep_mask_shared.launches
    check_requests(results, REQUESTS, SERVING["max_out"], "packed")
    print(f"packed: served {len(REQUESTS)} requests ({sum(REQUESTS)} images) "
          f"in {wall:.3f} s wall, first calls included; nms_shared launches "
          f"{launches['nms_shared']}, nms launches "
          f"{nms_cuda.nms_keep_mask.launches}")
    check(launches["nms_shared"] == len(REQUESTS),
          f"nms_shared launched {launches['nms_shared']} times for "
          f"{len(REQUESTS)} requests")

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
                         compute_dtype=torch.float32, **SERVING)(small)
    c32 = build_detector(variables, anchors, C, (SIZE, SIZE), device=cpu,
                         compute_dtype=torch.float32, **SERVING)(small.cpu())
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
    timings = {}
    for b, iters in ((8, 30), (128, 10)):
        images = batches[0] if b == 8 else batches[-1]
        for _ in range(3):
            det(images)
        ms = cuda_ms(lambda: det(images), iters)
        timings[b] = ms
        busy = device_busy_ms(lambda: det(images), 5)
        print(f"packed detector batch {b}: {ms:.3f} ms/batch, "
              f"{b * 1000.0 / ms:.1f} img/s; device busy {busy:.3f} "
              f"ms/batch [{card}]")

    with torch.inference_mode():
        images = batches[-1]
        fwd_ms = cuda_ms(lambda: yolov3_forward_packed(
            det.packed, images, compute_dtype=torch.bfloat16), 10)
        cand_ms = cuda_ms(lambda: packed_candidates(
            outs, C, det.tables, SERVING["box_topk"]), 20)
        nms_ms = cuda_ms(lambda: nms_cuda.batched_nms_shared(
            boxes_p, scores_p, max_out=128, score_thresh=0.3,
            iou_thresh=0.45), 20)
    print(f"packed stages at batch 128: forward {fwd_ms:.3f} ms, "
          f"prefilter+decode {cand_ms:.3f} ms, batched_nms_shared "
          f"{nms_ms:.3f} ms [{card}]")

    k_ms, p_ms, k_runs, p_runs = in_turns(
        lambda: nms_cuda.nms_keep_mask_shared(boxes_p, scores_p, 0.3, 0.45),
        lambda: nms_cuda.nms_keep_mask_shared_reference(boxes_p, scores_p,
                                                        0.3, 0.45), 200, 5)
    kernel_ms = {"nms_shared": (k_ms, p_ms)}
    bounds = {"nms_shared": roofline.bound_nms_shared(*scores_p.shape)}
    library = {"nms_shared": None, "nms": None}     # no single torch call
    print(f"nms_shared keep masks B=128 K=64 C=80: kernel {k_ms:.4f} ms "
          f"(runs {k_runs[0]:.4f}, {k_runs[1]:.4f}), plain PyTorch "
          f"{p_ms:.4f} ms (runs {p_runs[0]:.4f}, {p_runs[1]:.4f}); bound "
          f"{bounds['nms_shared'][0]:.4f} ms ({bounds['nms_shared'][1]}): "
          f"{bounds['nms_shared'][0] / k_ms * 100:.1f}% [{card}]")

    images = batches[0]
    for name, cfg in (("eval", EVAL), ("demo", DEMO)):
        d = exact if name == "eval" else build_detector(
            loaded, anchors, C, (SIZE, SIZE), device=dev,
            compute_dtype=torch.bfloat16, mode="exact", **cfg)
        for _ in range(3):
            d(images)
        ms = cuda_ms(lambda: d(images), 10)
        busy = device_busy_ms(lambda: d(images), 5)
        print(f"exact detector batch 8, {name} config (pre_topk "
              f"{cfg['pre_topk']}, score {cfg['score_thresh']}): {ms:.3f} "
              f"ms/batch, {8 * 1000.0 / ms:.1f} img/s; device busy "
              f"{busy:.3f} ms/batch [{card}]")

    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: yolov3_forward_folded(
            exact.folded, images, compute_dtype=torch.bfloat16), 10)
        fmaps = yolov3_forward_folded(exact.folded, images,
                                      compute_dtype=torch.bfloat16)

        def select():
            bx, cf, pr = predict_boxes(fmaps, anchors, C, (SIZE, SIZE))
            return select_per_class(bx, cf * pr, EVAL["pre_topk"],
                                    EVAL["score_thresh"])

        sel_ms = cuda_ms(select, 10)
        top_scores, top_boxes, valid = select()
        b, _, k = valid.shape
        gboxes, gvalid = top_boxes.reshape(b * C, k, 4), valid.reshape(b * C, k)
        k2_ms = cuda_ms(lambda: nms_cuda.nms_keep_mask(
            gboxes, gvalid, EVAL["iou_thresh"]), 20)
        keep = nms_cuda.nms_keep_mask(gboxes, gvalid,
                                      EVAL["iou_thresh"]).view(b, C, k)
        compact_ms = cuda_ms(lambda: compact_per_class(
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
    check_no_jax()

    # ---- 11. records -----------------------------------------------------
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches[name],
        "max_abs_err": max_err[name], "ms": kernel_ms[name][0],
        "plain_ms": kernel_ms[name][1], "bound_ms": bounds[name][0],
        "bound_by": bounds[name][1], "library_ms": library[name]}
        for name, (source, replaces) in KERNELS.items()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
