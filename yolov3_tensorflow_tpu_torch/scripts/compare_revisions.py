"""Time the NMS kernels (K1, K2) and the tensor-core chain (K3) of two
revisions of the port on one GPU, in turns, with their yardsticks.

    python -m yolov3_tensorflow_tpu_torch.scripts.compare_revisions \\
        --old DIR [--new DIR]

DIR is the root of an unpacked checkout (`git archive REV | tar -x -C
DIR`); --new defaults to the checkout this module lies in. Each turn is a
fresh process started in one revision's root, which builds that revision's
kernels from its own `csrc/` and times them through its own wrappers:

- K1 (`ops.nms_cuda.nms_keep_mask_shared`) on the candidates of the three
  requests that reach it: a packed request at batch 128 and at batch 8
  (K=64, serving config) and a prefilter request at batch 8 (K=256,
  `box_topk` 256, demo config), made once here from a seeded detector as
  `chip_smoke.py` makes them;
- K2 (`ops.nms_cuda.nms_keep_mask`) on the exact path's own candidates at
  the eval config (batch 8 x 80 classes = 640 groups, pre_topk 1024, score
  0.01), made the same way;
- K3 (`scripts.exp_mxu_shapes.mma_chain`) at each of the 10 stem shapes
  (M 16384, reps 64).

Every kernel time is device time: `utils.profiling.cuda_ms` holds the
stream until every timed call is queued. For K1, each turn also reads the
kernel's own duration from torch.profiler, the time of the same calls
timed without the hold (CUDA events around back-to-back calls) and the
host's time per call over them, and the launch floor: an empty kernel
(`torch.cuda._sleep(0)`) timed the same ways.

The turns run old, new, new, old, so that a drift of the card's clocks
falls on both. Printed beside them: the card and its power limit
(nvidia-smi), K1's and K2's inputs (valid and kept candidates per class or
group), each kernel's bound (`roofline.bound_nms_shared`, `bound_nms`,
`bound_mma_chain`: published H100 peaks) and, for K3, `reps` back-to-back
`torch.mm` on its operands (`exp_mxu_shapes.library_ms`). The last line is
one JSON object with every number.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Dict

import torch

ROOT = Path(__file__).resolve().parents[2]
EVAL = dict(pre_topk=1024, score_thresh=0.01, iou_thresh=0.45)
SERVING = dict(max_out=128, box_topk=64, score_thresh=0.3, iou_thresh=0.45)
DEMO = dict(max_out=200, pre_topk=256, score_thresh=0.3, iou_thresh=0.45)
BOX_TOPK = 256                    # prefilter candidates per image
REQUESTS = (8, 8, 8, 128, 128)    # chip_smoke.py's draws from seed 1
SIZE = 416
C = 80

# what one turn runs, in the revision's root: only functions that both
# revisions have (the wrappers, mma_operands, SHAPES, cuda_ms)
TURN = r"""
import json, sys, time, torch
from yolov3_tensorflow_tpu_torch.ops import nms_cuda
from yolov3_tensorflow_tpu_torch.scripts import exp_mxu_shapes as probes
from yolov3_tensorflow_tpu_torch.utils.profiling import cuda_ms
dev = torch.device("cuda", 0)

def unheld_ms(fn, iters):
    # events around back-to-back calls, the stream not held: host gaps
    # count; and the host's own time per call
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    host = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, host

def profiled_ms(fn, iters, match):
    # the kernel's own mean duration, from torch.profiler's device events
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    spans = [e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and match in e.name]
    return sum(spans) / len(spans) / 1e3 if spans else None

inputs = torch.load(sys.argv[1])
boxes, valid = inputs["boxes"].to(dev), inputs["valid"].to(dev)
out = {"nms_ms": cuda_ms(lambda: nms_cuda.nms_keep_mask(
    boxes, valid, inputs["iou_thresh"]), 20), "mma_ms": {}, "shared": {}}
sleep0 = lambda: torch.cuda._sleep(0)
out["floor"] = {"ms": cuda_ms(sleep0, 200), "kernel_ms": profiled_ms(
    sleep0, 100, "spin")}
out["floor"]["unheld_ms"], out["floor"]["host_ms"] = unheld_ms(sleep0, 200)
for name, case in inputs["shared"].items():
    bx, sc = case["boxes"].to(dev), case["scores"].to(dev)
    fn = lambda: nms_cuda.nms_keep_mask_shared(bx, sc, case["score_thresh"],
                                               case["iou_thresh"])
    r = out["shared"][name] = {"ms": cuda_ms(fn, 200),
                               "kernel_ms": profiled_ms(fn, 100, "nms_shared")}
    r["unheld_ms"], r["host_ms"] = unheld_ms(fn, 200)
for name, k, n in probes.SHAPES:
    a, b = probes.mma_operands(probes.M_TOTAL, k, n, dev)
    out["mma_ms"][name.strip()] = cuda_ms(
        lambda: probes.mma_chain(a, b, probes.REPS), 30)
print(json.dumps(out))
"""


def eval_candidates(device: torch.device) -> Dict[str, torch.Tensor]:
    """K2's inputs on the exact path at the eval config: a seeded detector
    (torch.Generator seed 0 plus spread_head) on 8 images drawn from a
    device generator of seed 1, as chip_smoke.py draws its first request.
    Returns boxes [640, 1024, 4], valid [640, 1024] and the plain keep
    mask."""
    import numpy as np
    from yolov3_tensorflow_tpu_torch.config import DEFAULT_ANCHORS
    from yolov3_tensorflow_tpu_torch.models.convert import spread_head
    from yolov3_tensorflow_tpu_torch.models.decode import predict_boxes
    from yolov3_tensorflow_tpu_torch.models.yolov3 import (
        fold_batch_norm, init_yolov3, yolov3_forward_folded)
    from yolov3_tensorflow_tpu_torch.ops.nms import select_per_class
    from yolov3_tensorflow_tpu_torch.ops.nms_cuda import \
        nms_keep_mask_reference
    anchors = np.asarray(DEFAULT_ANCHORS, np.float32)
    variables = spread_head(
        init_yolov3(torch.Generator().manual_seed(0), C, device=device),
        seed=0)
    folded = fold_batch_norm(variables, torch.bfloat16)
    gen = torch.Generator(device=device).manual_seed(1)
    images = torch.rand((8, SIZE, SIZE, 3), generator=gen, device=device)
    with torch.inference_mode():
        fmaps = yolov3_forward_folded(folded, images,
                                      compute_dtype=torch.bfloat16)
        boxes, confs, probs = predict_boxes(fmaps, anchors, C, (SIZE, SIZE))
        _, top_boxes, valid = select_per_class(
            boxes, confs * probs, EVAL["pre_topk"], EVAL["score_thresh"])
        b, _, k = valid.shape
        boxes = top_boxes.reshape(b * C, k, 4).contiguous()
        valid = valid.reshape(b * C, k).contiguous()
        keep = nms_keep_mask_reference(boxes, valid, EVAL["iou_thresh"])
    return {"boxes": boxes, "valid": valid, "keep": keep}


def shared_candidates(device: torch.device) -> Dict[str, Dict]:
    """K1's inputs on the paths that launch it, from the same seeded
    detector: the packed detector (serving config) on chip_smoke.py's last
    batch-128 and first batch-8 request, and the prefilter detector (demo
    config, box_topk 256, bf16) on the first batch-8 request. Returns, per
    shape name, boxes [B, K, 4], scores [B, K, C], the thresholds and the
    plain keep mask [B, C, K]."""
    import numpy as np
    from yolov3_tensorflow_tpu_torch.config import DEFAULT_ANCHORS
    from yolov3_tensorflow_tpu_torch.models.convert import spread_head
    from yolov3_tensorflow_tpu_torch.models.yolov3 import (
        init_yolov3, yolov3_forward_folded)
    from yolov3_tensorflow_tpu_torch.ops.fast_postprocess import (
        packed_candidates, prefilter_candidates, yolov3_forward_packed)
    from yolov3_tensorflow_tpu_torch.ops.nms_cuda import \
        nms_keep_mask_shared_reference
    from yolov3_tensorflow_tpu_torch.ops.postprocess import build_detector
    anchors = np.asarray(DEFAULT_ANCHORS, np.float32)
    variables = spread_head(
        init_yolov3(torch.Generator().manual_seed(0), C, device=device),
        seed=0)
    gen = torch.Generator(device=device).manual_seed(1)
    batches = [torch.rand((b, SIZE, SIZE, 3), generator=gen, device=device)
               for b in REQUESTS]
    det = build_detector(variables, anchors, C, (SIZE, SIZE), device=device,
                         compute_dtype=torch.bfloat16, mode="packed",
                         **SERVING)
    pre = build_detector(variables, anchors, C, (SIZE, SIZE), device=device,
                         compute_dtype=torch.bfloat16, mode="prefilter",
                         box_topk=BOX_TOPK, **DEMO)
    out = {}
    with torch.inference_mode():
        for name, images in (("packed_b128_k64", batches[-1]),
                             ("packed_b8_k64", batches[0])):
            outs = yolov3_forward_packed(det.packed, images,
                                         compute_dtype=torch.bfloat16)
            out[name] = dict(zip(("boxes", "scores"), packed_candidates(
                outs, C, det.tables, SERVING["box_topk"])), **{
                    k: SERVING[k] for k in ("score_thresh", "iou_thresh")})
        fmaps = yolov3_forward_folded(pre.folded, batches[0],
                                      compute_dtype=torch.bfloat16)
        out["prefilter_b8_k256"] = dict(zip(("boxes", "scores"),
                                            prefilter_candidates(
            fmaps, C, pre.tables, BOX_TOPK)), **{
                k: DEMO[k] for k in ("score_thresh", "iou_thresh")})
        for case in out.values():
            case["boxes"] = case["boxes"].contiguous()
            case["scores"] = case["scores"].contiguous()
            case["keep"] = nms_keep_mask_shared_reference(
                case["boxes"], case["scores"], case["score_thresh"],
                case["iou_thresh"])
    return out


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def turn(rev: Path, inputs: Path) -> Dict:
    """One revision's timings, in a fresh process in its root."""
    env = dict(os.environ, PYTHONPATH=str(rev))
    out = subprocess.run([sys.executable, "-c", TURN, str(inputs)],
                         cwd=rev, env=env, capture_output=True, text=True,
                         timeout=900)
    if out.returncode != 0:
        raise RuntimeError(f"the turn in {rev} failed:\n{out.stderr[-4000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def main(argv=None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--old", type=Path, required=True,
                   help="root of the older revision's checkout")
    p.add_argument("--new", type=Path, default=ROOT,
                   help="root of the newer revision's checkout")
    args = p.parse_args(argv)
    from yolov3_tensorflow_tpu_torch.scripts import exp_mxu_shapes as probes
    from yolov3_tensorflow_tpu_torch.scripts import roofline
    dev = probes._gpu(None)
    result = {"card": card()}
    print(f"card: {result['card']}")

    cand = eval_candidates(dev)
    valid, keep = cand["valid"], cand["keep"]
    g, k = valid.shape
    nv, nk = valid.sum(1).float(), keep.sum(1).float()
    pairs = roofline.nms_pairs(valid, keep)
    nms_bound, nms_by = roofline.bound_nms(g, k, pairs)
    result.update({"nms": {"groups": g, "k": k,
                      "valid_mean": float(nv.mean()),
                      "valid_max": int(nv.max()),
                      "kept_mean": float(nk.mean()), "kept_max": int(nk.max()),
                      "pairs": pairs, "bound_ms": nms_bound,
                      "bound_by": nms_by}, "mma": {}})
    print(f"nms eval-shape inputs G={g} K={k}: valid per group mean "
          f"{float(nv.mean()):.1f} max {int(nv.max())}; kept per group mean "
          f"{float(nk.mean()):.1f} max {int(nk.max())}; {pairs} IoU tests "
          f"needed; bound {nms_bound:.4f} ms ({nms_by})")

    shared = shared_candidates(dev)
    result["shared"] = {}
    for name, case in shared.items():
        bsz, kk, c = case["scores"].shape
        counts = roofline.shared_counts(case["scores"], case.pop("keep"),
                                        case["score_thresh"])
        bound, by = roofline.bound_nms_shared(bsz, kk, c)
        result["shared"][name] = dict(counts, b=bsz, k=kk, c=c,
                                      bound_ms=bound, bound_by=by)
        print(f"nms_shared {name} B={bsz} K={kk} C={c}: valid per class mean "
              f"{counts['valid_mean']:.2f} max {counts['valid_max']}; kept "
              f"per class mean {counts['kept_mean']:.2f} max "
              f"{counts['kept_max']}; {counts['empty_classes']} of "
              f"{counts['classes']} classes have no valid candidate; bound "
              f"{bound:.4f} ms ({by})")

    out_dtype = probes.library_out_dtype(dev)
    print(f"library yardstick: {probes.REPS} x torch.mm, output "
          f"{str(out_dtype).replace('torch.', '')}")
    for name, kk, n in probes.SHAPES:
        a, b = probes.mma_operands(probes.M_TOTAL, kk, n, dev)
        bound, _ = roofline.bound_mma_chain(probes.M_TOTAL, kk, n,
                                            probes.REPS)
        result["mma"][name.strip()] = {
            "k": kk, "n": n, "bound_ms": bound,
            "library_ms": probes.library_ms(a, b, probes.REPS, out_dtype)}

    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "nms_inputs.pt"
        torch.save({"boxes": cand["boxes"].cpu(), "valid": valid.cpu(),
                    "iou_thresh": EVAL["iou_thresh"],
                    "shared": {name: {k: v.cpu() if torch.is_tensor(v) else v
                                      for k, v in case.items()}
                               for name, case in shared.items()}}, path)
        del cand, shared
        turns = [(which, turn(rev, path)) for which, rev in
                 (("old", args.old), ("new", args.new), ("new", args.new),
                  ("old", args.old))]

    def mean(which, get):
        vals = [get(t) for w, t in turns if w == which]
        if None in vals:             # the profiler saw no such kernel
            return float("nan"), vals
        return sum(vals) / len(vals), vals

    old, olds = mean("old", lambda t: t["nms_ms"])
    new, news = mean("new", lambda t: t["nms_ms"])
    result["nms"].update(old_ms=old, new_ms=new, old_runs=olds,
                         new_runs=news)
    print(f"nms G={g} K={k}: old {old:.4f} ms (runs {olds[0]:.4f}, "
          f"{olds[1]:.4f}), new {new:.4f} ms (runs {news[0]:.4f}, "
          f"{news[1]:.4f}): new/old {new / old:.3f}; new at "
          f"{nms_bound / new * 100:.1f}% of its bound")
    for which in ("old", "new"):
        floors = [t["floor"] for w, t in turns if w == which]
        result[f"{which}_floor"] = floors
        print(f"launch floor ({which} turns), torch.cuda._sleep(0): "
              + "; ".join(f"held {f['ms']:.4f} ms, unheld "
                          f"{f['unheld_ms']:.4f} ms, profiler "
                          f"{f['kernel_ms'] or float('nan'):.4f} ms, host "
                          f"{f['host_ms']:.4f} ms"
                          for f in floors))
    for name, r in result["shared"].items():
        for key in ("ms", "unheld_ms", "kernel_ms", "host_ms"):
            for which in ("old", "new"):
                val, vals = mean(which, lambda t: t["shared"][name][key])
                r[f"{which}_{key}"], r[f"{which}_{key}_runs"] = val, vals
        print(f"nms_shared {name}: old {r['old_ms']:.4f} ms (runs "
              f"{r['old_ms_runs'][0]:.4f}, {r['old_ms_runs'][1]:.4f}), new "
              f"{r['new_ms']:.4f} ms (runs {r['new_ms_runs'][0]:.4f}, "
              f"{r['new_ms_runs'][1]:.4f}): new/old "
              f"{r['new_ms'] / r['old_ms']:.3f}; profiler old "
              f"{r['old_kernel_ms']:.4f} new {r['new_kernel_ms']:.4f} ms; "
              f"unheld old {r['old_unheld_ms']:.4f} new "
              f"{r['new_unheld_ms']:.4f} ms; host per call old "
              f"{r['old_host_ms']:.4f} new {r['new_host_ms']:.4f} ms; new at "
              f"{r['bound_ms'] / r['new_ms'] * 100:.1f}% of its bound")
    for name, r in result["mma"].items():
        old, olds = mean("old", lambda t: t["mma_ms"][name])
        new, news = mean("new", lambda t: t["mma_ms"][name])
        flop = 2.0 * probes.M_TOTAL * r["k"] * r["n"] * probes.REPS
        r.update(old_ms=old, new_ms=new, old_runs=olds, new_runs=news)
        tf = lambda ms: flop / (ms * 1e-3) / 1e12  # noqa: E731
        print(f"mma_rate {name:<16s} K={r['k']:4d} N={r['n']:3d}: old "
              f"{old:.4f} ms {tf(old):6.1f} TF/s, new {new:.4f} ms "
              f"{tf(new):6.1f} TF/s, torch.mm {r['library_ms']:.4f} ms "
              f"{tf(r['library_ms']):6.1f} TF/s; bound {r['bound_ms']:.4f} "
              f"ms, new at {r['bound_ms'] / new * 100:.1f}%")
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
