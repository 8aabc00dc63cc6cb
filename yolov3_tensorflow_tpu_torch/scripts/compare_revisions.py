"""Time the per-group NMS (K2) and tensor-core chain (K3) kernels of two
revisions of the port on one GPU, in turns, with their yardsticks.

    python -m yolov3_tensorflow_tpu_torch.scripts.compare_revisions \\
        --old DIR [--new DIR]

DIR is the root of an unpacked checkout (`git archive REV | tar -x -C
DIR`); --new defaults to the checkout this module lies in. Each turn is a
fresh process started in one revision's root, which builds that revision's
kernels from its own `csrc/` and times them through its own wrappers:

- K2 (`ops.nms_cuda.nms_keep_mask`) on the exact path's own candidates at
  the eval config (batch 8 x 80 classes = 640 groups, pre_topk 1024, score
  0.01), made once here from a seeded detector as `chip_smoke.py` makes
  them and handed to every turn in a file;
- K3 (`scripts.exp_mxu_shapes.mma_chain`) at each of the 10 stem shapes
  (M 16384, reps 64).

The turns run old, new, new, old, so that a drift of the card's clocks
falls on both. Printed beside them: the card and its power limit
(nvidia-smi), K2's inputs (valid and kept
candidates per group), each kernel's bound (`roofline.bound_nms`,
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
SIZE = 416
C = 80

# what one turn runs, in the revision's root: only functions that both
# revisions have (the wrappers, mma_operands, SHAPES, cuda_ms)
TURN = r"""
import json, sys, torch
from yolov3_tensorflow_tpu_torch.ops import nms_cuda
from yolov3_tensorflow_tpu_torch.scripts import exp_mxu_shapes as probes
from yolov3_tensorflow_tpu_torch.utils.profiling import cuda_ms
dev = torch.device("cuda", 0)
inputs = torch.load(sys.argv[1])
boxes, valid = inputs["boxes"].to(dev), inputs["valid"].to(dev)
out = {"nms_ms": cuda_ms(lambda: nms_cuda.nms_keep_mask(
    boxes, valid, inputs["iou_thresh"]), 20), "mma_ms": {}}
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
                    "iou_thresh": EVAL["iou_thresh"]}, path)
        del cand
        turns = [(which, turn(rev, path)) for which, rev in
                 (("old", args.old), ("new", args.new), ("new", args.new),
                  ("old", args.old))]

    def mean(which, get):
        vals = [get(t) for w, t in turns if w == which]
        return sum(vals) / len(vals), vals

    old, olds = mean("old", lambda t: t["nms_ms"])
    new, news = mean("new", lambda t: t["nms_ms"])
    result["nms"].update(old_ms=old, new_ms=new, old_runs=olds,
                         new_runs=news)
    print(f"nms G={g} K={k}: old {old:.4f} ms (runs {olds[0]:.4f}, "
          f"{olds[1]:.4f}), new {new:.4f} ms (runs {news[0]:.4f}, "
          f"{news[1]:.4f}): new/old {new / old:.3f}; new at "
          f"{nms_bound / new * 100:.1f}% of its bound")
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
