"""What costs inside the packed postprocess, stage by stage? (counterpart
of `scripts/exp_topk.py`)

Each stage runs from precomputed device operands (the bf16 packed
detector's outputs on a batch, `experiments.packed_setup`):

  score only       `packed_scores` -> [B, A] fp32
  top-64 (sort)    `top_candidates` on that score: the port's default, a
                   stable sort of all A anchors (JAX's lax.top_k order)
  top-64 (topk)    `torch.topk(sorted=True)`, the counterpart of JAX's
                   approx_max_k at recall 0.95: off the TPU both give the
                   exact top-k values with ties in no fixed order
  recall 0.85/0.70 no counterpart: PyTorch has no approximate top-k
  score->top-k     the two together, as the pipeline pays them
  gather+decode    `packed_decode` of the sorted selection's candidates
  NMS alone        `ops.nms_cuda.batched_nms_shared` (K1) on synthetic
                   boxes and scores (`synthetic_candidates`, as JAX's)
  full postprocess `postprocess_packed` at the serving config

Then how many of the B*64 selected indices, and of the final detections,
differ between the two selections (index sets and detection multisets:
`torch.topk` orders ties its own way on CUDA). The sort stays the
default.

  python -m yolov3_tensorflow_tpu_torch.scripts.exp_topk [--batch 128] \\
      [--size 416 416] [--iters 5,25] [--device cuda] [--out f.json]
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from yolov3_tensorflow_tpu_torch.ops.fast_postprocess import (
    packed_decode, packed_scores, postprocess_packed, top_candidates)
from yolov3_tensorflow_tpu_torch.ops.nms_cuda import batched_nms_shared
from yolov3_tensorflow_tpu_torch.scripts import experiments

K = experiments.SERVING["box_topk"]                    # 64
NMS = {k: experiments.SERVING[k] for k in ("max_out", "score_thresh",
                                           "iou_thresh")}
SYNTH_K = 128                          # the NMS-only stage's candidates


def synthetic_candidates(batch: int, num_classes: int, device: torch.device,
                         seed: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """JAX exp_topk's NMS-only inputs: boxes [B, 128, 4] with corners
    uniform in [0, 416) and sides of 20, scores [B, 128, C] uniform^4, from
    a numpy generator seeded `seed`."""
    rng = np.random.default_rng(seed)
    boxes = rng.uniform(0, 416, (batch, SYNTH_K, 4)).astype(np.float32)
    boxes[..., 2:] = boxes[..., :2] + 20.0
    scores = (rng.uniform(0, 1, (batch, SYNTH_K, num_classes)) ** 4
              ).astype(np.float32)
    return (torch.from_numpy(boxes).to(device),
            torch.from_numpy(scores).to(device))


def topk_indices(obj: torch.Tensor, k: int) -> torch.Tensor:
    """torch.topk's selection: the k largest of each row, sorted."""
    return torch.topk(obj, k, dim=1, sorted=True).indices


def _detection_set(dets: Dict[str, torch.Tensor], i: int) -> Counter:
    valid = dets["valid"][i].cpu().numpy()
    rows = np.concatenate([dets["labels"][i][:, None].float().cpu().numpy(),
                           dets["scores"][i][:, None].cpu().numpy(),
                           dets["boxes"][i].cpu().numpy()], 1)[valid]
    return Counter(map(tuple, rows.tolist()))


def selection_differences(outs, num_classes: int, tables: torch.Tensor,
                          k: int) -> Dict[str, int]:
    """The sorted selection against torch.topk's on the same score:
    selected indices of the second not in the first (of B*k), and the
    detections (label, score, box) each pipeline finds that the other
    does not. Launches K1 twice on a GPU."""
    obj = packed_scores(outs, num_classes)
    a, b = top_candidates(obj, k), topk_indices(obj, k)
    missing = int((~(b[..., None] == a[:, None, :]).any(-1)).sum())
    da = batched_nms_shared(*packed_decode(outs, a, num_classes, tables),
                            **NMS)
    db = batched_nms_shared(*packed_decode(outs, b, num_classes, tables),
                            **NMS)
    only_a = only_b = total = 0
    for i in range(obj.shape[0]):
        sa, sb = _detection_set(da, i), _detection_set(db, i)
        only_a += sum((sa - sb).values())
        only_b += sum((sb - sa).values())
        total += sum(sa.values())
    return {"indices": int(a.numel()), "indices_differ": missing,
            "detections": total, "detections_only_sort": only_a,
            "detections_only_topk": only_b}


def main(argv: Optional[List[str]] = None) -> int:
    run = experiments.Run("exp_topk", experiments.parser(__doc__, batch=128),
                          argv)
    c = experiments.NUM_CLASSES
    _, det, _, outs = experiments.packed_setup(run.batch, run.size,
                                               run.device)
    tables = det.tables
    with torch.inference_mode():
        obj = packed_scores(outs, c)
        cand = top_candidates(obj, K)
        boxes, scores = synthetic_candidates(run.batch, c, run.device)
        run.row("score only", lambda: packed_scores(outs, c), alone=True)
        run.row(f"top-{K} stable sort (default)",
                lambda: top_candidates(obj, K), alone=True)
        run.row(f"top-{K} torch.topk (approx r.95)",
                lambda: topk_indices(obj, K), alone=True)
        for recall in ("0.85", "0.70"):
            run.no_counterpart(f"approx_max_k recall {recall}",
                               "PyTorch has no approximate top-k")
        run.row("score->top-k", lambda: top_candidates(
            packed_scores(outs, c), K), alone=True)
        run.row("gather+decode", lambda: packed_decode(outs, cand, c,
                                                       tables), alone=True)
        run.row(f"NMS alone (synthetic, K={SYNTH_K})",
                lambda: batched_nms_shared(boxes, scores, **NMS), nms=True,
                alone=True)
        run.row("full postprocess", lambda: postprocess_packed(
            outs, None, c, run.size, box_topk=K, tables=tables, **NMS),
            nms=True, alone=True)
        diff = selection_differences(outs, c, tables, K)
    print(f"torch.topk against the stable sort: {diff['indices_differ']} of "
          f"{diff['indices']} indices differ; detections: "
          f"{diff['detections_only_sort']} only with the sort, "
          f"{diff['detections_only_topk']} only with torch.topk, of "
          f"{diff['detections']}", flush=True)
    return run.finish(differences=diff, nms_calls=run.nms_calls() + 2)


if __name__ == "__main__":
    raise SystemExit(main())
