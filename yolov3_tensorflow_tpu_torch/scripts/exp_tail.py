"""The standalone cost of the packed postprocess's tail stages
(counterpart of `scripts/exp_tail.py`).

Each stage alone, from precomputed device operands:

  gather+decode     `packed_decode` of random candidate indices [B, 64]
                    from the bf16 packed detector's outputs
  K1 keep mask      `ops.nms_cuda.nms_keep_mask_shared` on synthetic
                    boxes and sparse scores (few overlaps: sides 10-40 px,
                    scores uniform^6), K=128 and K=64
  K1 + compaction   `batched_nms_shared` at max_out 128 >= K (the
                    no-sort compaction), K=128 and K=64

JAX's one-hot MXU gather and its score transpose + activity staging have
no counterpart: the port's `torch.gather` fetches the same rows, and the
CUDA kernel reads the scores [B, K, C] in place.

  python -m yolov3_tensorflow_tpu_torch.scripts.exp_tail [--batch 128] \\
      [--size 416 416] [--iters 5,25] [--device cuda] [--out f.json]
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from yolov3_tensorflow_tpu_torch.ops.fast_postprocess import packed_decode
from yolov3_tensorflow_tpu_torch.ops.nms_cuda import (batched_nms_shared,
                                                      nms_keep_mask_shared)
from yolov3_tensorflow_tpu_torch.scripts import experiments

K = experiments.SERVING["box_topk"]                    # 64
NMS = {k: experiments.SERVING[k] for k in ("max_out", "score_thresh",
                                           "iou_thresh")}


def random_candidates(batch: int, anchors: int, device: torch.device,
                      seed: int = 0) -> torch.Tensor:
    """K random global anchor indices per image, int64 [B, K]."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, anchors, (batch, K))).to(device)


def sparse_candidates(batch: int, num_classes: int, device: torch.device,
                      k: int = 128, seed: int = 1
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """JAX exp_tail's NMS inputs: boxes [B, k, 4] at corners uniform in
    [0, 380) with sides uniform in [10, 40), scores [B, k, C] uniform^6."""
    rng = np.random.default_rng(seed)
    boxes = rng.uniform(0, 380, (batch, k, 4)).astype(np.float32)
    boxes[..., 2:] = boxes[..., :2] + rng.uniform(10, 40, (batch, k, 2))
    scores = (rng.uniform(0, 1, (batch, k, num_classes)) ** 6
              ).astype(np.float32)
    return (torch.from_numpy(boxes).to(device),
            torch.from_numpy(scores).to(device))


def main(argv: Optional[List[str]] = None) -> int:
    run = experiments.Run("exp_tail", experiments.parser(__doc__, batch=128),
                          argv)
    c = experiments.NUM_CLASSES
    _, det, _, outs = experiments.packed_setup(run.batch, run.size,
                                               run.device)
    anchors = sum(p.shape[1] * p.shape[2] * 3 for p in outs)
    cand = random_candidates(run.batch, anchors, run.device)
    st, it = NMS["score_thresh"], NMS["iou_thresh"]
    with torch.inference_mode():
        run.row("gather+decode", lambda: packed_decode(outs, cand, c,
                                                       det.tables),
                alone=True)
        boxes, scores = sparse_candidates(run.batch, c, run.device)
        for k in (boxes.shape[1], K):
            bx, sc = boxes[:, :k].contiguous(), scores[:, :k].contiguous()
            run.row(f"K1 keep mask, K={k}", lambda bx=bx, sc=sc:
                    nms_keep_mask_shared(bx, sc, st, it), nms=True,
                    alone=True)
            run.row(f"K1 + compaction, K={k}", lambda bx=bx, sc=sc:
                    batched_nms_shared(bx, sc, **NMS), nms=True, alone=True)
    run.no_counterpart("gather one-hot MXU",
                       "a TPU mechanism; torch.gather fetches the same rows")
    run.no_counterpart("transpose+act staging",
                       "the CUDA kernel reads scores [B, K, C] in place")
    return run.finish()


if __name__ == "__main__":
    raise SystemExit(main())
