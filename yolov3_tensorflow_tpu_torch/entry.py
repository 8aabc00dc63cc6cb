"""The graft entry points: the serving program and the multi-device dry run
(counterpart of the JAX repository's `__graft_entry__.py`).

- `entry(device)` returns `(fn, example_args)`: the flagship serving
  program, BN-folded COCO-80 YOLOv3-416 inference in bf16 (the packed
  forward, the anchor decode and the shared-candidate NMS kernel), and a
  batch of 8 zero images. `make_entry_fn(variables, device)` builds the
  same program from any variable tree of this package.
- `dryrun_multichip(n_devices, device)` spawns `n_devices` ranks and runs,
  at the JAX function's tiny shapes (64^2, 4 classes, one image a rank),
  one data-parallel train step, one data-parallel step with the device
  augmentation and label encoding in it, and the batch-sharded serving
  detector, whose confident detections must reproduce the single-device
  detector's. Ranks rendezvous through a file in a fresh temporary
  directory: NCCL with a card a rank, gloo where ranks share a card or run
  on the CPU.

Both run on CUDA unless the caller asks for the CPU (`device="cpu"`):
asking for CUDA where there is none raises. The seed-0 weights come from
this package's `init_yolov3`, which cannot draw JAX's random stream; a
test passes JAX's own tree through `make_entry_fn`.

    python -m yolov3_tensorflow_tpu_torch.entry [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import tempfile
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from yolov3_tensorflow_tpu_torch.config import DEFAULT_ANCHORS

NUM_CLASSES = 80
SIZE = (416, 416)
EXAMPLE_BATCH = 8
# the serving configuration of the JAX entry point
SERVING = dict(max_out=128, box_topk=64, score_thresh=0.3, iou_thresh=0.45)

# dryrun_multichip: the JAX function's shapes and thresholds
DRY_CLASSES = 4
DRY_SIZE = 64
DRY_SERVE_THRESH = 0.25
CONFIDENT = 0.27      # detections straddling the threshold jitter in bf16
FOUND_SHARE = 0.99


def _device(device) -> torch.device:
    """`device` (default CUDA) as a torch.device; CUDA without a card
    raises: the entry points never fall back to the CPU on their own."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device}: no CUDA device is available "
                           f"(pass device='cpu' to run on the CPU)")
    return device


def make_entry_fn(variables: Dict[str, Any], device,
                  compute_dtype: torch.dtype = torch.bfloat16
                  ) -> Callable[[torch.Tensor], Dict[str, torch.Tensor]]:
    """The serving program on `variables` (this package's COCO-80 tree,
    on any device): BN folded in `compute_dtype`, the packed head, then
    per call `yolov3_forward_packed` and `postprocess_packed` at SERVING
    on 416^2 images [B, 416, 416, 3] float on `device`. Returns the JAX
    contract's dict: "boxes" [B, 80*128, 4] fp32, "scores" [B, 10240]
    fp32, "labels" [B, 10240] int32, "valid" [B, 10240] bool. On CUDA
    each call launches the shared-candidate NMS kernel once."""
    from yolov3_tensorflow_tpu_torch.models.yolov3 import fold_batch_norm
    from yolov3_tensorflow_tpu_torch.ops.fast_postprocess import (
        decode_tables, pack_serving_head, postprocess_packed,
        yolov3_forward_packed)
    from yolov3_tensorflow_tpu_torch.ops.postprocess import variables_on
    device = _device(device)
    anchors = np.asarray(DEFAULT_ANCHORS, np.float32)
    packed = pack_serving_head(
        fold_batch_norm(variables_on(variables, device), dtype=compute_dtype),
        NUM_CLASSES)
    tables = decode_tables(SIZE, anchors, device=device)

    def fn(images: torch.Tensor) -> Dict[str, torch.Tensor]:
        with torch.inference_mode():
            outs = yolov3_forward_packed(packed, images,
                                         compute_dtype=compute_dtype)
            return postprocess_packed(outs, anchors, NUM_CLASSES, SIZE,
                                      tables=tables, **SERVING)

    return fn


def entry(device=None) -> Tuple[Callable, Tuple[torch.Tensor]]:
    """(fn, example_args): the serving program (`make_entry_fn`) on the
    seed-0 COCO-80 YOLOv3 (`init_yolov3(torch.Generator().manual_seed(0))`)
    and a batch of 8 zero 416^2 images, both on `device` (default CUDA)."""
    from yolov3_tensorflow_tpu_torch.models.yolov3 import init_yolov3
    device = _device(device)
    variables = init_yolov3(torch.Generator().manual_seed(0), NUM_CLASSES,
                            device=device)
    example = (torch.zeros((EXAMPLE_BATCH, *SIZE, 3), dtype=torch.float32,
                           device=device),)
    return make_entry_fn(variables, device), example


def dry_inputs(n: int) -> Dict[str, np.ndarray]:
    """The dry run's global batch, as the JAX function draws it: n uniform
    64^2 images from default_rng(0), their label grids (one box in cell
    (0, 0), anchor 0, class 0, of every scale), the BGR uint8 tiles, plan
    parameters and padded ground truth of the device-data step."""
    size, c = DRY_SIZE, DRY_CLASSES
    rng = np.random.default_rng(0)
    images = rng.uniform(0, 1, (n, size, size, 3)).astype(np.float32)
    out = {"images": images}
    for i, s in enumerate((32, 16, 8)):
        g = size // s
        yt = np.zeros((n, g, g, 3, 6 + c), np.float32)
        yt[..., -1] = 1.0
        yt[:, 0, 0, 0, 0:4] = [16, 16, 12, 12]
        yt[:, 0, 0, 0, 4] = 1.0
        yt[:, 0, 0, 0, 5] = 1.0
        out[f"y_true{i}"] = yt
    out["staged"] = np.ascontiguousarray(
        (images * 255.0).astype(np.uint8)[:, :, :, ::-1])
    out.update({
        "lam": np.full((n,), 0.7, np.float32),
        "color": np.tile(np.asarray([4.0, 3.0, 1.1, 0.9], np.float32),
                         (n, 1)),
        "crop": np.tile(np.asarray([0, 0, size, size], np.int32), (n, 1)),
        "rect": np.tile(np.asarray([0, 0, size, size], np.int32), (n, 1)),
        "interp": np.ones((n,), np.int32),
        "flip": np.zeros((n,), np.int32)})
    gt_boxes = np.zeros((n, 8, 5), np.float32)
    gt_boxes[:, 0] = [10, 10, 22, 22, 1.0]
    gt_mask = np.zeros((n, 8), bool)
    gt_mask[:, 0] = True
    out.update(gt_boxes=gt_boxes, gt_labels=np.zeros((n, 8), np.int32),
               gt_mask=gt_mask)
    return out


def reproduced(ref: Dict[str, np.ndarray], dets: Dict[str, np.ndarray]
               ) -> Tuple[int, int]:
    """(found, total): the JAX dry run's rule. Every detection of `ref`
    scored at least CONFIDENT counts in total; it is found when `dets`
    has one of the same image with the same label, every box coordinate
    within 1 px and the score within 5e-3."""
    found = total = 0
    for i in range(ref["valid"].shape[0]):
        ve, va = ref["valid"][i].astype(bool), dets["valid"][i].astype(bool)
        boxes, labels, scores = (dets[k][i][va]
                                 for k in ("boxes", "labels", "scores"))
        for bx, lb, sc in zip(ref["boxes"][i][ve], ref["labels"][i][ve],
                              ref["scores"][i][ve]):
            if sc < CONFIDENT:
                continue
            total += 1
            found += bool(np.any(
                (labels == lb)
                & (np.abs(boxes - bx).max(axis=1) < 1.0)
                & (np.abs(scores - sc) < 5e-3)))
    return found, total


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def _dry_rank(rank: int, world: int, directory: str, device_type: str
              ) -> None:
    """One rank of `dryrun_multichip` (a spawned process). Writes
    rank{rank}.json: its shared-candidate kernel launches, the kernel's
    largest difference from its plain version and, on rank 0, the
    result."""
    import torch.distributed as dist

    from yolov3_tensorflow_tpu_torch.config import Config
    from yolov3_tensorflow_tpu_torch.models.yolov3 import init_yolov3
    from yolov3_tensorflow_tpu_torch.ops import nms_cuda
    from yolov3_tensorflow_tpu_torch.ops.fast_postprocess import (
        packed_candidates, yolov3_forward_packed)
    from yolov3_tensorflow_tpu_torch.ops.nms_cuda import batched_nms_shared
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
    from yolov3_tensorflow_tpu_torch.train.optimizers import build_optimizer
    from yolov3_tensorflow_tpu_torch.train.schedules import fixed

    dev = initialize_distributed(f"file://{directory}/rendezvous", world,
                                 rank, device=torch.device(device_type))
    try:
        backend = dist.get_backend()
        cfg = Config()
        cfg.model.num_classes = DRY_CLASSES
        cfg.finalize(count_files=False)
        mesh = make_data_mesh(world)
        variables = init_yolov3(torch.Generator().manual_seed(0),
                                DRY_CLASSES, device=dev)
        optimizer = build_optimizer("momentum", fixed(1e-3),
                                    grad_clip_norm=100.0)
        state = replicate(mesh, {
            "params": variables["params"],
            "batch_stats": variables["batch_stats"],
            "opt_state": optimizer.init(variables["params"]), "step": 0})
        inp = {k: torch.from_numpy(v) for k, v in dry_inputs(world).items()}

        def mine(*keys):
            return tuple(shard_batch(mesh, inp[k]).to(dev) for k in keys)

        dp_step = make_dp_train_step(cfg, optimizer, mesh)
        state, metrics = dp_step(state, *mine("images"),
                                 mine("y_true0", "y_true1", "y_true2"))
        loss = float(metrics["total"])
        _check(bool(np.isfinite(loss)), f"non-finite loss in dryrun: {loss}")
        if rank == 0:
            print(f"dryrun_multichip({world}): ok, loss={loss:.4f}",
                  flush=True)

        # the device-resident data path in the step: staged BGR tiles and
        # plan parameters augmented, padded ground truth encoded, per rank
        cfg.data.use_mix_up = True
        cfg.data.use_color_distort = True
        dp_step_aug = make_dp_train_step(cfg, optimizer, mesh,
                                         device_augment=True,
                                         device_encode=True)
        staged, = mine("staged")
        aug = dict(zip(("lam", "color", "crop", "rect", "interp", "flip"),
                       mine("lam", "color", "crop", "rect", "interp",
                            "flip")))
        state, metrics = dp_step_aug(
            state, (staged, staged, aug),
            mine("gt_boxes", "gt_labels", "gt_mask"),
            out_size=(DRY_SIZE, DRY_SIZE))
        loss_aug = float(metrics["total"])
        _check(bool(np.isfinite(loss_aug)),
               f"non-finite device-augment loss: {loss_aug}")
        if rank == 0:
            print(f"dryrun_multichip({world}): device-augment step ok, "
                  f"loss={loss_aug:.4f}", flush=True)
        del state

        # the batch-sharded serving detector against the single-device
        # detector on the whole batch, on the plain keep mask as JAX's
        # reference runs off its kernel (use_pallas=False)
        anchors = np.asarray(DEFAULT_ANCHORS, np.float32)
        serve = init_yolov3(torch.Generator().manual_seed(3), DRY_CLASSES,
                            device=dev)
        images = inp["images"].to(dev)
        kw = dict(mode="packed", box_topk=64, score_thresh=DRY_SERVE_THRESH)
        nms_cuda.nms_keep_mask_shared.launches = 0
        sharded = make_sharded_detector(serve, anchors, DRY_CLASSES,
                                        (DRY_SIZE, DRY_SIZE), mesh,
                                        device=dev, **kw)
        dets = {k: v.cpu().numpy() for k, v in sharded(images).items()}
        launches = nms_cuda.nms_keep_mask_shared.launches
        _check(dets["boxes"].shape[0] == world,
               f"sharded serving returned {dets['boxes'].shape[0]} images "
               f"for {world}")
        _check(bool(np.isfinite(dets["boxes"]).all()
                    and np.isfinite(dets["scores"]).all()),
               "non-finite sharded detections")
        single = build_detector(serve, anchors, DRY_CLASSES,
                                (DRY_SIZE, DRY_SIZE), device=dev,
                                max_out=128, **kw)
        with torch.inference_mode():
            boxes, scores = packed_candidates(
                yolov3_forward_packed(single.packed, images,
                                      compute_dtype=single.compute_dtype),
                DRY_CLASSES, single.tables, single.box_topk)
            ref = batched_nms_shared(
                boxes, scores, max_out=single.max_out,
                score_thresh=single.score_thresh,
                iou_thresh=single.iou_thresh,
                keep_mask=nms_cuda.nms_keep_mask_shared_reference)
            # the kernel against its plain version on this rank's
            # candidates, outside the launches counted above
            mine_b, mine_s = shard_batch(mesh, (boxes, scores))
            args = (mine_b, mine_s, single.score_thresh, single.iou_thresh)
            err = float((nms_cuda.nms_keep_mask_shared(*args).float()
                         - nms_cuda.nms_keep_mask_shared_reference(
                             *args).float()).abs().max())
        _check(err == 0.0, f"nms_shared differs from its plain version on "
                           f"rank {rank}'s candidates by {err}")
        found, total = reproduced({k: v.cpu().numpy()
                                   for k, v in ref.items()}, dets)
        _check(total > 0, "serving dryrun produced no confident detections")
        _check(found >= FOUND_SHARE * total,
               f"sharded serving diverged from single-device: "
               f"{found}/{total}")
        record: Dict[str, Any] = {"nms_shared_launches": launches,
                                  "nms_shared_max_err": err}
        if rank == 0:
            print(f"dryrun_multichip({world}): sharded serving step ok, "
                  f"{found}/{total} detections reproduced", flush=True)
            record["result"] = {"loss": loss, "loss_aug": loss_aug,
                                "found": found, "total": total,
                                "backend": backend}
    finally:
        dist.destroy_process_group()
    Path(directory, f"rank{rank}.json").write_text(json.dumps(record))


def dryrun_multichip(n_devices: int, device=None) -> Dict[str, Any]:
    """Spawn `n_devices` ranks (each on a card of this host, round robin,
    on `device`'s type: default CUDA) and run the dry run's three steps
    (see the module docstring) in each; a rank that fails fails the call.
    Returns rank 0's {"loss", "loss_aug", "found", "total", "backend"},
    "nms_shared_launches", the shared-candidate kernel's launches in the
    sharded detector summed over the ranks (one a rank; 0 on the CPU),
    and "nms_shared_max_err", the largest difference of that kernel from
    its plain version on any rank's candidates (0, or the rank raises)."""
    import torch.multiprocessing as mp
    device = _device(device)
    if n_devices < 1:
        raise ValueError(f"dryrun_multichip needs n_devices >= 1, got "
                         f"{n_devices}")
    with tempfile.TemporaryDirectory(prefix="dryrun_") as directory:
        mp.start_processes(_dry_rank, args=(n_devices, directory, device.type),
                           nprocs=n_devices, join=True, start_method="spawn")
        records = [json.loads(Path(directory, f"rank{r}.json").read_text())
                   for r in range(n_devices)]
    return {**records[0]["result"],
            "nms_shared_launches": sum(r["nms_shared_launches"]
                                       for r in records),
            "nms_shared_max_err": max(r["nms_shared_max_err"]
                                      for r in records)}


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda; cpu to run without a card)")
    args = p.parse_args(argv)
    device = _device(args.device)
    fn, example = entry(device)
    out = fn(*example)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    print("entry: ok", {k: tuple(v.shape) for k, v in out.items()},
          flush=True)
    dryrun_multichip(torch.cuda.device_count() if device.type == "cuda"
                     else 1, device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
