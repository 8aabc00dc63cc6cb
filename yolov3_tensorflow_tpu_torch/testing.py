"""Seeded inputs shared by the tests and chip_smoke.py.

`nms_cases` (shared-candidate NMS) and `per_class_cases` (per-group NMS)
are the case lists used by the CPU tests (plain versions against the JAX
kernels and the numpy oracle) and by chip_smoke.py (CUDA kernels against
their plain versions on the card). `numpy_variables` makes a
weight tree in the JAX package's layout, and `match_detections` is the
detection-identity check both use. Everything is made with numpy from a
seed, so both packages and both devices see the same bits.
`parallel_worker` is one rank of the data-parallel checks' two-process
run, importable by a spawned process.
"""

from __future__ import annotations

import hashlib
import os
from typing import Dict, List, NamedTuple

import numpy as np
import torch

from yolov3_tensorflow_tpu_torch.models.yolov3 import (BACKBONE_PLAN,
                                                       _head_input_channels,
                                                       head_plan)

IOU_T = 0.45
SCORE_T = 0.3
# PyTorch's intra-op threads in a CPU test process. The test command runs
# six processes on one machine's cores; with PyTorch's default of one thread
# a core in each, they oversubscribe the cores and a 23 s training test
# took 897 s. Each test file of the port sets it when imported.
CPU_TEST_THREADS = 2


def numpy_variables(num_classes: int, seed: int = 0) -> Dict[str, dict]:
    """A variable tree in the JAX package's layout (HWIO kernels, numpy
    fp32 leaves): glorot-uniform kernels and non-trivial BN statistics
    (gamma and var in [0.8, 1.2], beta and mean ~ N(0, 0.05)), so that BN
    folding does real work."""
    rng = np.random.default_rng(seed)
    params = {"backbone": {}, "head": {}}
    stats = {"backbone": {}, "head": {}}

    def conv(scope, name, k, cin, cout, has_bn):
        lim = np.sqrt(6.0 / (k * k * (cin + cout)))
        w = rng.uniform(-lim, lim, (k, k, cin, cout)).astype(np.float32)
        if not has_bn:
            params[scope][name] = {"w": w, "b": np.zeros(cout, np.float32)}
            return
        u = lambda: rng.uniform(0.8, 1.2, cout).astype(np.float32)  # noqa: E731
        n = lambda: rng.normal(0.0, 0.05, cout).astype(np.float32)  # noqa: E731
        params[scope][name] = {"w": w, "gamma": u(), "beta": n()}
        stats[scope][name] = {"mean": n(), "var": u()}

    cin, idx = 3, 0
    for op in BACKBONE_PLAN:
        if op[0] == "conv":
            conv("backbone", f"conv_{idx}", op[2], cin, op[1], True)
            cin, idx = op[1], idx + 1
    head_cin = _head_input_channels(num_classes)
    for i, cout, k, has_bn in head_plan(num_classes):
        conv("head", f"conv_{i}", k, head_cin[i], cout, has_bn)
    return {"params": params, "batch_stats": stats}


class NmsCase(NamedTuple):
    name: str
    boxes: np.ndarray          # [B, K, 4] float32 xyxy
    scores: np.ndarray         # [B, K, C] float32
    score_thresh: float
    iou_thresh: float


def _boxes(rng: np.random.Generator, b: int, k: int, span: float = 200.0
           ) -> np.ndarray:
    x0 = rng.uniform(0, span, (b, k))
    y0 = rng.uniform(0, span, (b, k))
    w = rng.uniform(5, 80, (b, k))
    h = rng.uniform(5, 80, (b, k))
    return np.stack([x0, y0, x0 + w, y0 + h], -1).astype(np.float32)


def _scores(rng: np.random.Generator, b: int, k: int, c: int) -> np.ndarray:
    return (rng.uniform(0, 1, (b, k, c)) ** 2).astype(np.float32)


def iou_f32(a: np.ndarray, b: np.ndarray) -> np.float32:
    """IoU of two xyxy boxes in float32, in the kernel's operation order."""
    f = np.float32
    iw = max(min(a[2], b[2]) - max(a[0], b[0]), f(0))
    ih = max(min(a[3], b[3]) - max(a[1], b[1]), f(0))
    inter = f(iw * ih)
    area_a = f((a[2] - a[0]) * (a[3] - a[1]))
    area_b = f((b[2] - b[0]) * (b[3] - b[1]))
    return f(inter / f(f(f(area_a + area_b) - inter) + f(1e-10)))


def threshold_pairs(t: float, n: int, rng: np.random.Generator
                    ) -> List[np.ndarray]:
    """n box triples whose float32 IoUs straddle t within two float32 ulps
    of t: in each [3, 4] array box 0 is the anchor, box 1 has IoU > t with
    it and box 2 (its x shifted one float32 step further) IoU <= t.
    Triple p sits at y = 100 * (p % 21), so the 21 triples of one 64-box
    image never overlap each other."""
    t32 = np.float32(t)
    tol = 2 * np.spacing(t32)
    out = []
    while len(out) < n:
        y = np.float32(100 * (len(out) % 21))
        w, h = rng.uniform(30, 60, 2).astype(np.float32)
        a = np.array([0, y, w, y + h], np.float32)
        # shifted by d along x, IoU = (w - d) / (w + d) = t
        x0 = np.float32(w * (1 - t) / (1 + t))
        xs = [x0]
        for _ in range(64):
            xs.insert(0, np.nextafter(xs[0], np.float32(-np.inf)))
            xs.append(np.nextafter(xs[-1], np.float32(np.inf)))
        shifted = [np.array([x, y, x + w, y + h], np.float32) for x in xs]
        ious = [iou_f32(a, s) for s in shifted]
        for i in range(len(ious) - 1):
            if (ious[i] > t32 >= ious[i + 1] and ious[i] - t32 <= tol
                    and t32 - ious[i + 1] <= tol):
                out.append(np.stack([a, shifted[i], shifted[i + 1]]))
                break
    return out


def bench_case(seed: int = 0) -> NmsCase:
    """Random candidates at the serving detector's NMS shape at the bench
    batch: B=128 images, K=64 candidates, C=80 classes."""
    rng = np.random.default_rng(seed)
    return NmsCase("bench_b128_k64_c80", _boxes(rng, 128, 64),
                   _scores(rng, 128, 64, 80), SCORE_T, IOU_T)


def nms_cases(batch: int, seed: int = 0) -> List[NmsCase]:
    """The kernel's case list at `batch` images per case (see module doc):
    random sets at every (K, C) in {8, 64, 256} x {6, 20, 80} and at
    (200, 20) and (1024, 6), duplicate
    scores, duplicate and zero-area boxes, all-invalid classes and images,
    and box pairs whose IoU lies within two float32 ulps of t."""
    rng = np.random.default_rng(seed)
    cases = []
    for k in (8, 64, 256):
        for c in (6, 20, 80):
            span = 60.0 if k == 8 else 200.0
            cases.append(NmsCase(f"random_k{k}_c{c}",
                                 _boxes(rng, batch, k, span),
                                 _scores(rng, batch, k, c), SCORE_T, IOU_T))

    # K = 200 leaves the last 32-candidate word of a row ragged; K = 1024,
    # the kernel's largest, needs more than 48 KB of shared memory
    for k, c in ((200, 20), (1024, 6)):
        cases.append(NmsCase(f"random_k{k}_c{c}", _boxes(rng, batch, k, 400.0),
                             _scores(rng, batch, k, c), SCORE_T, IOU_T))

    k, c = 64, 20
    s = np.round(_scores(rng, batch, k, c) * 4) / 4          # 5 score levels
    boxes = _boxes(rng, batch, k, 120.0)
    boxes[:, 32:48] = boxes[:, 0:16]                         # duplicate boxes
    cases.append(NmsCase("ties", boxes, s.astype(np.float32), 0.25, IOU_T))

    boxes = _boxes(rng, batch, k, 100.0)
    boxes[:, ::3, 2] = boxes[:, ::3, 0]                      # zero width
    boxes[:, 1::5, 3] = boxes[:, 1::5, 1]                    # zero height
    boxes[:, 40:44] = boxes[:, 0:1]                          # same degenerate box
    cases.append(NmsCase("zero_area", boxes, _scores(rng, batch, k, c),
                         SCORE_T, IOU_T))

    s = _scores(rng, batch, k, c)
    s[:, :, ::2] *= 0.25                                     # even classes < 0.25
    s[0] = 0.1                                               # image 0: nothing valid
    cases.append(NmsCase("invalid_classes", _boxes(rng, batch, k),
                         s.astype(np.float32), SCORE_T, IOU_T))

    pairs = threshold_pairs(IOU_T, batch * 21, rng)          # 63 boxes / image
    boxes = np.zeros((batch, k, 4), np.float32)
    s = np.zeros((batch, k, c), np.float32)
    for i in range(batch):
        for p in range(21):
            boxes[i, 3 * p:3 * p + 3] = pairs[i * 21 + p]
            s[i, 3 * p] = 0.9          # anchor ranks first in every class
            s[i, 3 * p + 1] = 0.8      # each shifted box is judged against it
            s[i, 3 * p + 2] = 0.7      # (and box 1 against box 2)
    s[:, :, 1::2] = rng.uniform(0, 1, (batch, k, c // 2))
    cases.append(NmsCase("iou_at_threshold", boxes, s, SCORE_T, IOU_T))
    return cases


def card_cases(seed: int = 0) -> List[NmsCase]:
    """Shared-candidate cases for the card's list only (the CPU tests'
    JAX interpret run would take too long at these sizes): random sets at
    the small packed request (B=8, K=64, C=80), the prefilter request (B=8,
    K=256, C=80) and the kernel's shared-memory edge (K=1024, C=80: the
    whole K x K mask beside a staged slice of scores); K=1024, C=160, whose
    slices are staged in two chunks; K=37 and K=130, whose keep rows are
    not whole 32-bit words; and B=300, which needs no cluster."""
    rng = np.random.default_rng(seed)
    shapes = (("packed_b8_k64_c80", 8, 64, 80, 200.0),
              ("prefilter_b8_k256_c80", 8, 256, 80, 300.0),
              ("edge_b2_k1024_c80", 2, 1024, 80, 400.0),
              ("chunked_b2_k1024_c160", 2, 1024, 160, 400.0),
              ("ragged_b3_k37_c7", 3, 37, 7, 120.0),
              ("ragged_b3_k130_c7", 3, 130, 7, 200.0),
              ("one_cta_b300_k8_c6", 300, 8, 6, 60.0))
    return [NmsCase(name, _boxes(rng, b, k, span), _scores(rng, b, k, c),
                    SCORE_T, IOU_T) for name, b, k, c, span in shapes]


class KeepCase(NamedTuple):
    name: str
    boxes: np.ndarray          # [G, K, 4] float32 xyxy, rows in rank order
    valid: np.ndarray          # [G, K] bool
    iou_thresh: float


def per_class_cases(groups: int, ks=(64, 200, 256, 1024), seed: int = 0
                    ) -> List[KeepCase]:
    """The per-group kernel's case list at `groups` (>= 2) groups per case:
    at each K in `ks` a dense random set (deep suppression chains) with
    zero-area and duplicate boxes, ~15% of the rows invalid at random (not
    a prefix) and the last group all invalid; then the three-box chain
    (a suppresses b, b would suppress c, a does not: keep a and c) at K=8,
    and at K=64 box triples whose IoUs lie within two float32 ulps of t,
    some anchors invalid."""
    rng = np.random.default_rng(seed)
    cases = []
    for k in ks:
        boxes = _boxes(rng, groups, k, span=12.0 * np.sqrt(k))
        boxes[:, 3::7, 2] = boxes[:, 3::7, 0]                # zero width
        dup = np.arange(4, k - 1, 11)
        boxes[:, dup + 1] = boxes[:, dup]                    # duplicates
        valid = rng.uniform(0, 1, (groups, k)) < 0.85
        valid[-1] = False
        cases.append(KeepCase(f"random_k{k}", boxes, valid, IOU_T))

    boxes = np.zeros((groups, 8, 4), np.float32)
    boxes[:, :3] = [[0, 0, 10, 10], [6, 0, 16, 10], [12, 0, 22, 10]]
    valid = np.zeros((groups, 8), bool)
    valid[:, :3] = True                                      # IoU(a, b) 0.25
    cases.append(KeepCase("chain", boxes, valid, 0.2))

    pairs = threshold_pairs(IOU_T, groups * 21, rng)
    boxes = np.zeros((groups, 64, 4), np.float32)
    valid = np.zeros((groups, 64), bool)
    for g in range(groups):
        for p in range(21):
            boxes[g, 3 * p:3 * p + 3] = pairs[g * 21 + p]
            # a valid anchor keeps box 2 (IoU <= t) and drops box 1; without
            # it box 1 is kept and drops box 2
            valid[g, 3 * p:3 * p + 3] = [p % 4 != 3, True, True]
    cases.append(KeepCase("iou_at_threshold", boxes, valid, IOU_T))
    return cases


def match_detections(src, dst, min_score: float):
    """Detection identity, one way. src and dst are per-image lists of
    (boxes [N, 4], scores [N], labels [N]) host arrays. Returns (n, found):
    the number of src detections scored >= min_score, and how many of them
    dst has with the same label and IoU >= 0.9."""
    n = found = 0
    for (sb, ss, sl), (db, _, dl) in zip(src, dst):
        for box, score, label in zip(sb, ss, sl):
            if score < min_score:
                continue
            n += 1
            same = db[dl == label]
            x0 = np.maximum(box[0], same[:, 0])
            y0 = np.maximum(box[1], same[:, 1])
            x1 = np.minimum(box[2], same[:, 2])
            y1 = np.minimum(box[3], same[:, 3])
            inter = np.clip(x1 - x0, 0, None) * np.clip(y1 - y0, 0, None)
            area = (box[2] - box[0]) * (box[3] - box[1])
            areas = (same[:, 2] - same[:, 0]) * (same[:, 3] - same[:, 1])
            found += bool((inter / (area + areas - inter) >= 0.9).any())
    return n, found


# The data-parallel checks' training configuration (tests/test_torch_parallel
# .py): fp32, momentum at a fixed learning rate with the per-leaf clip at
# 100 over every leaf, as the JAX package's DP test builds its optimizer.
DP_LR = 1e-3
DP_CLIP = 100.0
DP_OVERRIDES = ("model.compute_dtype=float32", "train.optimizer=momentum",
                "train.lr_type=fixed", f"train.learning_rate_init={DP_LR}",
                "train.use_warm_up=false", f"train.grad_clip_norm={DP_CLIP}")
# the sharded detectors' configuration in the same checks
SHARDED = dict(max_out=128, box_topk=64, score_thresh=SCORE_T,
               iou_thresh=IOU_T)


def tree_digest(*trees) -> str:
    """sha256 of every tensor of nested dicts, in key order: equal digests
    mean bit-equal trees."""
    h = hashlib.sha256()

    def walk(t):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k])
        else:
            h.update(t.detach().cpu().contiguous().numpy().tobytes())
    for tree in trees:
        walk(tree)
    return h.hexdigest()


def parallel_worker(rank: int, world: int, directory: str) -> None:
    """One rank of a data-parallel run over gloo on the CPU, two threads.

    Reads `directory`/inputs.pt ({"num_classes", "seed": the weights,
    numpy_variables(num_classes, seed) carried across, "images",
    "y_true": the global training batch, "reorders", "serve_images": a
    serving batch}), joins the group through a file:// rendezvous in
    `directory` and writes `directory`/rank{rank}.pt:

    - "digest", "metrics": `tree_digest` of the new params and statistics
      after one `make_dp_train_step` (DP_OVERRIDES) on this rank's rows,
      and its metrics; rank 0 also writes the new "params", "batch_stats";
    - "noise": for each of inputs["reorders"] (name -> a permutation of
      the batch: the same step mathematically), the relative distance of
      that step's updates to the step's, per leaf and in all;
    - "rows", "meters": `gather_prediction_rows` and `gather_meter_sums` of
      rank-dependent inputs, beside the local "rows_local" and
      "meters_local" (sum, count);
    - per sharded mode ("packed", "prefilter"): the sharded detector's
      whole-batch output on `serve_images` (spread-head weights, SHARDED)
      and `build_detector`'s on this rank's rows, in this process."""
    import torch.distributed as dist

    from yolov3_tensorflow_tpu_torch.config import DEFAULT_ANCHORS, load_config
    from yolov3_tensorflow_tpu_torch.evaluation.metrics import AverageMeter
    from yolov3_tensorflow_tpu_torch.models.convert import (
        from_jax_variables, spread_head)
    from yolov3_tensorflow_tpu_torch.ops.postprocess import build_detector
    from yolov3_tensorflow_tpu_torch.parallel.data_parallel import \
        make_dp_train_step
    from yolov3_tensorflow_tpu_torch.parallel.mesh import (make_data_mesh,
                                                           replicate,
                                                           shard_batch)
    from yolov3_tensorflow_tpu_torch.parallel.multihost import (
        gather_meter_sums, gather_prediction_rows, initialize_distributed)
    from yolov3_tensorflow_tpu_torch.parallel.serving import \
        make_sharded_detector
    from yolov3_tensorflow_tpu_torch.train.optimizers import (build_optimizer,
                                                              flatten)
    from yolov3_tensorflow_tpu_torch.train.schedules import fixed

    torch.set_num_threads(CPU_TEST_THREADS)
    cpu = torch.device("cpu")
    inp = torch.load(os.path.join(directory, "inputs.pt"), weights_only=True)
    c = inp["num_classes"]
    initialize_distributed(f"file://{directory}/rendezvous", world, rank,
                           device=cpu)
    out = {}
    try:
        mesh = make_data_mesh(world)
        cfg = load_config(None, DP_OVERRIDES + (f"model.num_classes={c}",)
                          ).finalize(count_files=False)
        opt = build_optimizer("momentum", fixed(DP_LR), grad_clip_norm=DP_CLIP)
        v = from_jax_variables(numpy_variables(c, seed=inp["seed"]),
                               device=cpu)
        step = make_dp_train_step(cfg, opt, mesh)

        def dp_step(order):
            state = replicate(mesh, {"params": v["params"],
                                     "batch_stats": v["batch_stats"],
                                     "opt_state": opt.init(v["params"]),
                                     "step": 0})
            return step(state, shard_batch(mesh, inp["images"][order]),
                        shard_batch(mesh, tuple(y[order]
                                                for y in inp["y_true"])))

        new, metrics = dp_step(torch.arange(inp["images"].shape[0]))
        out["digest"] = tree_digest(new["params"], new["batch_stats"])
        out["metrics"] = {k: m for k, m in metrics.items() if k != "lr"}
        if rank == 0:
            out.update(params=new["params"], batch_stats=new["batch_stats"])
        # the same step on the batch reordered: its updates' distance to
        # the step's, per leaf and in all, |u' - u| / |u| in float64
        before = flatten(v["params"])
        u = {p: t.double() - before[p].double()
             for p, t in flatten(new["params"]).items()}
        out["noise"] = {}
        for name, order in inp["reorders"].items():
            other = flatten(dp_step(torch.as_tensor(order))[0]["params"])
            du = {p: other[p].double() - before[p].double() - u[p]
                  for p in u}
            out["noise"][name] = {
                "leaves": {p: float(du[p].norm() / u[p].norm()) for p in u},
                "all": float(torch.cat([d.reshape(-1) for d in du.values()])
                             .norm() / torch.cat([x.reshape(-1) for x in
                                                  u.values()]).norm())}

        rows = [[float(100 * rank + i), 1.0 + i, 2.0, 3.5, 4.25, 0.5 + i / 64,
                 float(i % 3)] for i in range(3 * rank + 2)]
        meters = {k: AverageMeter() for k in ("total", "xy")}
        for i in range(rank + 2):
            meters["total"].update(0.1 * (rank + i + 1), 2)
            meters["xy"].update(0.3 / (rank + i + 1), 2)
        out["rows_local"] = rows
        out["meters_local"] = {k: (m.sum, m.count) for k, m in meters.items()}
        out["rows"] = gather_prediction_rows(rows)
        gather_meter_sums(meters)
        out["meters"] = {k: (m.sum, m.count, m.average)
                         for k, m in meters.items()}

        spread = spread_head(v, seed=0)
        anchors = np.asarray(DEFAULT_ANCHORS, np.float32)
        images = inp["serve_images"]
        size = tuple(images.shape[1:3])
        for mode in ("packed", "prefilter"):
            sharded = make_sharded_detector(spread, anchors, c, size, mesh,
                                            device=cpu, mode=mode, **SHARDED)
            single = dict(SHARDED, box_topk=128, pre_topk=128) \
                if mode == "prefilter" else SHARDED
            alone = build_detector(spread, anchors, c, size, device=cpu,
                                   mode=mode, **single)
            out[mode] = {"whole": sharded(images),
                         "slice": alone(shard_batch(mesh, images))}
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(directory, f"rank{rank}.pt"))
