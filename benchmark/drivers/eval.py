"""Evaluation: the program's eval step over a pool of seeded batches, as
`cli/evaluate.py:run_eval` drives it.

Set-up draws the weights and a pool of distinct batches of scenes, with
their label grids made by the benchmark's own encoder, and keeps them as
host arrays. The window takes batch after batch in pool order: the images
and grids go in by the program's `trainer.to_device` (pinned, without
blocking), `make_eval_step` runs the live-BN eval forward, the loss, the
decode, each class's top-k and the per-group NMS kernel K2, and
`trainer.to_host` brings the losses and detections out in one copy. An
image counts once its detections are on the host.

Traffic keys: batch, pool, sample_batches, images_a_batch, warm,
trace_batches, spread_head, scene, margin, limits.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import check, harness, scenes, weights
from benchmark.harness import Context
from benchmark.program import program_config
from benchmark.reference.model import Net, label_grids, yolo_loss


def host_pool(ctx: Context):
    """The pool as host arrays: per batch (images float32 RGB
    [B, H, W, 3], three label grids)."""
    cfg, tr = ctx.config, ctx.traffic
    hw = (cfg["height"], cfg["width"])
    gen = weights.generator(ctx.seed, ctx.device, stream=1)
    out = []
    for _ in range(tr["pool"]):
        s = scenes.draw(gen, tr["batch"], hw, num_classes=cfg["num_classes"],
                        **tr["scene"])
        grids = label_grids(s["boxes"], s["labels"], s["mask"], hw,
                            cfg["num_classes"], cfg["anchors"])
        out.append((scenes.to_rgb_float(s["images"]).cpu().numpy(),
                    tuple(g.numpy() for g in grids)))
    return out


def selection(ctx: Context) -> dict:
    """How the reference selects and suppresses, as the exact path: each
    class's top-k, then NMS, at most max_out kept a class."""
    e = ctx.config["eval"]
    return dict(k_select=0, k_pool=0, per_class_topk=e["pre_topk"],
                max_out=e["max_out"], score_thresh=e["score_thresh"],
                iou_thresh=e["iou_thresh"])


def control_inputs(ctx: Context):
    """(weights, network inputs of one batch, selection) for the
    control, at the cell's own size."""
    variables = weights.draw(ctx.seed, ctx.config["num_classes"],
                             ctx.device, spread=ctx.traffic["spread_head"])
    images = torch.from_numpy(host_pool(ctx)[0][0]).to(ctx.device)
    return variables, images, selection(ctx)


def planted(step, faults, num_classes):
    """The eval step with a test's fault planted underneath."""
    if not faults:
        return step

    def broken(state, images, y_true):
        losses, dets = step(state, images, y_true)
        return losses, check.plant(dets, faults, num_classes)
    return broken


def run(ctx: Context):
    from yolov3_tensorflow_tpu_torch.ops import nms_cuda
    from yolov3_tensorflow_tpu_torch.train.trainer import (make_eval_step,
                                                           to_device,
                                                           to_host)

    cfg, tr = ctx.config, ctx.traffic
    dev = ctx.device
    variables = weights.draw(ctx.seed, cfg["num_classes"], dev,
                             spread=tr["spread_head"])
    data = host_pool(ctx)
    step = planted(make_eval_step(program_config(cfg)), ctx.faults,
                   cfg["num_classes"])
    state = {"params": variables["params"],
             "batch_stats": variables["batch_stats"]}
    taken, losses = [], []

    def one(i):
        images, grids = data[i % len(data)]
        with ctx.tracer.span("bench.step"):
            got, dets = step(state, to_device(images, dev),
                             tuple(to_device(g, dev) for g in grids))
        with ctx.tracer.span("bench.copy_out"):
            got, dets = to_host(got, dets)
        with ctx.tracer.span("bench.consume"):
            per_image = []
            for n in range(dets["valid"].shape[0]):
                v = dets["valid"][n].astype(bool)
                per_image.append((dets["boxes"][n][v], dets["scores"][n][v],
                                  dets["labels"][n][v].astype(np.int64)))
            taken.append(per_image)
            losses.append(float(got["total"]))

    for i in range(tr["warm"]):
        one(i)
    harness.sync(dev)
    taken.clear()
    losses.clear()
    setup_s = ctx.since_start()

    view = None
    first = done = tr["warm"]
    harness.steady()
    t0 = time.perf_counter()
    if ctx.trace:
        launches = nms_cuda.nms_keep_mask.launches
        with ctx.tracer.session():
            for _ in range(tr["trace_batches"]):
                one(done)
                done += 1
        view = {"tracer": ctx.tracer,
                "images": tr["trace_batches"] * tr["batch"],
                "k2_calls": tr["trace_batches"],
                "k2_launches": nms_cuda.nms_keep_mask.launches - launches,
                "k2_batches": [(first + j) % len(data)
                               for j in range(tr["trace_batches"])]}
    while time.perf_counter() - t0 < ctx.seconds:
        one(done)
        done += 1
    elapsed = time.perf_counter() - t0
    batches = done - first
    peak = harness.memory_peak(dev)
    del step, state
    harness.free(dev)

    # the comparison: a seeded sample of the window's batches, the loss of
    # each and a sample of its images' detections (the first and the last
    # batch among them)
    rng = np.random.default_rng(ctx.seed % (1 << 63))
    picks = sorted(set(rng.choice(batches, size=min(tr["sample_batches"],
                                                    batches),
                                  replace=False).tolist())
                   | {0, batches - 1})
    select = selection(ctx)
    prog, refs, loss_gaps = [], [], []
    net = Net(variables, cfg["num_classes"])
    with torch.no_grad(), check.tf32_off():
        for p in picks:
            images, grids = data[(first + p) % len(data)]
            maps = net(torch.from_numpy(images).to(dev))
            loss_gaps.append(check.loss_gap([losses[p]],
                                            [batch_loss(maps, grids, cfg)]))
            some = sorted(rng.choice(len(images), replace=False, size=min(
                tr["images_a_batch"], len(images))).tolist())
            refs += check.detections_of_maps([m[some] for m in maps],
                                             cfg["anchors"], **select)
            prog += [taken[p][i] for i in some]
        if view is not None:
            view["k2_pairs"] = k2_pairs(net, data, view["k2_batches"], cfg,
                                        dev)
    got = check.compare_detections(prog, refs, margin=tr["margin"])
    got["loss_gap"] = max(loss_gaps)
    for name, limit in tr["limits"].items():
        ctx.checks.add(name, got[name], limit)
    return {"metrics": {"eval_img_per_s": batches * tr["batch"] / elapsed,
                        "setup_s": setup_s},
            "attempted": batches * tr["batch"], "failed": 0, "view": view,
            "memory_peak_bytes": peak, "readings": got}


def batch_loss(maps, grids, cfg) -> float:
    """The recipe's loss of a batch's reference maps against its host
    grids."""
    return float(yolo_loss(maps, [torch.from_numpy(g) for g in grids],
                           cfg["anchors"], cfg["num_classes"],
                           (8 * maps[2].shape[1], 8 * maps[2].shape[2]),
                           label_smooth=cfg["use_label_smooth"],
                           focal=cfg["use_focal_loss"])["total"])


def control_loss_gap(ctx: Context, variables) -> float:
    """The loss's relative gap of the control (the reference in float8)
    against the reference, on the pool's first batch."""
    images, grids = host_pool(ctx)[0]
    x = torch.from_numpy(images).to(ctx.device)
    with torch.no_grad(), check.tf32_off():
        ref, low = (batch_loss(Net(variables, ctx.config["num_classes"],
                                   precision=p)(x), grids, ctx.config)
                    for p in ("fp32", "fp8"))
    return check.loss_gap([low], [ref])


def k2_pairs(net, data, which, cfg, dev):
    """The IoU tests a greedy NMS needs on each traced batch's K2 groups
    (`costs.nms_pairs`), from the reference's own per-class candidates:
    [(groups, K, pairs)] a batch."""
    from benchmark import costs
    from benchmark.reference.model import flat_rows, greedy_nms_sorted
    e = cfg["eval"]
    out = []
    for i in which:
        images, _ = data[i]
        x = torch.from_numpy(images).to(dev)
        rows = flat_rows(net(x), cfg["anchors"], tuple(x.shape[1:3]))
        scores = (torch.sigmoid(rows["conf"])[..., None]
                  * torch.sigmoid(rows["cls"])).transpose(1, 2)  # [N, C, A]
        k = min(e["pre_topk"], scores.shape[2])
        top_s, top = torch.sort(scores, dim=2, descending=True, stable=True)
        top_s, top = top_s[..., :k].flatten(0, 1), top[..., :k]
        boxes = torch.stack([rows["box"][n][top[n]]
                             for n in range(len(top))]).flatten(0, 1)
        keep = greedy_nms_sorted(boxes, top_s, e["score_thresh"],
                                 e["iou_thresh"])
        out.append((len(top_s), k, costs.nms_pairs(
            top_s >= e["score_thresh"], keep)))
    return out
