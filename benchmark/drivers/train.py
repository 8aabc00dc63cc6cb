"""Training: the program's train step over a pool of seeded batches.

Set-up draws the weights and a pool of distinct batches of scenes with
their padded ground truth on the device, builds one train step
(`make_train_step` with the momentum optimizer, a fixed learning rate and
the device label encoding) and its state, and drives that step through
its first steps on the pool's first batches: they warm it up, and their
losses, the optimizer's state after step 1 and the change of every leaf
over them are what the comparison reads. The window goes on from that
same state, batch after batch in pool order; as the program's Trainer
does, the host reads the losses every `log_step` steps and otherwise
never waits on the device. A step counts once the window's last
synchronisation has seen it finish.

Traffic keys: batch, pool, check_steps, log_step, trace_steps, scene,
limits.
"""

from __future__ import annotations

import time
from typing import Dict

import torch

from benchmark import check, harness, scenes, weights
from benchmark.harness import Context
from benchmark.program import program_config
from benchmark.reference.model import (TrainStep, label_grids, leaves,
                                       nest)


TERMS = ("xy", "wh", "conf", "class")


def pool(ctx: Context, n: int) -> Dict[str, torch.Tensor]:
    """n batches of scenes: "images" float RGB [n, B, H, W, 3], "gt"
    (boxes [n, B, M, 5] xyxy + mixup weight 1, labels, mask)."""
    cfg, tr = ctx.config, ctx.traffic
    gen = weights.generator(ctx.seed, ctx.device, stream=1)
    out = {"images": [], "boxes": [], "labels": [], "mask": []}
    for _ in range(n):
        s = scenes.draw(gen, tr["batch"], (cfg["height"], cfg["width"]),
                        num_classes=cfg["num_classes"], **tr["scene"])
        out["images"].append(scenes.to_rgb_float(s["images"]))
        out["boxes"].append(torch.cat(
            [s["boxes"], s["mask"][..., None].float()], -1))
        out["labels"].append(s["labels"])
        out["mask"].append(s["mask"])
    return {k: torch.stack(v) for k, v in out.items()}


def planted(step, faults):
    """The train step with a test's fault planted underneath."""
    if not faults:
        return step

    def broken(state, images, gt):
        if "half_batch" in faults:
            half = images.shape[0] // 2
            images, gt = images[:half], tuple(g[:half] for g in gt)
        new, metrics = step(state, images, gt)
        if "unchanged_state" in faults:
            new = state
        return new, metrics
    return broken


def norms(tree) -> Dict[str, float]:
    flat = leaves(tree)
    vals = torch.stack(torch._foreach_norm(list(flat.values()))).tolist()
    return dict(zip(flat, vals))


def diff_norms(after, before) -> Dict[str, float]:
    a, b = leaves(after), leaves(before)
    return norms({k: a[k].float() - b[k].float() for k in b})


def run(ctx: Context):
    from yolov3_tensorflow_tpu_torch.train.optimizers import build_optimizer
    from yolov3_tensorflow_tpu_torch.train.schedules import fixed
    from yolov3_tensorflow_tpu_torch.train.trainer import make_train_step
    cfg, tr = ctx.config, ctx.traffic
    variables = weights.draw(ctx.seed, cfg["num_classes"], ctx.device,
                             spread=False)
    data = pool(ctx, tr["pool"])
    schedule = fixed(cfg["learning_rate"])
    opt = build_optimizer("momentum", schedule, momentum=cfg["momentum"],
                          grad_clip_norm=cfg["grad_clip_norm"])
    step = planted(make_train_step(program_config(cfg), opt, schedule,
                                   device_encode=True), ctx.faults)
    state = {"params": variables["params"],
             "batch_stats": variables["batch_stats"],
             "opt_state": opt.init(variables["params"]), "step": 0}

    def batch(i):
        i %= tr["pool"]
        return data["images"][i], (data["boxes"][i], data["labels"][i],
                                   data["mask"][i])

    # the first steps: warm-up, and what the comparison reads
    losses = []
    for i in range(tr["check_steps"]):
        state, metrics = step(state, *batch(i))
        losses.append(metrics["total"])
        if i == 0:
            trace1 = norms(state["opt_state"].get("trace", {}))
            terms1 = {k: float(metrics[k]) for k in TERMS}
            stats1 = leaves(state["batch_stats"])
    prog = {"loss": torch.stack(losses).tolist(), "trace1": trace1,
            "terms1": terms1, "stats1": stats1,
            "change": diff_norms(state["params"], variables["params"]),
            "stats": diff_norms(state["batch_stats"],
                                variables["batch_stats"])}
    setup_s = ctx.since_start()

    view = None
    done = tr["check_steps"]
    pending, finite = [], []
    harness.steady()
    t0 = time.perf_counter()

    def flush():
        with ctx.tracer.span("bench.flush"):
            if pending:
                finite.extend(torch.isfinite(torch.stack(pending)).tolist())
                pending.clear()

    def one():
        nonlocal state, done
        with ctx.tracer.span("bench.step"):
            state, metrics = step(state, *batch(done))
        pending.append(metrics["total"])
        done += 1
        if len(pending) == tr["log_step"]:
            flush()

    if ctx.trace:
        with ctx.tracer.session():
            for _ in range(tr["trace_steps"]):
                one()
            flush()
        view = {"tracer": ctx.tracer,
                "images": tr["trace_steps"] * tr["batch"]}
    while time.perf_counter() - t0 < ctx.seconds:
        one()
    flush()
    elapsed = time.perf_counter() - t0
    steps = done - tr["check_steps"]
    peak = harness.memory_peak(ctx.device)

    # the reference follows the first steps, once the program is freed
    del state, step, opt
    harness.free(ctx.device)
    ref = reference_steps(cfg, variables, batch, tr["check_steps"])
    got = compare(prog, ref)
    for name, limit in tr["limits"].items():
        ctx.checks.add(name, got[name], limit)
    ok = sum(finite)
    return {"metrics": {"train_img_per_s": ok * tr["batch"] / elapsed,
                        "setup_s": setup_s},
            "attempted": steps, "failed": steps - ok, "view": view,
            "memory_peak_bytes": peak, "readings": got}


def reference_steps(cfg: dict, variables, batch, n: int,
                    precision: str = "fp32") -> dict:
    """The reference's first n steps from the same weights on the same
    batches: each step's loss, the norms of the momentum trace and of the
    gradient after step 1, and of every leaf's change after step n."""
    ref = TrainStep(cfg, cfg["anchors"], precision=precision)
    rs = ref.init(variables)
    out = {"loss": [], "start_stats": variables["batch_stats"]}
    with check.tf32_off():
        for i in range(n):
            images, (boxes, labels, mask) = batch(i)
            grids = label_grids(boxes[..., :4], labels, mask,
                                tuple(images.shape[1:3]), cfg["num_classes"],
                                cfg["anchors"])
            rs, got, grads = ref(rs, images, grids)
            out["loss"].append(got["total"])
            if i == 0:
                out["terms1"] = {k: got[k] for k in TERMS}
                out["trace1"] = norms(rs["trace"])
                out["stats1"] = leaves(rs["batch_stats"])
                out["grad1"] = dict(zip(rs["params"], torch.stack(
                    torch._foreach_norm(list(grads))).tolist()))
    out["change"] = diff_norms(nest(rs["params"]), variables["params"])
    out["stats"] = diff_norms(rs["batch_stats"], variables["batch_stats"])
    return out


def compare(prog: dict, ref: dict) -> Dict[str, float]:
    """The readings of the first steps (see `benchmark.check`): the loss's
    relative gap at step 1 and at the worst step; for the first gradient,
    the change of the parameters and of the moving statistics, the worst
    leaf's gap and the median leaf's. Leaves whose reference gradient is
    nought to rounding are left out of the parameters' gaps. The traffic's
    `limits` say which of them a run compares."""
    skip = check.small_leaves(ref["grad1"])
    out = {"loss1_gap": check.loss_gap(prog["loss"][:1], ref["loss"][:1]),
           "loss_gap": check.loss_gap(prog["loss"], ref["loss"]),
           "stats1_gap": check.stats_gap(prog["stats1"], ref["stats1"],
                                         leaves(ref["start_stats"]))}
    for k in TERMS:
        out[f"{k}1_gap"] = check.loss_gap([prog["terms1"][k]],
                                          [ref["terms1"][k]])
    out["terms1_gap"] = max(out[f"{k}1_gap"] for k in TERMS)
    not_kernels = [k for k in ref["trace1"] if not k.endswith("/w")]
    for key, name, left_out in (("trace1", "grad", skip),
                                ("change", "change", skip),
                                ("stats", "stats", ())):
        worst, median = check.leaf_gap(prog[key], ref[key], left_out)
        out[f"{name}_gap"] = worst
        out[f"{name}_median_gap"] = median
        out[f"{name}_worst_leaves"] = check.worst_leaves(
            prog[key], ref[key], left_out)
        if key != "stats":
            out[f"{name}_w_median_gap"] = check.leaf_gap(
                prog[key], ref[key], list(left_out) + not_kernels)[1]
    return out

