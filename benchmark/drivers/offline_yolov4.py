"""Offline batch detection with YOLOv4: `offline.py`'s closed loop of one
client over the program's YOLOv4 packed detector
(`build_detector(mode="packed", arch="yolov4")`).

Set-up draws the weights (`weights_yolov4.draw`) and a ring of distinct
batches of scenes on the device, sets the moving statistics from the
ring's first images (`weights_yolov4.settle`) and the class biases' shift
(`weights_yolov4.calibrate`), builds the detector and warms it. The window
issues batch after batch through `offline.Client`: each batch's
detections leave the device through `pack_detections` and one
non-blocking copy into pinned memory. The traced part runs under a
`spans.SpanTracer`, so the program's spans (`packed.forward` with
`yolov4.backbone` and `yolov4.neck` inside it, `packed.postprocess`) are
read from the same batches as the device trace, and the conv epilogue's
launches are counted by mode around it. The comparison: `check.py`'s
selection, NMS and `compare_detections` over the rows of the YOLOv4
reference (`reference/yolov4.py`), in float32.

Traffic keys: offline.py's.
"""

from __future__ import annotations

import inspect
import time

import numpy as np
import torch

from benchmark import (check, control, harness, scenes, spans, weights,
                       weights_yolov4)
from benchmark.drivers.offline import Client, planted, selection
from benchmark.harness import Context
from benchmark.reference import yolov4 as reference

MISH_MODES = ("mish", "mish_residual")
# the faults this loop can have: offline.py's, planted the same way
# (`offline.planted`). `benchmark.control` looks a loop's faults up by its
# name, and a cell's loop is known by name only once `harness.resolve` has
# imported it, so the entry is made here
FAULTS = control.FAULTS["offline"]
control.FAULTS.setdefault("offline_yolov4", FAULTS)


def build(ctx: Context):
    """The program's detector and the batches, on ctx.device."""
    from yolov3_tensorflow_tpu_torch.ops.postprocess import build_detector
    if "arch" not in inspect.signature(build_detector).parameters:
        raise RuntimeError("the program's build_detector takes no arch: it "
                           "cannot build YOLOv4")
    cfg, tr = ctx.config, ctx.traffic
    s = cfg["serving"]
    hw = (cfg["height"], cfg["width"])
    c = cfg["num_classes"]
    variables = weights_yolov4.draw(ctx.seed, c, ctx.device, spread=True)
    gen = weights.generator(ctx.seed, ctx.device, stream=1)
    ring = [scenes.to_rgb_float(scenes.draw(
        gen, tr["batch"], hw, num_classes=c, **tr["scene"])["images"])
        for _ in range(tr["ring"])]
    first = ring[0][:cfg["spread_calibration_images"]]
    weights_yolov4.settle(variables, first, c)
    weights_yolov4.calibrate(variables, first, cfg["anchors"], c,
                             k_select=s["box_topk"],
                             score_thresh=s["score_thresh"],
                             target=cfg["spread_valid_per_image"])
    # the reference's set-up passes above are the benchmark's: the peak
    # the run reports is the program's and the ring's
    harness.free(ctx.device)
    if ctx.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(ctx.device)
    det = build_detector(variables, np.asarray(cfg["anchors"], np.float32),
                         c, hw, device=ctx.device, mode="packed",
                         arch="yolov4", max_out=s["max_out"],
                         box_topk=s["box_topk"],
                         score_thresh=s["score_thresh"],
                         iou_thresh=s["iou_thresh"])
    return variables, det, ring


def reference_detections(variables, images: torch.Tensor, cfg: dict, *,
                         precision: str = "fp32", block: int = 8, **select):
    """`check.reference_image` of every image [N, H, W, 3] from the YOLOv4
    reference's rows, the network run in blocks of `block` images in
    float32 (TF32 off) or, for the control, in float8."""
    c = cfg["num_classes"]
    net = reference.Net(variables, c, precision=precision)
    out = []
    with torch.no_grad(), check.tf32_off():
        for i in range(0, len(images), block):
            rows = reference.flat_rows(net(images[i:i + block]),
                                       cfg["anchors"],
                                       tuple(images.shape[1:3]), c)
            out += [check.reference_image(rows["box"][j], rows["conf"][j],
                                          rows["cls"][j], **select)
                    for j in range(len(rows["box"]))]
    return out


def control_inputs(ctx: Context):
    """(weights, network inputs of the sample, selection) for the
    control, at the cell's own size."""
    variables, _, ring = build(ctx)
    return variables, ring[0][:ctx.traffic["sample"]], selection(ctx)


def _mish_launches() -> int:
    from yolov3_tensorflow_tpu_torch.ops.conv_epilogue import conv_epilogue
    by_mode = conv_epilogue.launches_by_mode
    return sum(by_mode[m] for m in MISH_MODES)


def run(ctx: Context):
    from yolov3_tensorflow_tpu_torch.ops import nms_cuda
    cfg, tr = ctx.config, ctx.traffic
    s = cfg["serving"]
    variables, det, ring = build(ctx)
    if ctx.trace:
        ctx.tracer = spans.SpanTracer()
    client = Client(planted(det, ctx.faults, cfg["num_classes"]), ring,
                    cfg["num_classes"] * s["max_out"], ctx.device,
                    ctx.tracer.span)
    nxt = client.run(0, count=tr["warm"])
    harness.sync(ctx.device)
    client.taken.clear()
    client.done_at.clear()
    setup_s = ctx.since_start()

    view = None
    harness.steady()
    t0 = time.perf_counter()
    first = nxt
    if ctx.trace:
        launches = nms_cuda.nms_keep_mask_shared.launches
        mish = _mish_launches()
        with ctx.tracer.session():
            nxt = client.run(nxt, count=tr["trace_batches"])
        traced = nxt - first
        view = {"tracer": ctx.tracer, "spans": ctx.tracer,
                "images": traced * tr["batch"], "k1_calls": traced,
                "k1_launches": nms_cuda.nms_keep_mask_shared.launches
                - launches,
                "k1_shape": (tr["batch"], s["box_topk"],
                             cfg["num_classes"]),
                "mish_launches": _mish_launches() - mish,
                "batch": tr["batch"]}
    nxt = client.run(nxt, until=t0 + ctx.seconds)
    elapsed = client.done_at[-1] - t0
    batches = len(client.taken)
    images = batches * tr["batch"]
    peak = harness.memory_peak(ctx.device)

    # the comparison, once the window has closed and the program is freed
    rng = np.random.default_rng(ctx.seed % (1 << 63))
    picks = sorted(set(rng.choice(images, size=min(tr["sample"], images),
                                  replace=False).tolist()) | {0, images - 1})
    prog = [client.taken[p // tr["batch"]][p % tr["batch"]] for p in picks]
    inputs = torch.stack([ring[((p // tr["batch"]) + first) % len(ring)]
                          [p % tr["batch"]] for p in picks])
    del det, client
    harness.free(ctx.device)
    refs = reference_detections(variables, inputs, cfg, **selection(ctx))
    got = check.compare_detections(prog, refs, margin=tr["margin"])
    for name, limit in tr["limits"].items():
        ctx.checks.add(name, got[name], limit)
    return {"metrics": {"serve_img_per_s": images / elapsed,
                        "setup_s": setup_s},
            "attempted": images, "failed": 0, "view": view,
            "memory_peak_bytes": peak, "readings": got}
