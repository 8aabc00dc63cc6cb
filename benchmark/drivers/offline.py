"""Offline batch detection: a closed loop of one client.

Set-up draws the weights and a ring of distinct batches of scenes on the
device, sets the detection biases' shift on the ring's first images
(`weights.calibrate`), builds the packed detector (`build_detector(mode="packed")`, BN
folded and the packed head made there) and warms it. The window issues
batch after batch; each batch's detections leave the device through
`pack_detections` and one non-blocking copy into pinned memory, and the
client reads its valid rows while the next batch runs. An image counts
once its detections are on the host.

Traffic keys: batch, ring, sample (images compared), warm (untimed
calls), trace_batches (the traced part: the window's first batches),
scene (boxes_min, boxes_max), margin, tie, iou_tie and limits (of the
comparison).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import check, harness, scenes, weights
from benchmark.harness import Context


def build(ctx: Context):
    """The program's detector and the batches, on ctx.device."""
    from yolov3_tensorflow_tpu_torch.ops.postprocess import build_detector
    cfg, tr = ctx.config, ctx.traffic
    s = cfg["serving"]
    hw = (cfg["height"], cfg["width"])
    variables = weights.draw(ctx.seed, cfg["num_classes"], ctx.device,
                             spread=True)
    gen = weights.generator(ctx.seed, ctx.device, stream=1)
    ring = [scenes.to_rgb_float(scenes.draw(
        gen, tr["batch"], hw, num_classes=cfg["num_classes"],
        **tr["scene"])["images"]) for _ in range(tr["ring"])]
    weights.calibrate(variables, ring[0][:cfg["spread_calibration_images"]],
                      cfg["anchors"], cfg["num_classes"],
                      k_select=s["box_topk"], score_thresh=s["score_thresh"],
                      target=cfg["spread_valid_per_image"])
    det = build_detector(variables, np.asarray(cfg["anchors"], np.float32),
                         cfg["num_classes"], hw, device=ctx.device,
                         mode="packed", max_out=s["max_out"],
                         box_topk=s["box_topk"],
                         score_thresh=s["score_thresh"],
                         iou_thresh=s["iou_thresh"])
    return variables, det, ring


def selection(ctx: Context) -> dict:
    """How the reference selects and suppresses, as the packed path."""
    s = ctx.config["serving"]
    return dict(k_select=s["box_topk"], k_pool=4 * s["box_topk"],
                score_thresh=s["score_thresh"], iou_thresh=s["iou_thresh"],
                tie=ctx.traffic["tie"], iou_tie=ctx.traffic["iou_tie"])


def control_inputs(ctx: Context):
    """(weights, network inputs of the sample, selection) for the
    control, at the cell's own size."""
    variables, _, ring = build(ctx)
    return variables, ring[0][:ctx.traffic["sample"]], selection(ctx)


def planted(det, faults, num_classes: int):
    """The detector with a test's fault planted underneath: in its output
    (`check.plant`) or in K1's keep masks (`check.plant_keep`)."""
    if not faults:
        return det

    def broken(images):
        from yolov3_tensorflow_tpu_torch.ops import nms_cuda
        k1 = nms_cuda.nms_keep_mask_shared

        def keep_mask(boxes, scores, score_thresh, iou_thresh):
            return check.plant_keep(k1(boxes, scores, score_thresh,
                                       iou_thresh), scores, score_thresh,
                                    faults)
        # the kernel's wrapper counts its launches on the module's name
        keep_mask.launches = k1.launches
        nms_cuda.nms_keep_mask_shared = keep_mask
        try:
            out = det(images)
        finally:
            nms_cuda.nms_keep_mask_shared = k1
            k1.launches = keep_mask.launches
        return check.plant(out, faults, num_classes)
    return broken


class Client:
    """Issues batches and takes their detections, two in flight."""

    def __init__(self, det, ring, rows: int, device, span):
        from yolov3_tensorflow_tpu_torch.ops.postprocess import \
            pack_detections
        self.det, self.ring, self.pack = det, ring, pack_detections
        self.span = span
        batch = ring[0].shape[0]
        pin = device.type == "cuda"
        self.bufs = [torch.empty((batch, rows, 7), pin_memory=pin)
                     for _ in range(2)]
        self.events = {}
        self.taken = []          # per batch: per image (boxes, scores, labels)
        self.done_at = []        # host time each batch's rows were read

    def issue(self, i: int) -> None:
        with self.span("bench.dispatch"):
            packed = self.pack(self.det(self.ring[i % len(self.ring)]))
            self.bufs[i % 2].copy_(packed, non_blocking=True)
            ev = torch.cuda.Event() if packed.is_cuda else None
            if ev is not None:
                ev.record()
            self.events[i] = ev

    def take(self, i: int) -> None:
        with self.span("bench.wait_copy"):
            ev = self.events.pop(i)
            if ev is not None:
                ev.synchronize()
        with self.span("bench.consume"):
            rows = self.bufs[i % 2].numpy()
            per_image = []
            for r in rows:
                r = r[r[:, 6] > 0.5]
                per_image.append((r[:, 0:4].copy(), r[:, 4].copy(),
                                  r[:, 5].astype(np.int64)))
            self.taken.append(per_image)
            self.done_at.append(time.perf_counter())

    def run(self, first: int, until=None, count=None) -> int:
        """Batches first, first+1, ... until the host clock passes `until`
        or `count` batches are taken; returns the next batch number."""
        i = first
        self.issue(i)
        while True:
            self.issue(i + 1)
            self.take(i)
            i += 1
            if (until is not None and time.perf_counter() >= until) or \
                    (count is not None and i - first >= count):
                break
        self.take(i)
        return i + 1


def run(ctx: Context):
    from yolov3_tensorflow_tpu_torch.ops import nms_cuda
    cfg, tr = ctx.config, ctx.traffic
    s = cfg["serving"]
    variables, det, ring = build(ctx)
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
        with ctx.tracer.session():
            nxt = client.run(nxt, count=tr["trace_batches"])
        traced = nxt - first
        view = {"tracer": ctx.tracer, "images": traced * tr["batch"],
                "k1_calls": traced,
                "k1_launches": nms_cuda.nms_keep_mask_shared.launches
                - launches,
                "k1_shape": (tr["batch"], s["box_topk"],
                             cfg["num_classes"])}
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
    refs = check.reference_detections(variables, inputs, cfg["num_classes"],
                                      cfg["anchors"], **selection(ctx))
    got = check.compare_detections(prog, refs, margin=tr["margin"])
    for name, limit in tr["limits"].items():
        ctx.checks.add(name, got[name], limit)
    return {"metrics": {"serve_img_per_s": images / elapsed,
                        "setup_s": setup_s},
            "attempted": images, "failed": 0, "view": view,
            "memory_peak_bytes": peak, "readings": got}

