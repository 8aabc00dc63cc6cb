"""Streamed detection: an open loop of single-frame requests.

Set-up draws the weights and a pool of uint8 BGR frames on the device,
copies the frames to pinned host memory, builds the streaming detector
(`build_streaming_detector(mode="prefilter", bgr_input=True)`: the copy,
the flip, the letterbox, the folded forward, the prefilter and K1 in one
call) and warms it. Arrivals follow a fixed schedule drawn from the
traffic's own seed, so that every run faces the same arrivals: Poisson at
`calm_factor` x rate, broken by bursts at `burst_factor` x rate that take
`burst_share` of the time with exponential lengths of mean `burst_mean_s`
(the mean rate is `rate`). The run's seed draws the weights and which
frame each request sends. One serving thread takes the requests in
arrival order: it waits for a request's due time, calls the detector and
copies its detections to the host. A request's latency runs from its due
time to its detections on the host, so a request that waits behind a
slow one counts the wait.

Traffic keys: src_hw, frames, rate, calm_factor, burst_factor,
burst_share, burst_mean_s, schedule_seed, warm, trace_seconds, sample,
margin, limits.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import check, harness, scenes, weights
from benchmark.harness import Context
from benchmark.reference.model import letterbox


def schedule(tr: Dict, seconds: float) -> np.ndarray:
    """Due times in [0, seconds), the same for every run of this
    traffic and length."""
    rng = np.random.default_rng(tr["schedule_seed"])
    share = tr["burst_share"]
    calm_mean = (tr["burst_mean_s"] * (1 - share) / share if share
                 else float("inf"))
    t, burst, out = 0.0, False, []
    while t < seconds:
        length = rng.exponential(tr["burst_mean_s"] if burst else calm_mean)
        end = min(t + length, seconds)
        rate = tr["rate"] * (tr["burst_factor"] if burst
                             else tr["calm_factor"])
        u = t + rng.exponential(1.0 / rate)
        while u < end:
            out.append(u)
            u += rng.exponential(1.0 / rate)
        t, burst = end, not burst and share > 0
    return np.asarray(out)


def build(ctx: Context):
    from yolov3_tensorflow_tpu_torch.ops.preprocess import \
        build_streaming_detector
    cfg, tr = ctx.config, ctx.traffic
    s = cfg["serving"]
    src = tuple(tr["src_hw"])
    variables = weights.draw(ctx.seed, cfg["num_classes"], ctx.device,
                             spread=True)
    gen = weights.generator(ctx.seed, ctx.device, stream=1)
    frames = scenes.draw(gen, tr["frames"], src,
                         num_classes=cfg["num_classes"], boxes_min=1,
                         boxes_max=8)["images"]
    host = frames.cpu().pin_memory() if ctx.device.type == "cuda" \
        else frames.cpu()
    n = cfg["spread_calibration_images"]
    weights.calibrate(variables, letterbox(
        frames[:n], (cfg["height"], cfg["width"]), bgr=True),
        cfg["anchors"], cfg["num_classes"], k_select=tr["box_topk"],
        score_thresh=s["score_thresh"], target=cfg["spread_valid_per_image"])
    det, _ = build_streaming_detector(
        variables, np.asarray(cfg["anchors"], np.float32),
        cfg["num_classes"], src, (cfg["height"], cfg["width"]),
        device=ctx.device, max_out=s["max_out"],
        score_thresh=s["score_thresh"], iou_thresh=s["iou_thresh"],
        bgr_input=True, mode="prefilter")
    return variables, det, host


def selection(ctx: Context) -> dict:
    """How the reference selects and suppresses, as the prefilter path."""
    s, k = ctx.config["serving"], ctx.traffic["box_topk"]
    return dict(k_select=k, k_pool=4 * k, score_thresh=s["score_thresh"],
                iou_thresh=s["iou_thresh"])


def control_inputs(ctx: Context):
    """(weights, network inputs of the sample, selection) for the
    control, at the cell's own size."""
    variables, _, frames = build(ctx)
    inputs = letterbox(frames[:ctx.traffic["sample"]].to(ctx.device),
                       (ctx.config["height"], ctx.config["width"]), bgr=True)
    return variables, inputs, selection(ctx)


def planted(det, faults, num_classes: int):
    """The detector with a test's fault planted underneath (half the
    requests answered empty; a label moved to the next class)."""
    if not faults:
        return det
    calls = [0]

    def broken(frames):
        calls[0] += 1
        return check.plant(det(frames), faults, num_classes,
                           drop=slice(None) if calls[0] % 2 else slice(0))
    return broken


class Server:
    """One serving thread: waits for each due time, serves, records."""

    def __init__(self, det, frames, span):
        from yolov3_tensorflow_tpu_torch.ops.postprocess import \
            pack_detections
        self.det, self.frames, self.pack = det, frames, pack_detections
        self.span = span
        self.latency: List[float] = []
        self.call: List[float] = []
        self.wait: List[float] = []
        self.rows: List[tuple] = []
        self.failed = 0

    def serve(self, frame: int, due: float) -> None:
        with self.span("bench.idle_wait"):
            ahead = due - time.perf_counter()
            if ahead > 0.002:
                time.sleep(ahead - 0.001)
            while time.perf_counter() < due:
                pass
        start = time.perf_counter()
        try:
            with self.span("bench.request"):
                out = self.pack(self.det(self.frames[frame][None]))
                r = out[0].cpu().numpy()
        except RuntimeError:
            self.failed += 1
            self.latency.append(float("inf"))
            self.rows.append(None)
            return
        done = time.perf_counter()
        r = r[r[:, 6] > 0.5]
        self.rows.append((r[:, 0:4], r[:, 4], r[:, 5].astype(np.int64)))
        self.latency.append(done - due)
        self.call.append(done - start)
        self.wait.append(start - due)


def run(ctx: Context):
    cfg, tr = ctx.config, ctx.traffic
    variables, det, frames = build(ctx)
    due = schedule(tr, ctx.seconds)
    pick = np.random.default_rng(ctx.seed % (1 << 63)).integers(
        tr["frames"], size=len(due))
    broken = planted(det, ctx.faults, cfg["num_classes"])
    warm = Server(broken, frames, ctx.tracer.span)
    for i in range(tr["warm"]):
        warm.serve(i % tr["frames"], time.perf_counter())
    harness.sync(ctx.device)
    server = Server(broken, frames, ctx.tracer.span)
    setup_s = ctx.since_start()

    view = None
    harness.steady()
    t0 = time.perf_counter() + 0.05
    i = 0
    if ctx.trace:
        with ctx.tracer.session():
            while i < len(due) and due[i] < tr["trace_seconds"]:
                server.serve(pick[i], t0 + due[i])
                i += 1
        view = {"tracer": ctx.tracer, "requests": i}
    for j in range(i, len(due)):
        server.serve(pick[j], t0 + due[j])
    peak = harness.memory_peak(ctx.device)
    del det, broken, warm.det, server.det
    harness.free(ctx.device)

    # the comparison: a sample of the requests, the last among them
    done = [k for k, r in enumerate(server.rows) if r is not None]
    rng = np.random.default_rng(ctx.seed % (1 << 63) + 1)
    picks = sorted(set(rng.choice(done, size=min(tr["sample"], len(done)),
                                  replace=False).tolist()) | {done[-1]})
    inputs = letterbox(frames[pick[picks]].to(ctx.device),
                       (cfg["height"], cfg["width"]), bgr=True)
    refs = check.reference_detections(variables, inputs, cfg["num_classes"],
                                      cfg["anchors"], **selection(ctx))
    got = check.compare_detections([server.rows[k] for k in picks], refs,
                                   margin=tr["margin"])
    got["failed_share"] = server.failed / max(len(due), 1)
    for name, limit in tr["limits"].items():
        ctx.checks.add(name, got[name], limit)
    lat_ms = 1e3 * np.asarray(server.latency)
    if view is not None:
        view["call_ms"] = 1e3 * np.asarray(server.call)
    n = len(due)
    fifth = max(n // 5, 1)
    return {"metrics": {"serve_p95_ms": float(np.percentile(lat_ms, 95)),
                        "setup_s": setup_s},
            "attempted": n, "failed": server.failed, "view": view,
            "memory_peak_bytes": peak, "readings": got,
            "load": {"requests": n,
                     "p50_ms": float(np.percentile(lat_ms, 50)),
                     "p95_ms": float(np.percentile(lat_ms, 95)),
                     "call_p50_ms": float(np.median(server.call)) * 1e3,
                     "wait_first_ms": 1e3 * float(np.mean(
                         server.wait[:fifth])),
                     "wait_last_ms": 1e3 * float(np.mean(
                         server.wait[-fifth:]))}}
