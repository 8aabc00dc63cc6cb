"""The program's spans on the device trace's clock, for the per-layer
metrics that read them.

The program marks its layers with `utils.profiling.annotate` spans
(`packed.forward`, `packed.postprocess`, `train_step` and its five
children). They cost nothing until `utils.profiling.recording()` opens;
inside it each span records a CUDA event on the stream at entry and at
exit, and the host clock beside each. `SpanTracer` is `trace.Tracer` with
that recording open through the traced calls: the profiler records the
device alone, as before, and after the session each span's events are
placed on the trace's device clock (from the CUDA event that completes as
the first marker spin starts), its host stamps on the same clock beside
the harness's `bench.*` ranges (so `trace.breakdown` names an idle gap by
the program span around it).

The drivers trace their window with the plain `Tracer`. So `traced` runs
the cell's loop once more after the run, under a `SpanTracer`: the
driver's own `run` on a copy of the run's context with a window of no
seconds, the offline comparison cut to the fewest images the driver
takes, and its checks kept apart from the run's. The traced part itself
(batch, traced batches or steps, inputs from the same seed, the warm-up
before it) is the run's. A program without `recording` (an older checkout)
gives None, and every reader of a span then reads nothing.
"""

from __future__ import annotations

import contextlib
import copy
import os
import time
from typing import List, Optional, Tuple

from benchmark import harness
from benchmark.trace import GUARD_MS, MARK_MS, SPIN_KERNEL, Tracer, marked

# (name, device start us, device end us, host start us, host end us), all
# on the trace's device clock
SpanEvent = Tuple[str, float, float, float, float]

# what the replay of the traced part changes in the cell's traffic: the
# comparison's cost, never the traced part or what comes before it (the
# train cell's check steps are its warm-up: after one, the replayed steps
# ran 5-13% slower on the H100)
CHEAP_CHECK = {"offline": {"sample": 1}, "train": {}}


class SpanTracer(Tracer):
    """A Tracer whose sessions record the program's spans: after a
    session, `spans` holds each closed span as a SpanEvent, in the order
    the spans were entered, and `host` holds their host ranges beside the
    harness's. `device`, `window` and `window_s` are the Tracer's: the
    same guard spin, marker spins and rescale (`trace.marked`).

    The Tracer places host ranges by its guard spin, which starts as it is
    launched on an idle device; but in a process that has already traced
    once, CUPTI often dropped the guard's own activity (9 of 11 later
    sessions of the train cell on the H100), and the Tracer then fails.
    Here the host clock is tied to a CUDA event recorded on the idle
    device before the guard instead, and the spin only opens the
    session."""

    def __init__(self):
        super().__init__()
        self.spans: List[SpanEvent] = []

    @contextlib.contextmanager
    def session(self):
        import torch

        from yolov3_tensorflow_tpu_torch.utils import profiling
        idle, start, end = (torch.cuda.Event(enable_timing=True)
                            for _ in range(3))
        before = os.environ.get("TEARDOWN_CUPTI")
        os.environ["TEARDOWN_CUPTI"] = "1"
        self._spans = []
        try:
            # opened before the profiler: the recording's pool of events is
            # first recorded here (each timed record holds the stream ~3 us
            # on the H100), not in the window
            with profiling.recording() as rec:
                torch.cuda.synchronize()
                with torch.profiler.profile(
                        activities=[torch.profiler.ProfilerActivity.CUDA]
                ) as prof:
                    t_idle = time.perf_counter()
                    idle.record()
                    torch.cuda._sleep(int(GUARD_MS * 2e6))
                    start.record()
                    torch.cuda._sleep(int(MARK_MS * 2e6))
                    yield self
                    torch.cuda._sleep(int(MARK_MS * 2e6))
                    end.record()
                    torch.cuda.synchronize()
                    until = time.perf_counter() + GUARD_MS / 1e3
                    while time.perf_counter() < until:
                        pass
        finally:
            host, self._spans = self._spans, None
            if before is None:
                os.environ.pop("TEARDOWN_CUPTI", None)
            else:
                os.environ["TEARDOWN_CUPTI"] = before
        dev = [(e.name, e.time_range.start, e.time_range.end)
               for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        found = marked(dev, GUARD_MS * 1e3, start.elapsed_time(end) * 1e3)
        if found is None:
            raise RuntimeError("the profiler dropped a marker spin of the "
                               "traced window: no device trace")
        a0, scale = found
        marks = sorted((lo, hi) for n, lo, hi in dev if SPIN_KERNEL in n
                       and hi - lo < GUARD_MS * 1e3 / 2)
        self.device = [(n, a0 + (lo - a0) * scale, a0 + (hi - a0) * scale)
                       for n, lo, hi in dev
                       if SPIN_KERNEL not in n and lo >= a0]
        self.window = tuple(a0 + (x - a0) * scale
                            for x in (marks[0][1], marks[1][0]))
        self.window_s = (self.window[1] - self.window[0]) / 1e6
        # the start event completes as the first marker spin starts (a0);
        # the idle event as it was recorded (t_idle)
        at_idle = a0 - idle.elapsed_time(start) * 1e3

        def on_device(t):
            return at_idle + (t - t_idle) * 1e6

        got = rec.spans()
        host += [(sp.name, *sp.host) for sp in got]
        self.host = [(n, on_device(t0), on_device(t1)) for n, t0, t1 in host]
        to_start = rec.origin.elapsed_time(start)
        self.spans = [(sp.name, a0 + (sp.device[0] - to_start) * 1e3,
                       a0 + (sp.device[1] - to_start) * 1e3,
                       on_device(sp.host[0]), on_device(sp.host[1]))
                      for sp in got]


def traced(view, ctx) -> Optional[SpanTracer]:
    """The SpanTracer of the cell's traced part run once more (once a run:
    kept in `view`), or None where the program records no spans or the
    cell's loop has no replay."""
    if "spans" not in view:
        view["spans"] = replay(ctx)
    return view["spans"]


def replay(ctx) -> Optional[SpanTracer]:
    from yolov3_tensorflow_tpu_torch.utils import profiling
    driver = ctx.traffic["driver"]
    if driver not in CHEAP_CHECK or not hasattr(profiling, "recording"):
        return None
    again = copy.copy(ctx)
    again.seconds = 0.0
    again.trace = True
    again.checks = harness.Checks()
    again.tracer = SpanTracer()
    again.traffic = dict(ctx.traffic, **CHEAP_CHECK[driver])
    harness.free(ctx.device)
    harness.load_module(harness.HERE / "drivers" / f"{driver}.py").run(again)
    return again.tracer


def lengths(view, ctx, name: str) -> Optional[Tuple[List[float],
                                                    List[float]]]:
    """(device seconds, host seconds) of each span `name` in the traced
    part, or None where there are no spans to read. Raises where the
    spans are not one a traced batch or step."""
    tracer = traced(view, ctx)
    if tracer is None:
        return None
    got = [s for s in tracer.spans if s[0] == name]
    want = view["images"] // ctx.traffic["batch"]
    if len(got) != want:
        raise RuntimeError(f"{len(got)} spans {name!r} recorded, "
                           f"{want} batches or steps were traced")
    return ([(d1 - d0) / 1e6 for _, d0, d1, _, _ in got],
            [(h1 - h0) / 1e6 for _, _, _, h0, h1 in got])
