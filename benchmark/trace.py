"""Device traces of a stated part of the window, and what they reduce to.

A frozen copy of the program's `utils/profiling.py` guard and marker
rescale: CUPTI maps its device timestamps to the host clock when it
starts, and on the H100 machines the two drifted apart as a process aged,
dropping events outside the capture window. So each session tears CUPTI
down at its end (TEARDOWN_CUPTI=1), opens with a device spin of GUARD_MS,
brackets the traced calls with two marker spins and two CUDA events, and
rescales the device events so the markers span the events' time. A
session whose markers are missing fails the run: it does not fall back
to a guess.

The profiler records the device alone: recording every host operation
too slowed the host by half in the train step and made the device look
idle. The harness's own host ranges (`Tracer.span`, names starting
"bench.") are stamped on the host clock and placed on the device's by the
guard spin, which starts as soon as it is launched on an idle device;
they label the idle gaps in the breakdown.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

SPIN_KERNEL = "spin_kernel"            # torch.cuda._sleep's kernel
GUARD_MS = 40.0
MARK_MS = 2.0

Event = Tuple[str, float, float]       # (name, start us, end us)


def union_length(spans) -> float:
    """Length of the union of (start, end) intervals: overlapping device
    work (a copy beside a kernel) counts once."""
    total, reach = 0.0, float("-inf")
    for lo, hi in sorted(spans):
        if hi > reach:
            total += hi - max(lo, reach)
            reach = hi
    return total


def marked(events: Sequence[Event], guard_us: float, span_us: float
           ) -> Optional[Tuple[float, float]]:
    """(origin, scale) that maps the session's timestamps onto the device's
    time between the two marker spins, or None where either marker is
    missing."""
    marks = sorted((lo, hi) for name, lo, hi in events
                   if SPIN_KERNEL in name and hi - lo < guard_us / 2)
    if len(marks) != 2:
        return None
    (a0, _), (_, b1) = marks
    return a0, span_us / (b1 - a0)


class Tracer:
    """with tracer.session(): ...traced calls...; then `tracer.device`
    (name, start us, end us) of every device event between the markers,
    `tracer.host` the harness's host ranges on the same clock, and
    `tracer.window_s` the device time between the markers. `span(name)`
    stamps a host range while a session is open and costs two clock
    reads; outside one it does nothing."""

    def __init__(self):
        self.device: List[Event] = []
        self.host: List[Event] = []
        self.window = (0.0, 0.0)
        self.window_s = 0.0
        self._spans: Optional[List[Event]] = None

    @contextlib.contextmanager
    def span(self, name: str):
        if self._spans is None:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._spans.append((name, t0, time.perf_counter()))

    @contextlib.contextmanager
    def session(self):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        before = os.environ.get("TEARDOWN_CUPTI")
        os.environ["TEARDOWN_CUPTI"] = "1"
        self._spans = []
        try:
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]
            ) as prof:
                t_guard = time.perf_counter()
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
            spans, self._spans = self._spans, None
            if before is None:
                os.environ.pop("TEARDOWN_CUPTI", None)
            else:
                os.environ["TEARDOWN_CUPTI"] = before
        span_us = start.elapsed_time(end) * 1e3
        dev = [(e.name, e.time_range.start, e.time_range.end)
               for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        found = marked(dev, GUARD_MS * 1e3, span_us)
        guard = [lo for n, lo, hi in dev if SPIN_KERNEL in n
                 and hi - lo >= GUARD_MS * 1e3 / 2]
        if found is None or not guard:
            raise RuntimeError("the profiler dropped a spin of the traced "
                               "window: no device trace")
        a0, scale = found

        def move(evs):
            return [(n, a0 + (lo - a0) * scale, a0 + (hi - a0) * scale)
                    for n, lo, hi in evs]

        marks = sorted((lo, hi) for n, lo, hi in dev if SPIN_KERNEL in n
                       and hi - lo < GUARD_MS * 1e3 / 2)
        lo_w, hi_w = marks[0][1], marks[1][0]
        self.device = [e for e in move(dev) if SPIN_KERNEL not in e[0]
                       and e[1] >= a0]
        g0 = min(guard)
        self.host = move([(n, g0 + (t0 - t_guard) * 1e6,
                           g0 + (t1 - t_guard) * 1e6)
                          for n, t0, t1 in spans])
        t0, t1 = a0 + (lo_w - a0) * scale, a0 + (hi_w - a0) * scale
        self.window = (t0, t1)
        self.window_s = (t1 - t0) / 1e6


def breakdown(tracer: Tracer, top: int = 10) -> Dict[str, list]:
    """The device operations that took most time, and the longest idle
    gaps of the device in the traced window, each named by the innermost
    harness range on the host at the gap's start."""
    by_name: Dict[str, float] = {}
    for name, lo, hi in tracer.device:
        by_name[name] = by_name.get(name, 0.0) + (hi - lo) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    t0, t1 = tracer.window
    spans = sorted((lo, hi) for _, lo, hi in tracer.device)
    gaps, reach = [], t0
    for lo, hi in spans + [(t1, t1)]:
        if lo > reach:
            gaps.append((reach, lo))
        reach = max(reach, hi)
    labelled = []
    for lo, hi in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        inside = [(h_hi - h_lo, name) for name, h_lo, h_hi in tracer.host
                  if h_lo <= lo <= h_hi]
        label = min(inside)[1] if inside else "host:outside-harness-ranges"
        labelled.append([label, (hi - lo) / 1e6])
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": labelled}


def busy_s(tracer: Tracer) -> float:
    """Seconds of the traced window in which the device ran something."""
    return union_length([(lo, hi) for _, lo, hi in tracer.device]) / 1e6


def kernel_seconds(tracer: Tracer, pattern: str) -> Tuple[float, int]:
    """(seconds, launches) of the device kernels whose name holds
    `pattern`."""
    hits = [(hi - lo) for name, lo, hi in tracer.device if pattern in name]
    return sum(hits) / 1e6, len(hits)
