"""Step timing, device timing and trace helpers.

Counterpart of `yolov3_tensorflow_tpu/utils/profiling.py`:

- `StepTimer`: p50/p95/mean wall time per step. PyTorch returns before the
  device finishes, so `step(result=...)` synchronizes the devices the
  result's tensors live on before it stops the clock.
- `trace`: `torch.profiler` capture written as a Chrome trace (readable by
  TensorBoard's profile plugin and by chrome://tracing).
- `annotate` / `recording`: the program's named spans. Off by default,
  where a span costs the read of one module global; inside `recording()`
  each span's host stamps and, on a CUDA device, a CUDA event at each end,
  kept with their nesting; inside `trace()` a `record_function` region of
  the Chrome trace.
- `cuda_ms`: mean device time of a callable from CUDA events, for the
  probes and the stage profiler.
- `differential_ms` and `call_samples_ms`: a callable's time per call, host
  gaps included, for the measurement scripts (`scripts.bench`,
  `bench_train`, `profile_train`).
- `device_events` and `device_busy_ms`: every device event of a callable's
  calls from one torch.profiler session, whole and on the device's clock
  however late in the process, and the device's busy time per call.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import (Any, Callable, Dict, Iterator, List, NamedTuple,
                    Optional, Sequence, Set, Tuple)

import numpy as np
import torch


def _cuda_devices(result: Any, found: Set[torch.device]) -> Set[torch.device]:
    """The CUDA devices of every tensor in a nest of tuples, lists and
    dicts."""
    if isinstance(result, torch.Tensor):
        if result.device.type == "cuda":
            found.add(result.device)
    elif isinstance(result, dict):
        for v in result.values():
            _cuda_devices(v, found)
    elif isinstance(result, (list, tuple)):
        for v in result:
            _cuda_devices(v, found)
    return found


class StepTimer:
    """Wall-clock timer for steps that run on a device.

    Usage:
        timer = StepTimer()
        with timer.step():
            out = detector(images)
            torch.cuda.synchronize()     # or pass out to .step(result=...)
    """

    def __init__(self, window: int = 500):
        self.window = window
        self._times: List[float] = []

    @contextlib.contextmanager
    def step(self, result=None) -> Iterator[None]:
        t0 = time.perf_counter()
        yield
        for device in _cuda_devices(result, set()):
            torch.cuda.synchronize(device)
        self.record(time.perf_counter() - t0)

    def record(self, seconds: float) -> None:
        self._times.append(seconds)
        if len(self._times) > self.window:
            self._times = self._times[-self.window:]

    def summary(self) -> Dict[str, float]:
        if not self._times:
            return {"count": 0}
        arr = np.asarray(self._times)
        return {
            "count": int(arr.size),
            "mean_ms": float(arr.mean() * 1e3),
            "p50_ms": float(np.percentile(arr, 50) * 1e3),
            "p95_ms": float(np.percentile(arr, 95) * 1e3),
            "last_ms": float(arr[-1] * 1e3),
        }


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Capture a CPU (and, where there is a card, CUDA) trace of the block
    into `log_dir` as `<host>_<pid>.<timestamp>.pt.trace.json`.

    with profiling.trace("./data/logs/profile") as prof:
        run_some_steps()
    prof.key_averages()      # per-op totals, after the block
    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                log_dir)) as prof, _annotating(_TRACING):
        yield prof


# What `annotate` does: None (off), _TRACING (inside `trace`: a
# record_function region) or the open Recording (inside `recording`).
_state: Any = None
_TRACING = "trace"
_OFF = contextlib.nullcontext()


@contextlib.contextmanager
def _annotating(state: Any) -> Iterator[None]:
    global _state
    before, _state = _state, state
    try:
        yield
    finally:
        _state = before


def annotate(name: str):
    """A named span of the program: `with annotate("packed.forward"): ...`.

    Off (the default) it costs the read of one module global. Inside
    `recording()` the open Recording keeps the span's host stamps and CUDA
    events (see `Recording`); inside `trace()` the span is a
    `record_function` region, so the Chrome trace shows it by name."""
    state = _state
    if state is None:
        return _OFF
    if state is _TRACING:
        return torch.profiler.record_function(name)
    return _Span(state, name)


class Span(NamedTuple):
    """One recorded span: its depth among the open spans at its entry (0
    outermost), its host interval (time.perf_counter seconds at entry and
    exit) and its device interval (ms from the recording's origin event to
    its event at entry and at exit, on the stream current at each end; the
    stream time the span holds, waits for the host inside it included),
    None without a CUDA device."""
    name: str
    depth: int
    host: Tuple[float, float]
    device: Optional[Tuple[float, float]]


# CUDA events a recording makes when it opens (a traced part of the
# benchmark's cells uses up to 101)
POOL = 256


class Recording:
    """The spans of one `recording()` block. With a CUDA device it draws
    its events from a pool made when it opens, each recorded once there so
    that CUDA makes it then (a timed record holds the stream ~3 us on the
    H100: a pool of POOL costs ~0.8 ms of device time at the open), and
    records `origin` on the current stream last. A block that needs more
    events doubles the pool, CUDA making each new one at its first use.
    `spans()`, once the block has closed, waits for the device and
    resolves the events."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.rows: List[list] = []       # [name, depth, t0, t1, ev0, ev1]
        self.depth = 0
        self._pool: List[torch.cuda.Event] = []
        self._used = 0
        self.origin = None
        if cuda:
            self._grow(POOL)
            for ev in self._pool:
                ev.record()
            self.origin = self._event()

    def _grow(self, n: int) -> None:
        self._pool += [torch.cuda.Event(enable_timing=True)
                       for _ in range(n)]

    def _event(self) -> torch.cuda.Event:
        if self._used == len(self._pool):
            self._grow(max(len(self._pool), 1))
        ev = self._pool[self._used]
        self._used += 1
        ev.record()
        return ev

    def spans(self) -> List[Span]:
        """Every closed span, in the order the spans were entered."""
        if self.cuda:
            torch.cuda.synchronize()
        out = []
        for name, depth, t0, t1, ev0, ev1 in self.rows:
            if t1 is None:
                continue
            dev = (self.origin.elapsed_time(ev0),
                   self.origin.elapsed_time(ev1)) if self.cuda else None
            out.append(Span(name, depth, (t0, t1), dev))
        return out


class _Span:
    """annotate()'s context inside a recording: the host clock before the
    event at entry, after the event at exit."""
    __slots__ = ("rec", "name", "row")

    def __init__(self, rec: Recording, name: str):
        self.rec = rec
        self.name = name

    def __enter__(self) -> None:
        rec = self.rec
        self.row = [self.name, rec.depth, time.perf_counter(), None, None,
                    None]
        if rec.cuda:
            self.row[4] = rec._event()
        rec.rows.append(self.row)
        rec.depth += 1

    def __exit__(self, *exc) -> None:
        rec = self.rec
        rec.depth -= 1
        if rec.cuda:
            self.row[5] = rec._event()
        self.row[3] = time.perf_counter()


@contextlib.contextmanager
def recording() -> Iterator[Recording]:
    """Record every `annotate` span entered in the block:

    with profiling.recording() as rec:
        step(...)
    rec.spans()      # [Span(name, depth, host, device), ...]

    On a CUDA device each span also records a CUDA event at both ends on
    the current stream (a few microseconds of host time each); on the CPU
    it keeps host stamps only."""
    rec = Recording(torch.cuda.is_available())
    with _annotating(rec):
        yield rec


# The least host time allowed per call when queueing a timed run (see
# cuda_ms): a kernel of tens of microseconds takes about as long to launch
# from Python.
HOST_MS_PER_CALL = 0.25


def cuda_ms(fn: Callable[[], Any], iters: int) -> float:
    """Mean device milliseconds of fn() over `iters` back-to-back calls,
    after 3 untimed calls, from CUDA events on the current stream.

    Before the timed calls the stream spins (a sleep kernel whose cycle
    count assumes no clock above 2 GHz) while the host enqueues them, so
    the reading is the device's time alone, without the gaps the host
    leaves when a call is shorter than its launch cost. The spin lasts
    `iters` times twice the last untimed call's host-inclusive time (the
    host clock from the call to a synchronize after it), at least
    HOST_MS_PER_CALL a call, so that a call of many launches is queued
    whole before the clock starts.

    Needs a CUDA device: it raises rather than time the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_ms times the GPU: no CUDA device here")
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    hold_ms = max(HOST_MS_PER_CALL, 2e3 * (time.perf_counter() - t0))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(iters * hold_ms * 2e6))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _sync_of(device: torch.device) -> Callable[[], None]:
    """The wait for `device`'s queued work: torch.cuda.synchronize on a
    CUDA device, nothing on the CPU, where PyTorch returns when done."""
    device = torch.device(device)
    if device.type == "cuda":
        return lambda: torch.cuda.synchronize(device)
    if device.type == "cpu":
        return lambda: None
    raise ValueError(f"no timing for device type {device.type!r}")


def differential_ms(fn: Callable[[], Any], device: torch.device, n1: int,
                    n2: int, reps: int = 3) -> float:
    """Milliseconds per call of fn() on `device`, host gaps included:
    (T(n2) - T(n1)) / (n2 - n1), where T(n) is the host clock around n
    back-to-back calls and one final sync (torch.cuda.synchronize; none on
    the CPU), each T the least of `reps` readings after one untimed call.
    The difference cancels the fixed cost of the sync; noise only ever
    adds time, hence the least of each T. (The JAX scripts take the least
    of `reps` differences instead, which noise in a T(n1) pulls low: at
    n1, n2 = 2, 6 it read a device-bound call up to 7% under its busy time
    on the H100, and once at 0. Their chained differentials also feed a
    scalar back through each call: eager PyTorch elides no call.)"""
    if not 0 < n1 < n2:
        raise ValueError(f"differential_ms needs 0 < n1 < n2, got {n1}, {n2}")
    sync = _sync_of(device)
    fn()
    sync()

    def run(n: int) -> float:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        sync()
        return time.perf_counter() - t0

    t1 = t2 = float("inf")
    for _ in range(reps):
        t1 = min(t1, run(n1))
        t2 = min(t2, run(n2))
    return max((t2 - t1) / (n2 - n1), 1e-9) * 1e3


def call_samples_ms(fn: Callable[[], Any], device: torch.device,
                    n: int) -> List[float]:
    """The milliseconds of each of n calls of fn(), each started on an idle
    device after one untimed call: on a CUDA device from a CUDA event
    recorded before the call to one recorded after it (the device's clock,
    the host's launch gaps inside the call included), on the CPU from the
    host clock. For percentiles of a call's latency."""
    sync = _sync_of(device)
    fn()
    sync()
    out = []
    cuda = torch.device(device).type == "cuda"
    for _ in range(n):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            sync()
            out.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            out.append((time.perf_counter() - t0) * 1e3)
    return out


# device_events' profiler session. On the H100 machines torch.profiler
# (Kineto over CUPTI) stamped device events ever further off the host
# clock as a process aged (CUPTI maps its device timestamps to the host
# clock when it starts, and the two drifted apart by up to seconds, faster
# after the host idled), and dropped the events that fell outside its
# capture window: a busy time read low, or 0 for a short call. So CUPTI
# is torn down after each session (TEARDOWN_CUPTI=1 while it runs) and
# maps its clock afresh in the next; a spin of GUARD_MS on the device
# opens the session and as long a wait on the host closes it; and two
# marker kernels (spins of MARK_MS) bracket the timed calls: a session
# whose events lack a marker runs again with a guard GUARD_GROWTH times
# longer, SESSION_TRIES times in all, and then raises. CUDA events before
# the first marker and after the second give the device's time across
# them, to which the session's timestamps are rescaled (the profiler's
# clock also ran a few percent off the device's).
SPIN_KERNEL = "spin_kernel"            # torch.cuda._sleep's kernel
GUARD_MS = 40.0
GUARD_GROWTH = 4
SESSION_TRIES = 4
MARK_MS = 2.0
# CUPTI's teardown ends some time after the session has closed, and while
# it ends it holds the host thread's next CUDA call until the device has
# drained. On the H100, timed loops of packed detector calls right after a
# session had their host blocked 50-140 ms in one call and their device
# idle 15-30 ms (5 of 10 loops); with no session before them, or after a
# wait, one synchronised call, or a session that kept CUPTI, none of 28.
# So each session ends with SETTLE_MS of short synchronised launches: the
# teardown mostly ends there, on an idle device (1 of 10 loops after a
# settled session still held), not inside the caller's next timed loop.
SETTLE_MS = 100.0
SETTLE_SPIN = 1000                     # cycles of each settling launch


def device_events(fn: Callable[[], Any], iters: int, *,
                  record_ranges: bool = False
                  ) -> List[Tuple[str, float, float]]:
    """(name, start us, end us) of every device event (kernels, copies)
    that torch.profiler records over `iters` calls of fn(), after 3
    untimed calls: all of them, on the device's clock (see the comment
    above). record_ranges=True also profiles the host, so that each
    `record_function` range inside fn shows as a device event of its name
    spanning the kernels launched in it. fn must not launch
    torch.cuda._sleep itself (its spin kernel marks the calls). Needs a
    CUDA device."""
    return device_timeline(fn, iters, record_ranges=record_ranges)[0]


def device_timeline(fn: Callable[[], Any], iters: int, *,
                    record_ranges: bool = False
                    ) -> Tuple[List[Tuple[str, float, float]], float]:
    """`device_events`' events, and the device's time across the `iters`
    calls on the same clock, in us: from the first marker's end to the
    second marker's start. The union of the events falls short of it by
    the gaps between them, and by any event the profiler lost."""
    if not torch.cuda.is_available():
        raise RuntimeError("device_events traces the GPU: no CUDA device "
                           "here")
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    guard_ms = GUARD_MS
    for _ in range(SESSION_TRIES):
        events, span_ms = _session(fn, iters, guard_ms, record_ranges)
        marked = _marked(events, guard_ms * 1e3, span_ms * 1e3)
        if marked is not None:
            return marked
        guard_ms *= GUARD_GROWTH
    raise RuntimeError(
        f"torch.profiler dropped the calls' device events in {SESSION_TRIES} "
        f"sessions (guards up to {guard_ms / GUARD_GROWTH:.0f} ms)")


def device_busy_ms(fn: Callable[[], Any], iters: int) -> float:
    """Mean milliseconds per call of fn() during which the GPU ran
    something (kernels, copies): the union of the device intervals of
    `device_events` over `iters` calls. Beside a `cuda_ms` reading of a
    whole pipeline it shows how much of the call the device waited for
    the host. Needs a CUDA device."""
    return union_length([(lo, hi) for _, lo, hi in device_events(
        fn, iters)]) / 1e3 / iters


def _session(fn: Callable[[], Any], iters: int, guard_ms: float,
             record_ranges: bool
             ) -> Tuple[List[Tuple[str, float, float]], float]:
    """One profiler session: a spin of guard_ms, a CUDA event, a marker,
    `iters` calls of fn(), a marker, a CUDA event, then guard_ms on the
    host before the session ends, CUPTI torn down at its end. Returns
    ((name, start us, end us) of every device event, the ms between the
    two CUDA events)."""
    activities = [torch.profiler.ProfilerActivity.CUDA]
    if record_ranges:
        activities.append(torch.profiler.ProfilerActivity.CPU)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    mark = int(MARK_MS * 2e6)
    before = os.environ.get("TEARDOWN_CUPTI")
    os.environ["TEARDOWN_CUPTI"] = "1"
    try:
        with torch.profiler.profile(activities=activities) as prof:
            torch.cuda._sleep(int(guard_ms * 2e6))
            start.record()
            torch.cuda._sleep(mark)
            for _ in range(iters):
                fn()
            torch.cuda._sleep(mark)
            end.record()
            torch.cuda.synchronize()
            until = time.perf_counter() + guard_ms / 1e3
            while time.perf_counter() < until:
                pass
    finally:
        if before is None:
            del os.environ["TEARDOWN_CUPTI"]
        else:
            os.environ["TEARDOWN_CUPTI"] = before
    events = [(e.name, e.time_range.start, e.time_range.end)
              for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    settle_teardown()
    return events, start.elapsed_time(end)


def settle_teardown() -> float:
    """Short launches, each synchronised, for SETTLE_MS after a profiler
    session (see the comment above SETTLE_MS). Returns the longest launch
    and synchronise, in ms: the teardown's hold shows there."""
    longest = 0.0
    until = time.perf_counter() + SETTLE_MS / 1e3
    while True:
        t0 = time.perf_counter()
        if t0 >= until:
            return longest
        torch.cuda._sleep(SETTLE_SPIN)
        torch.cuda.synchronize()
        longest = max(longest, (time.perf_counter() - t0) * 1e3)


def marked_events(events: Sequence[Tuple[str, float, float]],
                  guard_us: float, span_us: float
                  ) -> Optional[List[Tuple[str, float, float]]]:
    """A `_session`'s events other than its spins, their times rescaled
    about the first marker's start so that the markers span span_us (the
    device's time between the session's CUDA events); or None when the
    profiler dropped either marker (a spin shorter than half the guard):
    the calls ran between the two markers, so with both present every
    one of their events is."""
    marked = _marked(events, guard_us, span_us)
    return None if marked is None else marked[0]


def _marked(events: Sequence[Tuple[str, float, float]], guard_us: float,
            span_us: float
            ) -> Optional[Tuple[List[Tuple[str, float, float]], float]]:
    """`marked_events`' events and the rescaled us between the first
    marker's end and the second's start, or None."""
    markers = sorted((lo, hi) for name, lo, hi in events
                     if SPIN_KERNEL in name and hi - lo < guard_us / 2)
    if len(markers) != 2:
        return None
    (a0, a1), (b0, b1) = markers
    scale = span_us / (b1 - a0)
    return ([(name, a0 + (lo - a0) * scale, a0 + (hi - a0) * scale)
             for name, lo, hi in events if SPIN_KERNEL not in name],
            (b0 - a1) * scale)


def union_length(spans) -> float:
    """Length of the union of (start, end) intervals: overlapping device
    work (a copy beside a kernel) counts once."""
    total, reach = 0.0, float("-inf")
    for lo, hi in sorted(spans):
        if hi > reach:
            total += hi - max(lo, reach)
            reach = hi
    return total
