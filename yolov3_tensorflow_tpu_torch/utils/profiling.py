"""Step timing, device timing and trace helpers.

Counterpart of `yolov3_tensorflow_tpu/utils/profiling.py`:

- `StepTimer`: p50/p95/mean wall time per step. PyTorch returns before the
  device finishes, so `step(result=...)` synchronizes the devices the
  result's tensors live on before it stops the clock.
- `trace` / `annotate`: `torch.profiler` capture written as a Chrome trace
  (readable by TensorBoard's profile plugin and by chrome://tracing), and
  named regions in it (`record_function`).
- `cuda_ms`: mean device time of a callable from CUDA events, for the
  probes and the stage profiler.
- `differential_ms` and `call_samples_ms`: a callable's time per call, host
  gaps included, for the measurement scripts (`scripts.bench`,
  `bench_train`, `profile_train`).
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Callable, Dict, Iterator, List, Set

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
                log_dir)) as prof:
        yield prof


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region in the profiler timeline (`record_function`)."""
    with torch.profiler.record_function(name):
        yield


# Host time allowed per call when queueing a timed run (see cuda_ms): a
# kernel of tens of microseconds takes about as long to launch from Python.
HOST_MS_PER_CALL = 0.25


def cuda_ms(fn: Callable[[], Any], iters: int,
            host_ms_per_call: float = HOST_MS_PER_CALL) -> float:
    """Mean device milliseconds of fn() over `iters` back-to-back calls,
    after 3 untimed calls, from CUDA events on the current stream.

    Before the timed calls the stream spins (a sleep kernel of at least
    iters * host_ms_per_call ms: its cycle count assumes no clock above
    2 GHz) while the host enqueues them, so the reading is the device's
    time alone, without the gaps the host leaves when a call is shorter
    than its launch cost. A call whose host time exceeds host_ms_per_call
    needs a larger value, or the device waits inside the timed span.

    Needs a CUDA device: it raises rather than time the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_ms times the GPU: no CUDA device here")
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(iters * host_ms_per_call * 2e6))
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
    the CPU), the least of `reps` such differentials after one untimed
    call. The difference cancels the fixed cost of the sync; noise only
    ever adds time, hence the least. (The JAX scripts' chained
    differentials, without the scalar they fed back through each call:
    eager PyTorch elides no call.)"""
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

    diffs = []
    for _ in range(reps):
        t1 = run(n1)
        t2 = run(n2)
        diffs.append((t2 - t1) / (n2 - n1))
    return max(min(diffs), 1e-9) * 1e3


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


def device_busy_ms(fn: Callable[[], Any], iters: int) -> float:
    """Mean milliseconds per call of fn() during which the GPU ran
    something (kernels, copies): the union of the device intervals that
    torch.profiler records over `iters` calls, after 3 untimed calls.
    Beside a `cuda_ms` reading of a whole pipeline it shows how much of
    the call the device waited for the host. Needs a CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError("device_busy_ms times the GPU: no CUDA device "
                           "here")
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    return union_length(spans) / 1e3 / iters


def union_length(spans) -> float:
    """Length of the union of (start, end) intervals: overlapping device
    work (a copy beside a kernel) counts once."""
    total, reach = 0.0, float("-inf")
    for lo, hi in sorted(spans):
        if hi > reach:
            total += hi - max(lo, reach)
            reach = hi
    return total
