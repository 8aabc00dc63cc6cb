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


def cuda_ms(fn: Callable[[], Any], iters: int) -> float:
    """Mean device milliseconds of fn() over `iters` back-to-back calls,
    after 3 untimed calls, from CUDA events on the current stream.

    Before the timed calls the stream spins (a sleep kernel of at least
    iters * HOST_MS_PER_CALL ms: its cycle count assumes no clock above
    2 GHz) while the host enqueues them, so the reading is the device's
    time alone, without the gaps the host leaves when a call is shorter
    than its launch cost.

    Needs a CUDA device: it raises rather than time the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_ms times the GPU: no CUDA device here")
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(iters * HOST_MS_PER_CALL * 2e6))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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
