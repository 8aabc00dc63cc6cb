"""What every cell shares: the spec and its files by name, the run's
environment, the device, the import check, the comparison's bookkeeping
and the result line."""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
# top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "yolov3_tensorflow_tpu")


def set_cache_dirs(root: Path = ROOT) -> None:
    """Keep every build and kernel cache inside the checkout, at fixed
    paths, so that only a cell's first run there builds. The program's
    own NMS libraries go to `build/torch_kernels/` of the checkout."""
    cache = root / "build" / "bench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv_compute")):
        os.environ[var] = str(cache / sub)
    os.environ.setdefault("USE_FLAX", "0")


def load_spec(root: Path = ROOT) -> Dict[str, Any]:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def read_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def resolve(spec: Dict[str, Any], workload: str, root: Path = ROOT
            ) -> Dict[str, Any]:
    """The cell's entry, its configuration and traffic files, its driver
    module and the per-layer metrics it reports, all found by name."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    config = read_json(root / configs[cell["config"]]["file"])
    traffic = read_json(HERE / "traffic" / f"{cell['traffic']}.json")
    driver = load_module(HERE / "drivers" / f"{traffic['driver']}.py")
    per_layer = [m for m in spec["per_layer"]
                 if workload in m.get("workloads", [workload])]
    end_to_end = [m for m in spec["end_to_end"]
                  if workload in m.get("workloads", [workload])]
    return {"cell": cell, "config": config, "traffic": traffic,
            "driver": driver, "per_layer": per_layer,
            "end_to_end": end_to_end}


def load_module(path: Path) -> ModuleType:
    """A module from its file, whatever characters its name holds (metric
    names carry dots)."""
    if not path.exists():
        raise FileNotFoundError(f"benchmark file {path} is missing")
    name = "benchmark._file_." + path.stem.replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_reader(name: str) -> ModuleType:
    return load_module(HERE / "metrics" / f"{name}.py")


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    modules = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in modules
                   if m.split(".", 1)[0] in FORBIDDEN})


class Checks:
    """The numbers compared, each beside its limit (value <= limit)."""

    def __init__(self):
        self.items: List[Dict[str, float]] = []

    def add(self, name: str, value: float, limit: float) -> None:
        value = float(value)
        if math.isnan(value):
            value = math.inf
        self.items.append({"name": name, "value": value,
                           "limit": float(limit)})

    @property
    def correct(self) -> bool:
        return bool(self.items) and all(c["value"] <= c["limit"]
                                        for c in self.items)

    def as_dict(self) -> Dict[str, Dict[str, float]]:
        return {c["name"]: {"value": c["value"], "limit": c["limit"]}
                for c in self.items}

    def lines(self) -> List[str]:
        return [f"check {c['name']} {c['value']!r} limit {c['limit']!r}"
                for c in self.items]


class Context:
    """One run: its arguments, the cell's files, the device, the clock
    since the process started, and the faults planted by the tests."""

    def __init__(self, workload: str, seed: int, seconds: float, trace: bool,
                 resolved: Dict[str, Any], device, t_start: float,
                 faults=(), overrides: Optional[Dict[str, Any]] = None):
        self.workload = workload
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.cell = resolved["cell"]
        self.config = dict(resolved["config"], **(overrides or {}).get(
            "config", {}))
        self.traffic = dict(resolved["traffic"], **(overrides or {}).get(
            "traffic", {}))
        self.per_layer = resolved["per_layer"]
        self.end_to_end = resolved["end_to_end"]
        self.device = device
        self.t_start = t_start
        self.faults = frozenset(faults)
        self.checks = Checks()
        from benchmark.trace import Tracer
        self.tracer = Tracer()

    def since_start(self) -> float:
        return time.perf_counter() - self.t_start


def steady() -> None:
    """Just before a window: collect the set-up's garbage once and move
    what is left out of the collector's sight (`gc.freeze`), so that the
    window's collections scan only the window's own objects."""
    gc.collect()
    gc.freeze()


def sync(device) -> None:
    """Wait for the device's queued work (nothing to wait for on the
    CPU)."""
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def memory_peak(device) -> int:
    """The process's peak of allocated device memory so far."""
    import torch
    return (int(torch.cuda.max_memory_allocated(device))
            if device.type == "cuda" else 0)


def free(device) -> None:
    """Return the freed blocks of the program's state to the device, so
    that the reference that follows fits beside what is left."""
    import torch
    sync(device)
    if device.type == "cuda":
        torch.cuda.empty_cache()


def result_line(ctx: Context, out: Dict[str, Any], device_info: Dict
                ) -> Dict[str, Any]:
    """The result object, with the compared numbers last."""
    line = {"correct": ctx.checks.correct,
            "attempted": int(out["attempted"]),
            "failed": int(out["failed"]),
            "metrics": out["metrics"],
            "device": device_info}
    if "breakdown" in out:
        line["breakdown"] = out["breakdown"]
    line["checks"] = ctx.checks.as_dict()
    return line


def run_here(workload: str, seed: int, seconds: float, *, device,
             overrides: Optional[Dict[str, Any]] = None, faults=(),
             spec: Optional[Dict[str, Any]] = None):
    """One run of a cell on `device` without the look for a card, with
    `overrides` of its configuration and traffic ({"config": {...},
    "traffic": {...}}) and `faults` planted in the timed path: the tests'
    way in. Returns (context, the loop's output)."""
    import torch
    resolved = resolve(spec or load_spec(), workload)
    ctx = Context(workload, seed, seconds, False, resolved,
                  torch.device(device), time.perf_counter(), faults,
                  overrides)
    return ctx, resolved["driver"].run(ctx)
