"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

Everything a cell needs is found by name from its entry in
`BENCHMARK.json`: its configuration file, its traffic file under
`benchmark/traffic/`, the loop that traffic names under
`benchmark/drivers/`, and, with `--trace 1`, a reader under
`benchmark/metrics/` for each per-layer metric the cell reports. With
`--trace 0` the result carries the cell's end-to-end metrics, with
`--trace 1` its per-layer metrics and the traced window's breakdown. The
numbers compared against the plain reference come last, on standard
error and in the result line.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from benchmark import harness  # noqa: E402


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"


def per_layer_metrics(ctx: harness.Context, view) -> dict:
    """Each per-layer metric of the cell that its reader finds something
    to read for."""
    out = {}
    for m in ctx.per_layer:
        value = harness.metric_reader(m["name"]).read(view, ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    harness.set_cache_dirs()
    resolved = harness.resolve(harness.load_spec(), args.workload)
    import torch
    chips = resolved["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA device(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.backends.cudnn.benchmark = False
    # the program's host work is dispatch, not CPU kernels: one intra-op
    # thread keeps idle workers from contending for the host's cores
    torch.set_num_threads(1)
    ctx = harness.Context(args.workload, args.seed, args.seconds,
                          bool(args.trace), resolved, device, T_START)
    out = resolved["driver"].run(ctx)

    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips, "memory_peak_bytes": out["memory_peak_bytes"]}
    if args.trace:
        from benchmark.trace import breakdown, busy_s
        view = out["view"]
        info["busy_s"] = busy_s(view["tracer"])
        info["window_s"] = view["tracer"].window_s
        out["breakdown"] = breakdown(view["tracer"])
        out["metrics"] = per_layer_metrics(ctx, view)
    else:
        units = {m["name"]: m["unit"] for m in ctx.end_to_end}
        out["metrics"] = {k: {"value": float(v), "unit": units[k]}
                          for k, v in out["metrics"].items() if k in units}
    print(f"card: {card_line()}", file=sys.stderr)

    bad = harness.forbidden_modules()
    if bad:
        print(f"benchmark: the run loaded {', '.join(bad)}: no result",
              file=sys.stderr)
        return 3
    line = harness.result_line(ctx, out, info)
    for text in ctx.checks.lines():
        print(text, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
