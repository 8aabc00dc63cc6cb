"""Find the streaming cell's knee once, by a sweep on the card: the open
loop at steady Poisson rates (no bursts), each for a window, reporting the
latency percentiles and the mean queue wait of the first and the last
fifth of the requests (a wait that grows over the window is a backlog).

    python3 -m benchmark.sweep --workload <name> --rates 60,90,120 \\
        [--seconds 10] [--seed 1]
"""

from __future__ import annotations

import argparse
import json
import sys

from benchmark import harness


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--seed", type=int, default=1)
    args = p.parse_args(argv)
    harness.set_cache_dirs()
    import torch
    if not torch.cuda.is_available():
        print("sweep: needs a CUDA device", file=sys.stderr)
        return 2
    for rate in (float(r) for r in args.rates.split(",")):
        steady = {"traffic": {"rate": rate, "burst_share": 0.0,
                              "calm_factor": 1.0}}
        ctx, out = harness.run_here(args.workload, args.seed, args.seconds,
                                    device=torch.device("cuda", 0),
                                    overrides=steady)
        print(json.dumps({"rate": rate, **out["load"],
                          "correct": ctx.checks.correct}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
