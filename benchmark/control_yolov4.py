"""The readings that the YOLOv4 cell's limits of `correct` are set from,
over many seeds in one process: the program's own (sound runs of the
cell), the control's (the YOLOv4 reference in float8, one precision below
the configuration's bfloat16, in the program's place) and each planted
fault's. Two more variants witness the weights: `witness_bf16`, the
reference rounded to bfloat16 in the program's place (how far the
configuration's own precision moves the answers), and `negatives`, the
share of each activation's inputs below 0 over the compared images.
`--bn gamma,beta` draws the batch norms around other centres
(`weights_yolov4.GAMMA`, `BETA`). `benchmark/control.py` does the same
for the YOLOv3 cells, whose reference it calls by name.

    python3 -m benchmark.control_yolov4 --seeds 1,2,3 [--seconds 3] \\
        [--variants program,control,faults,witness_bf16,negatives] \\
        [--bn 0.25,0.5]

Prints one JSON line per seed and variant. The benchmark's runs never run
this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from benchmark import check, control, harness, weights_yolov4
from benchmark.drivers import offline_yolov4
from benchmark.reference import yolov4 as reference

CELL = "yolov4-coco608-offline-b64"


def _context(seed: int, device, overrides):
    resolved = harness.resolve(harness.load_spec(), CELL)
    return harness.Context(CELL, seed, 0, False, resolved, device,
                           time.perf_counter(), (), overrides)


def low_precision(seed: int, device, overrides=None,
                  precision: str = "fp8") -> dict:
    """The readings of the reference in `precision` in the program's
    place, against the reference in float32."""
    ctx = _context(seed, device, overrides)
    variables, inputs, select = offline_yolov4.control_inputs(ctx)
    refs = offline_yolov4.reference_detections(variables, inputs,
                                               ctx.config, **select)
    low = offline_yolov4.reference_detections(variables, inputs, ctx.config,
                                              precision=precision, **select)
    return check.compare_detections([check.kept_as_dets(r) for r in low],
                                    refs, margin=ctx.traffic["margin"])


def negative_shares(seed: int, device, overrides=None,
                    block: int = 8) -> dict:
    """Per activation (mish, leaky): the share of its inputs below 0 over
    all its layers and the compared images, and the least and most of one
    layer."""
    ctx = _context(seed, device, overrides)
    variables, inputs, _ = offline_yolov4.control_inputs(ctx)
    seen = []
    net = reference.Net(variables, ctx.config["num_classes"],
                        on_activation=lambda act, h: seen.append(
                            (act, float((h < 0).sum()), h.numel())))
    blocks = 0
    with torch.no_grad(), check.tf32_off():
        for i in range(0, len(inputs), block):
            net(inputs[i:i + block])
            blocks += 1
    n_layers = len(seen) // blocks
    per_layer = {}
    for j, (act, neg, n) in enumerate(seen):
        acc = per_layer.setdefault(j % n_layers, [act, 0.0, 0])
        acc[1] += neg
        acc[2] += n
    out = {}
    for act in sorted({a for a, _, _ in per_layer.values()}):
        rows = [(neg, n) for a, neg, n in per_layer.values() if a == act]
        shares = [neg / n for neg, n in rows]
        out[act] = {"share": sum(r[0] for r in rows) / sum(r[1] for r in rows),
                    "layer_min": min(shares), "layer_max": max(shares),
                    "layers": len(rows)}
    return out


def readings(seeds, seconds: float, device, variants, overrides=None):
    for seed in seeds:
        if "program" in variants:
            yield {"seed": seed, "variant": "program",
                   **control.program(CELL, seed, seconds, device,
                                     overrides)}
        if "control" in variants:
            yield {"seed": seed, "variant": "control_fp8",
                   **low_precision(seed, device, overrides)}
        if "witness_bf16" in variants:
            yield {"seed": seed, "variant": "witness_bf16",
                   **low_precision(seed, device, overrides, "bf16")}
        if "negatives" in variants:
            yield {"seed": seed, "variant": "negatives",
                   **negative_shares(seed, device, overrides)}
        if "faults" in variants:
            for fault in offline_yolov4.FAULTS:
                yield {"seed": seed, "variant": f"fault_{fault}",
                       **control.program(CELL, seed, seconds, device,
                                         overrides, faults=(fault,))}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--variants", default="program,control,faults")
    p.add_argument("--bn", default=None,
                   help="gamma,beta: the batch norms' centres of the draw")
    args = p.parse_args(argv)
    if args.bn:
        weights_yolov4.GAMMA, weights_yolov4.BETA = (
            float(v) for v in args.bn.split(","))
    harness.set_cache_dirs()
    if not torch.cuda.is_available():
        print("control_yolov4: needs a CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    for row in readings([int(s) for s in args.seeds.split(",")],
                        args.seconds, torch.device("cuda", 0),
                        args.variants.split(",")):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
