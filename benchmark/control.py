"""The readings that the limits of `correct` are set from, over many seeds
in one process: the program's own (sound runs of the cell), the
control's (the plain reference put in the program's place, one precision
below the configuration's: float8 for bfloat16; for the offline cell the
program's own int8 path too), and each fault's that the cell can have,
planted in the timed path.

    python3 -m benchmark.control --workload <name> --seeds 1,2,3 \\
        [--seconds 3] [--variants program,control,faults]

Prints one JSON line per seed and variant. The benchmark's runs never run
this; the tests run it at a size the CPU holds.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, Iterator, List

from benchmark import check, harness

FAULTS = {"offline": ("half_batch", "alter_answer", "k1_keep_all",
                      "k1_keep_first"),
          "open_loop": ("half_batch", "alter_answer"),
          "eval": ("half_batch", "alter_answer"),
          "train": ("half_batch", "unchanged_state")}


def program(workload: str, seed: int, seconds: float, device, overrides,
            faults=()) -> Dict[str, float]:
    _, out = harness.run_here(workload, seed, seconds, device=device,
                              overrides=overrides, faults=faults)
    return out["readings"]


def context(workload: str, seed: int, device, overrides):
    resolved = harness.resolve(harness.load_spec(), workload)
    return resolved["driver"], harness.Context(
        workload, seed, 0, False, resolved, device, time.perf_counter(), (),
        overrides)


def detection_controls(workload: str, seed: int, device, overrides
                       ) -> Iterator[tuple]:
    drv, ctx = context(workload, seed, device, overrides)
    cfg = ctx.config
    variables, inputs, select = drv.control_inputs(ctx)
    refs = check.reference_detections(variables, inputs, cfg["num_classes"],
                                      cfg["anchors"], **select)
    low = check.reference_detections(variables, inputs, cfg["num_classes"],
                                      cfg["anchors"], precision="fp8",
                                      **select)
    got = check.compare_detections([check.kept_as_dets(r) for r in low],
                                   refs, margin=ctx.traffic["margin"])
    if hasattr(drv, "control_loss_gap"):
        got["loss_gap"] = drv.control_loss_gap(ctx, variables)
    yield "control_fp8", got
    if ctx.traffic["driver"] == "offline":
        yield "control_int8_program", check.compare_detections(
            int8_detections(ctx, variables, inputs), refs,
            margin=ctx.traffic["margin"])


def int8_detections(ctx, variables, inputs) -> List[check.Dets]:
    """The program's own int8 path (`build_detector_int8`, packed, at the
    serving thresholds) on the inputs, calibrated on the first 8."""
    import numpy as np
    import torch
    from yolov3_tensorflow_tpu_torch.ops.postprocess import (
        pack_detections, unpack_detections)
    from yolov3_tensorflow_tpu_torch.ops.quantize import build_detector_int8
    cfg, s = ctx.config, ctx.config["serving"]
    det8, _ = build_detector_int8(
        variables, np.asarray(cfg["anchors"], np.float32),
        cfg["num_classes"], (cfg["height"], cfg["width"]),
        calibration_images=inputs[:8], device=ctx.device,
        max_out=s["max_out"], score_thresh=s["score_thresh"],
        iou_thresh=s["iou_thresh"], box_topk=s["box_topk"], mode="packed")
    with torch.inference_mode():
        rows = pack_detections(det8(inputs)).cpu().numpy()
    return [unpack_detections(rows, i) for i in range(len(inputs))]


def train_controls(workload: str, seed: int, device, overrides
                   ) -> Iterator[tuple]:
    from benchmark import weights
    drv, ctx = context(workload, seed, device, overrides)
    cfg, tr = ctx.config, ctx.traffic
    variables = weights.draw(seed, cfg["num_classes"], device, spread=False)
    data = drv.pool(ctx, tr["check_steps"])

    def batch(i):
        return data["images"][i], (data["boxes"][i], data["labels"][i],
                                   data["mask"][i])

    ref = drv.reference_steps(cfg, variables, batch, tr["check_steps"])
    for precision in ("fp8", "bf16"):
        low = drv.reference_steps(cfg, variables, batch, tr["check_steps"],
                                  precision=precision)
        # bf16: a witness, the reference with its conv operands rounded as
        # the program's are
        name = "control_fp8" if precision == "fp8" else "witness_bf16"
        yield name, drv.compare(low, ref)


def readings(workload: str, seeds: List[int], seconds: float, device,
             variants, overrides=None) -> Iterator[dict]:
    kind = harness.resolve(harness.load_spec(), workload)["traffic"][
        "driver"]
    controls = train_controls if kind == "train" else detection_controls
    for seed in seeds:
        if "program" in variants:
            yield {"seed": seed, "variant": "program",
                   **program(workload, seed, seconds, device, overrides)}
        if "control" in variants:
            for name, got in controls(workload, seed, device, overrides):
                yield {"seed": seed, "variant": name, **got}
        if "faults" in variants:
            for fault in FAULTS[kind]:
                yield {"seed": seed, "variant": f"fault_{fault}",
                       **program(workload, seed, seconds, device, overrides,
                                 faults=(fault,))}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--variants", default="program,control,faults")
    args = p.parse_args(argv)
    harness.set_cache_dirs()
    import torch
    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",")]
    for row in readings(args.workload, seeds, args.seconds,
                        torch.device("cuda", 0), args.variants.split(",")):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
