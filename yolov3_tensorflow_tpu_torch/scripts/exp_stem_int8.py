"""The stem-int8 hybrid against bf16 packed serving, by handoff point
(counterpart of `scripts/exp_stem_int8.py`).

The packed-head detector at 416^2, batch 128: bf16 packed
(`build_detector(mode="packed")`), then for each `--upto` (default 4 9 12)
the stem-int8 hybrid, whose conv_0..conv_{upto-1} run int8-chained
(`build_detector(mode="stem8")`: `ops.quantize.build_stem_int8_packed`,
`yolov3_forward_stem_int8_packed`, `postprocess_packed`), every mode at
the serving config with K1 on the GPU. The activation scales are
calibrated once, on the batch's first 8 images, as JAX's script does. An
`--upto` outside `ops.quantize.stem_int8_safe_boundaries()` (one that
splits a residual block) is refused, as `build_stem_int8_packed` refuses
it: its row holds that function's ValueError and no number.

  python -m yolov3_tensorflow_tpu_torch.scripts.exp_stem_int8 \\
      [--batch 128] [--upto 4 9 12] [--size 416 416] [--iters 5,25] \\
      [--device cuda] [--out f.json]
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from yolov3_tensorflow_tpu_torch.config import DEFAULT_ANCHORS
from yolov3_tensorflow_tpu_torch.models.yolov3 import channels_last_weights
from yolov3_tensorflow_tpu_torch.ops.fast_postprocess import (
    decode_tables, pack_serving_head)
from yolov3_tensorflow_tpu_torch.ops.postprocess import build_detector
from yolov3_tensorflow_tpu_torch.ops.quantize import (
    QuantizedDetector, calibrate_activation_scales, quantize_model,
    yolov3_forward_int8_packed)
from yolov3_tensorflow_tpu_torch.scripts import bench, experiments

UPTO = (4, 9, 12)
CALIB_IMAGES = 8


def detectors(variables: dict, scales: dict, uptos: Sequence[int],
              size: Tuple[int, int], device: torch.device,
              int8_packed: bool = False) -> Iterator[Tuple[str, nn.Module]]:
    """(name, detector) of each mode, built one at a time at the serving
    config: bf16 packed, full int8 on the packed head when `int8_packed`
    (`quantize_model` + `pack_serving_head`), stem8 at each upto; every
    int8 mode on the activation scales `scales`. A quantized detector's
    forward is `det.forward_fn(det.params, images)`. An upto that
    `build_stem_int8_packed` refuses comes as its ValueError instead of a
    detector."""
    c = experiments.NUM_CLASSES
    anchors = np.asarray(DEFAULT_ANCHORS, np.float32)
    serving = experiments.SERVING
    yield "bf16 packed", bench.packed_detector(variables, size, device)
    if int8_packed:
        qp = channels_last_weights(pack_serving_head(
            quantize_model(variables, scales), c))
        yield "int8-packed", QuantizedDetector(
            yolov3_forward_int8_packed, qp,
            decode_tables(size, anchors, device=device), anchors, c, size,
            post="packed", **serving).eval()
    for upto in uptos:
        try:
            det = build_detector(variables, anchors, c, size, device=device,
                                 mode="stem8", activation_scales=scales,
                                 stem_int8_upto=upto, **serving)
        except ValueError as e:
            det = e
        yield f"stem8 upto={upto}", det


def run_modes(script: str, doc: str, argv: Optional[List[str]], *,
              batch: int, size: Tuple[int, int], uptos: Sequence[int],
              calib: int, iters: Tuple[int, int], int8_packed: bool) -> int:
    """The experiment of `script` (this one, or exp_highres_int8 with
    int8_packed): every mode of `detectors` timed on one batch."""
    p = experiments.parser(doc, batch=batch, size=size, iters=iters)
    p.add_argument("--upto", type=int, nargs="+", default=list(uptos),
                   help="stem8 handoff points (conv indices)")
    run = experiments.Run(script, p, argv)
    variables = bench.serving_variables(run.device)
    images = bench.bench_images(run.batch, run.size, run.device)
    scales = calibrate_activation_scales(variables, images[:calib])
    for name, det in detectors(variables, scales, run.args.upto, run.size,
                               run.device, int8_packed):
        name = f"{run.size[0]}x{run.size[1]} {name}"
        if isinstance(det, ValueError):
            run.no_counterpart(name, str(det), key="refused")
        else:
            run.row(name, lambda det=det: det(images), nms=True,
                    batch=run.batch)
        del det
    return run.finish(upto=run.args.upto, calibration_images=calib)


def main(argv: Optional[List[str]] = None) -> int:
    return run_modes("exp_stem_int8", __doc__, argv, batch=128,
                     size=(416, 416), uptos=UPTO, calib=CALIB_IMAGES,
                     iters=experiments.CUDA_ITERS, int8_packed=False)


if __name__ == "__main__":
    raise SystemExit(main())
