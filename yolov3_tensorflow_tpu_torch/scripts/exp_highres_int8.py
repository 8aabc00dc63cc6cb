"""int8 serving against bf16 at high resolution (counterpart of
`scripts/exp_highres_int8.py`).

The packed-head detector at 896x1344, batch 16, in three kinds of mode:

  bf16          `build_detector(mode="packed")`
  int8-packed   `quantize_model` + `pack_serving_head`: every conv int8,
                bf16 activations between them (quantize and dequantize
                around each conv)
  stem8 upto=u  int8-chained conv_0..conv_{u-1}, bf16 from conv_u on, for
                each `--upto` (default 9 12 15)

calibrated once on the batch's first 4 images, as JAX's script does, at
the serving config with K1 on the GPU (`exp_stem_int8.detectors`). An
`--upto` outside `stem_int8_safe_boundaries()` is refused with a row that
says why: JAX's default 15 is one (it splits a residual block, and
JAX's `build_stem_int8_packed` raises there too), kept so that the rows
line up with the JAX script's.

  python -m yolov3_tensorflow_tpu_torch.scripts.exp_highres_int8 \\
      [--size 896 1344] [--batch 16] [--upto 9 12 15] [--iters 3,13] \\
      [--device cuda] [--out f.json]
"""

from __future__ import annotations

from typing import List, Optional

from yolov3_tensorflow_tpu_torch.scripts.exp_stem_int8 import run_modes

UPTO = (9, 12, 15)
CALIB_IMAGES = 4
CUDA_ITERS = (3, 13)                   # JAX's n1, n2 at this size


def main(argv: Optional[List[str]] = None) -> int:
    return run_modes("exp_highres_int8", __doc__, argv, batch=16,
                     size=(896, 1344), uptos=UPTO, calib=CALIB_IMAGES,
                     iters=CUDA_ITERS, int8_packed=True)


if __name__ == "__main__":
    raise SystemExit(main())
