"""yolov3_tensorflow_tpu_torch — the PyTorch / CUDA port of yolov3_tensorflow_tpu.

The JAX package (`yolov3_tensorflow_tpu`) is the reference; this package
re-implements its serving detector for an NVIDIA Hopper GPU and keeps the
reference's module names so that each counterpart is easy to find:

- `models.layers`, `models.yolov3`: the BN-folded Darknet-53 + FPN forward
  over plain param dicts keyed by the JAX paths (`backbone/conv_i`,
  `head/conv_i`), convs in channels_last on cuDNN
- `models.convert`: JAX variable trees (numpy leaves) -> this package's trees
- `ops.fast_postprocess`, `ops.postprocess`: the packed serving head,
  candidate prefilter, sparse decode and `build_detector(mode="packed")`
- `ops.nms_cuda`: the shared-candidate NMS, a hand-written CUDA kernel
  (`csrc/nms_shared.cu`) with its plain PyTorch version beside it
- `utils.kernels`: builds the CUDA sources at first use

The package imports torch and numpy, never jax. Every function takes its
device from its tensors or from an explicit `device` argument.
"""

__version__ = "0.1.0"
