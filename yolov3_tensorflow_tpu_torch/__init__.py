"""yolov3_tensorflow_tpu_torch — the PyTorch / CUDA port of yolov3_tensorflow_tpu.

The JAX package (`yolov3_tensorflow_tpu`) is the reference; this package
re-implements its inference and training paths for an NVIDIA Hopper GPU
and keeps the reference's module names so that each counterpart is easy to
find:

- `models.layers`, `models.yolov3`: the BN-folded Darknet-53 + FPN forward
  and the live-BN training and eval forward (`yolov3_forward`, sync batch
  norm over a process group) over plain param dicts keyed by the JAX paths
  (`backbone/conv_i`, `head/conv_i`), convs in channels_last on cuDNN;
  `YoloV3`, the reference's class API
- `parallel`: data-parallel and multi-process training over a
  `torch.distributed` process group (`multihost`: bring-up and the
  validation gathers; `mesh`; `data_parallel`: the DP train step and eval
  forward) and batch-sharded serving (`serving`)
- `ops.losses`: the YOLOv3 loss and the L2 penalty
- `train.schedules`, `train.optimizers`, `train.checkpoint`,
  `train.trainer`, `cli.train`: learning-rate schedules, optimizers with
  optax's semantics, checkpoints, the Trainer (in-train evaluation and
  validation through the per-group NMS kernel) and its entry point, on the
  GPU by default (`--device cpu` trains without one)
- `data` (annotations, augmentation, label encoding, the threaded loader,
  the synthetic dataset), `evaluation` (batch metrics, VOC mAP),
  `utils.summary`, `utils.kmeans`: host modules copied from the JAX
  package
- `data.device_augment`, `data.device_encode`: the device-resident data
  path (augmentation of staged uint8 tiles, label grids from padded ground
  truth) that the trainer runs before its step
- `cli.evaluate`, `cli.convert_weights`, `cli.strip_checkpoint`: VOC
  evaluation of a checkpoint and the checkpoint tools; `cli.kmeans_anchors`,
  `cli.parse_voc`: host-only dataset tools; `scripts.overfit_gate`: the
  overfit-to-mAP gate through the Trainer and `cli.evaluate`
- `models.convert`: JAX variable trees (numpy leaves) -> this package's trees
- `models.decode`: anchor decode of the raw feature maps
- `ops.fast_postprocess`, `ops.postprocess`: the packed serving head, the
  candidate prefilter, the exact postprocess and `build_detector` with the
  "prefilter" (default), "packed", "exact" and "stem8" modes;
  `select_serving_mode` and `build_auto_detector`
- `ops.quantize`, `ops.int8_conv`: int8 serving (calibration, PTQ, the
  int8, int8-chained and stem-int8 forwards, `build_detector_int8`), with
  the int8 convs as `torch._int_mm` over patches; `scripts.
  validate_quantized` holds their mAP and detections to bf16's
- `ops.preprocess`: the device letterbox of raw uint8 frames and the
  streaming detector (BGR flip, letterbox and detector in one call)
- `cli.detect_image`, `cli.detect_video`: the image and video demos, on the
  GPU by default (`--device cpu` runs them without one); `cli.common`
  loads anchors, class names, `.weights` files and checkpoint directories
- `config`, `utils.coco`, `utils.viz`: host helpers copied from the JAX
  package (the config tree, anchor and names files, class names, drawing)
- `ops.nms`: the plain per-class NMS and the numpy oracles
- `ops.nms_cuda`: the shared-candidate and the per-group NMS, hand-written
  CUDA kernels (`csrc/nms_shared.cu`, `csrc/nms.cu`) with their plain
  PyTorch versions beside them
- `utils.weights`: darknet `.weights` import and export
- `utils.kernels`: builds the CUDA sources at first use
- `utils.profiling`: step timer, CUDA-event timing, torch.profiler traces
- `scripts.exp_mxu_shapes`: the tensor-core chain and patch-build probes,
  hand-written CUDA kernels (`csrc/mma_rate.cu`, `csrc/patch_build.cu`)
  with their plain versions; `scripts.roofline`: the per-layer roofline
  from measured constants; `scripts.profile_stages`: the stage profiler

The package imports torch, numpy and cv2, never jax, and no module of the
JAX package. Every function takes its device from its tensors or from an
explicit `device` argument.
"""

__version__ = "0.1.0"
