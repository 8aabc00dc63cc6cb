"""Model definitions: layers, the YOLOv3 plan and forward, weight conversion."""

from yolov3_tensorflow_tpu_torch.models.yolov3 import (  # noqa: F401
    YoloV3,
    fold_batch_norm,
    init_yolov3,
    yolov3_forward,
)
