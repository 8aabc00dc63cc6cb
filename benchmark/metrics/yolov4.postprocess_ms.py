"""yolov4.postprocess_ms: the packed postprocess's device time a batch of
YOLOv4's 22,743 anchors an image: the mean device length of the program's
`packed.postprocess` spans (score, top-k, gather and decode with
scale_x_y, K1 and compaction), one a traced batch, read by
`serve.postprocess_ms`'s reader."""

from benchmark import harness

UNIT = "ms"
LAYER = "packed postprocess"
MOVES = "serve_img_per_s"
SERVE = harness.metric_reader("serve.postprocess_ms")
READS = SERVE.READS


def read(view, ctx):
    return SERVE.read(view, ctx)
