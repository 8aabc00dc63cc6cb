"""yolov4.neck_ms: the device time a batch of the program's `yolov4.neck`
spans (the SPP, the PAN and the three detection convs, layers 105-161),
nested in `packed.forward`: their mean device length, one a traced batch
(`benchmark.spans`)."""

from benchmark import spans

UNIT = "ms"
LAYER = "YOLOv4 neck"
MOVES = "serve_img_per_s"
READS = ("device lengths of the yolov4.neck spans in the traced part",)


def read(view, ctx):
    got = spans.lengths(view, ctx, "yolov4.neck")
    if got is None:
        return None
    return 1e3 * sum(got[0]) / len(got[0])
