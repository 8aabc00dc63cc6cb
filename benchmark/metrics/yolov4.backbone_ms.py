"""yolov4.backbone_ms: the device time a batch of the program's
`yolov4.backbone` spans (CSPDarknet-53, layers 0-104: the 72 Mish convs,
their epilogues and the CSP concats), nested in `packed.forward`: their
mean device length, one a traced batch (`benchmark.spans`)."""

from benchmark import spans

UNIT = "ms"
LAYER = "YOLOv4 backbone"
MOVES = "serve_img_per_s"
READS = ("device lengths of the yolov4.backbone spans in the traced part",)


def read(view, ctx):
    got = spans.lengths(view, ctx, "yolov4.backbone")
    if got is None:
        return None
    return 1e3 * sum(got[0]) / len(got[0])
