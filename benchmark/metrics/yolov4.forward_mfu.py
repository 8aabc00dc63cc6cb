"""yolov4.forward_mfu: the YOLOv4 packed forward alone against the card's
bf16 peak: one image's forward FLOPs (the frozen `costs_yolov4.walk` at
the cell's size and classes) times the images of the traced batches, over
the sum of the device lengths of the program's `packed.forward` spans (the
copy in and `yolov4_forward_packed`), one a batch (`benchmark.spans`)."""

from benchmark import costs, costs_yolov4, spans

UNIT = "%"
LAYER = "packed forward"
MOVES = "serve_img_per_s"
READS = ("device lengths of the packed.forward spans in the traced part",
         "images of the traced batches")


def read(view, ctx):
    got = spans.lengths(view, ctx, "packed.forward")
    if got is None:
        return None
    c = ctx.config
    flops = costs_yolov4.forward_flops(c["height"], c["width"],
                                       c["num_classes"])
    return (100.0 * flops * view["images"] / sum(got[0])
            / costs.H100_PEAKS["bf16"])
