"""eval.mfu: the eval step's model FLOPs over the traced part of the
window against the card's bf16 peak: the images of the traced batches
times one image's forward (the frozen `costs.walk` with the cell's
classes), over the traced window's device time."""

from benchmark import costs

UNIT = "%"
LAYER = "eval step"
MOVES = "eval_img_per_s"
READS = ("the traced window (device time between the markers)",
         "images of the traced batches")


def read(view, ctx):
    c = ctx.config
    flops = costs.forward_flops(c["height"], c["width"], c["num_classes"])
    return (100.0 * flops * view["images"] / view["tracer"].window_s
            / costs.H100_PEAKS["bf16"])
