"""train.mfu: the train step's model FLOPs over the traced part of the
window against the card's bf16 peak: the images of the traced steps times
one image's training FLOPs (the frozen `costs.train_cost(walk)`: forward,
input gradient and weight gradient of every conv), over the traced
window's device time."""

from benchmark import costs

UNIT = "%"
LAYER = "train step"
MOVES = "train_img_per_s"
READS = ("the traced window (device time between the markers)",
         "images of the traced steps")


def read(view, ctx):
    c = ctx.config
    flops = costs.train_flops(c["height"], c["width"], c["num_classes"])
    return (100.0 * flops * view["images"] / view["tracer"].window_s
            / costs.H100_PEAKS["bf16"])
