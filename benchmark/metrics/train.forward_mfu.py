"""train.forward_mfu: the train step's live-BN forward against the card's
bf16 peak: one image's forward FLOPs (the frozen `costs.walk` at the
cell's size and classes) times the images of the traced steps, over the
sum of the device lengths of the program's `train_step.forward` spans,
one a step (`benchmark.spans`)."""

from benchmark import costs, spans

UNIT = "%"
LAYER = "train forward"
MOVES = "train_img_per_s"
READS = ("device lengths of the train_step.forward spans in the traced "
         "part", "images of the traced steps")


def read(view, ctx):
    got = spans.lengths(view, ctx, "train_step.forward")
    if got is None:
        return None
    c = ctx.config
    flops = costs.forward_flops(c["height"], c["width"], c["num_classes"])
    return (100.0 * flops * view["images"] / sum(got[0])
            / costs.H100_PEAKS["bf16"])
