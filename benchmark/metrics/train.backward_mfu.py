"""train.backward_mfu: the train step's backward against the card's bf16
peak: one image's input and weight gradient FLOPs (the frozen
`costs.train_cost` less the forward) times the images of the traced
steps, over the sum of the device lengths of the program's
`train_step.backward` spans (`torch.autograd.grad`), one a step
(`benchmark.spans`)."""

from benchmark import costs, spans

UNIT = "%"
LAYER = "train backward"
MOVES = "train_img_per_s"
READS = ("device lengths of the train_step.backward spans in the traced "
         "part", "images of the traced steps")


def read(view, ctx):
    got = spans.lengths(view, ctx, "train_step.backward")
    if got is None:
        return None
    c = ctx.config
    hw_c = (c["height"], c["width"], c["num_classes"])
    flops = costs.train_flops(*hw_c) - costs.forward_flops(*hw_c)
    return (100.0 * flops * view["images"] / sum(got[0])
            / costs.H100_PEAKS["bf16"])
