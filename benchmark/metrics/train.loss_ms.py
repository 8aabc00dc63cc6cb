"""train.loss_ms: the loss and the L2 term a step: the mean device
length of the program's `train_step.loss` spans, one a traced step
(`benchmark.spans`)."""

from benchmark import spans

UNIT = "ms"
LAYER = "train loss"
MOVES = "train_img_per_s"
READS = ("device lengths of the train_step.loss spans in the traced "
         "part",)


def read(view, ctx):
    got = spans.lengths(view, ctx, "train_step.loss")
    if got is None:
        return None
    return 1e3 * sum(got[0]) / len(got[0])
