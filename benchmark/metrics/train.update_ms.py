"""train.update_ms: the optimizer's update (with its per-leaf clip) and
the new params a step: the mean device length of the program's
`train_step.update` spans, one a traced step (`benchmark.spans`)."""

from benchmark import spans

UNIT = "ms"
LAYER = "optimizer"
MOVES = "train_img_per_s"
READS = ("device lengths of the train_step.update spans in the traced "
         "part",)


def read(view, ctx):
    got = spans.lengths(view, ctx, "train_step.update")
    if got is None:
        return None
    return 1e3 * sum(got[0]) / len(got[0])
