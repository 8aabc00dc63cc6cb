"""train.dispatch_ms: the host's time a step: the mean host length of the
program's `train_step` spans, one a traced step (`benchmark.spans`).
Beside the device's time a step it says which side sets the pace."""

from benchmark import spans

UNIT = "ms"
LAYER = "train step"
MOVES = "train_img_per_s"
READS = ("host lengths of the train_step spans in the traced part",)


def read(view, ctx):
    got = spans.lengths(view, ctx, "train_step")
    if got is None:
        return None
    return 1e3 * sum(got[1]) / len(got[1])
