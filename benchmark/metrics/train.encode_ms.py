"""train.encode_ms: the device label encoding (`encode_labels_device`)
a step: the mean device length of the program's `train_step.encode`
spans, one a traced step (`benchmark.spans`)."""

from benchmark import spans

UNIT = "ms"
LAYER = "device label encoding"
MOVES = "train_img_per_s"
READS = ("device lengths of the train_step.encode spans in the traced "
         "part",)


def read(view, ctx):
    got = spans.lengths(view, ctx, "train_step.encode")
    if got is None:
        return None
    return 1e3 * sum(got[0]) / len(got[0])
