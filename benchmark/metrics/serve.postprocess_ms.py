"""serve.postprocess_ms: the packed postprocess's device time a batch: the
mean device length of the program's `packed.postprocess` spans (score,
top-k, gather and decode, K1 and compaction), one a traced batch
(`benchmark.spans`)."""

from benchmark import spans

UNIT = "ms"
LAYER = "packed postprocess"
MOVES = "serve_img_per_s"
READS = ("device lengths of the packed.postprocess spans in the traced "
         "part",)


def read(view, ctx):
    got = spans.lengths(view, ctx, "packed.postprocess")
    if got is None:
        return None
    return 1e3 * sum(got[0]) / len(got[0])
