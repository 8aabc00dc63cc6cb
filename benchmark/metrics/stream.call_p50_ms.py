"""stream.call_p50_ms: the streaming detector's call on the host clock,
from the call's start to its detections on the host (the copy in, flip,
letterbox, forward, prefilter, K1 and the copy out), the median over every
request of the run: the time a request takes once it is served, without
its wait in the queue."""

import numpy as np

UNIT = "ms"
LAYER = "streaming detector call"
MOVES = "serve_p95_ms"
READS = ("the host clock around each request's call",)


def read(view, ctx):
    calls = view["call_ms"]
    return float(np.median(calls)) if len(calls) else None
