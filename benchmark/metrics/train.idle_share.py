"""train.idle_share: the share of the traced window in which the device ran
nothing (1 - the union of its intervals over the window)."""

from benchmark.trace import busy_s

UNIT = "%"
LAYER = "device"
MOVES = "train_img_per_s"
READS = ("every device event of the traced window",)


def read(view, ctx):
    return 100.0 * (1.0 - busy_s(view["tracer"]) / view["tracer"].window_s)
