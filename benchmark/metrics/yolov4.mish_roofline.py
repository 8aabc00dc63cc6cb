"""yolov4.mish_roofline: the conv epilogue's Mish instances' share of their
roofline: the bytes they move in the traced batches (the frozen
`costs_yolov4.mish_bytes` at the cell's batch, size and classes, once a
batch) at the card's 3.35 TB/s, over the sum of their device time in the
trace (kernels named conv_epilogue_mish_kernel). The launches in the
trace must equal the program's own count of its Mish launches
(`conv_epilogue.launches_by_mode`) and 72 a traced batch."""

from benchmark import costs, costs_yolov4
from benchmark.trace import kernel_seconds

UNIT = "%"
LAYER = "conv epilogue E1"
MOVES = "serve_img_per_s"
READS = ("device events named conv_epilogue_mish_kernel",
         "conv_epilogue.launches_by_mode over the traced batches")
KERNEL = "conv_epilogue_mish_kernel"
PER_FORWARD = 72


def read(view, ctx):
    seconds, launches = kernel_seconds(view["tracer"], KERNEL)
    if launches == 0:
        return None
    batches = view["images"] // view["batch"]
    if not launches == view["mish_launches"] == PER_FORWARD * batches:
        raise RuntimeError(
            f"E1 Mish: {launches} launches traced, the program counted "
            f"{view['mish_launches']}, {batches} batches were traced "
            f"({PER_FORWARD} each)")
    c = ctx.config
    moved = costs_yolov4.mish_bytes(view["batch"], c["height"], c["width"],
                                    c["num_classes"]) * batches
    return 100.0 * moved / costs.H100_PEAKS["hbm"] / seconds
