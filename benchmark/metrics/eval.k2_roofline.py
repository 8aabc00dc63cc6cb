"""eval.k2_roofline: the per-group NMS kernel K2's share of its roofline:
the sum of `bound_nms(G, K, pairs)` over the traced launches, the IoU
tests (`nms_pairs`) counted from the reference's own per-class candidates
and NMS on the same images, over the sum of the kernel's device time in
the trace. The launches in the trace must equal the program's own counter
(`nms_keep_mask.launches`) and the traced batches, one a batch."""

from benchmark import costs
from benchmark.trace import kernel_seconds

UNIT = "%"
LAYER = "per-group NMS K2"
MOVES = "eval_img_per_s"
READS = ("device events named nms_kernel",
         "nms_keep_mask.launches over the traced batches",
         "the reference's valid and kept candidates of each traced group")
KERNEL = "nms_kernel"


def read(view, ctx):
    seconds, launches = kernel_seconds(view["tracer"], KERNEL)
    if launches == 0:
        return None
    if not launches == view["k2_launches"] == view["k2_calls"]:
        raise RuntimeError(
            f"K2: {launches} launches traced, the program counted "
            f"{view['k2_launches']}, {view['k2_calls']} batches were traced")
    bound_ms = sum(costs.bound_nms(g, k, pairs)[0]
                   for g, k, pairs in view["k2_pairs"])
    return 100.0 * bound_ms / 1e3 / seconds
