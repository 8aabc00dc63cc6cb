"""serve.k1_roofline: the shared-candidate NMS kernel K1's share of its
roofline: the sum of `bound_nms_shared(B, K, C)` over the traced launches
over the sum of the kernel's device time in the trace. The launches in the
trace must equal the program's own counter
(`nms_keep_mask_shared.launches`) and the traced calls, one a call."""

from benchmark import costs
from benchmark.trace import kernel_seconds

UNIT = "%"
LAYER = "shared-candidate NMS K1"
MOVES = "serve_img_per_s"
READS = ("device events named nms_shared_kernel",
         "nms_keep_mask_shared.launches over the traced calls")
KERNEL = "nms_shared_kernel"


def read(view, ctx):
    seconds, launches = kernel_seconds(view["tracer"], KERNEL)
    if launches == 0:
        return None
    if not launches == view["k1_launches"] == view["k1_calls"]:
        raise RuntimeError(
            f"K1: {launches} launches traced, the program counted "
            f"{view['k1_launches']}, {view['k1_calls']} calls were traced")
    bound_ms, _ = costs.bound_nms_shared(*view["k1_shape"])
    return 100.0 * launches * bound_ms / 1e3 / seconds
