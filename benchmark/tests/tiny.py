"""Each cell cut to a size the CPU runs in seconds: 64x64 inputs, a
batch of two. The widths stay the published ones."""

from benchmark import harness

# the training cell in float32 and one step: the comparison's semantics,
# free of the drift that batch norm over a few values gives bf16
# round-off at this size
TINY = {
    "coco416-offline-b128": {
        "config": {"height": 64, "width": 64},
        "traffic": {"batch": 2, "ring": 2, "sample": 64, "warm": 1}},
    "voc416-train-b64": {
        "config": {"height": 64, "width": 64, "compute_dtype": "float32"},
        "traffic": {"batch": 2, "pool": 3, "log_step": 2, "check_steps": 1,
                    "scene": {"boxes_min": 1, "boxes_max": 4}}},
}
# samples larger than a window's answers: every answer is compared, so
# that a planted fault shows whatever the window's length
CELLS = [w["name"] for w in harness.load_spec()["workloads"]]


def run_cell(workload, faults=(), seed=2 ** 31 + 77, seconds=0.5):
    return harness.run_here(workload, seed, seconds, device="cpu",
                            overrides=TINY[workload], faults=faults)
