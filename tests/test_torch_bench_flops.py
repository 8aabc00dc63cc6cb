"""The FLOP count of the port's train benchmarks against XLA's, on the CPU.

`scripts.bench_train` and `scripts.profile_train` take their FLOPs from the
roofline's walk of the forward (`scripts/roofline.py:walk`; three times it
for a train step), where the JAX scripts read XLA's cost analysis of their
compiled programs. Held here: the walk's forward FLOPs at 416x416, batch 1,
against `cost_analysis()["flops"]` of the JAX package's jitted
`yolov3_forward` lowered at the same shape (one compile, ~3 s), within 3%.
The walk is the larger (65.864 against 64.603 GFLOP): it counts every tap
of a padded 3x3 conv, also those that fall in the zero padding, which XLA
does not count. At 64x64 the border is a larger share and the gap grows to
18%, hence 416x416.
"""

import jax
import jax.numpy as jnp
import torch

from yolov3_tensorflow_tpu.models.yolov3 import init_yolov3, yolov3_forward
from yolov3_tensorflow_tpu_torch.scripts import bench_train, roofline
from yolov3_tensorflow_tpu_torch.testing import CPU_TEST_THREADS

torch.set_num_threads(CPU_TEST_THREADS)

SIZE = 416
RTOL = 0.03


def xla_forward_flops(size: int) -> float:
    variables = jax.eval_shape(lambda: init_yolov3(jax.random.PRNGKey(0), 80))
    images = jax.ShapeDtypeStruct((1, size, size, 3), jnp.float32)
    cost = jax.jit(lambda v, im: yolov3_forward(v, im)).lower(
        variables, images).compile().cost_analysis()
    if isinstance(cost, (list, tuple)):
        cost = cost[0]
    return float(cost["flops"])


def test_walk_flops_match_xla_at_416():
    xla = xla_forward_flops(SIZE)
    walk = sum(f for _, f, _ in roofline.walk(1, SIZE, SIZE))
    assert abs(walk - xla) <= RTOL * xla, (walk / 1e9, xla / 1e9)
    # the train benchmarks count three of these per step and image
    assert bench_train.model_flops(1, SIZE, 80) == 3 * walk
    assert bench_train.model_flops(8, SIZE, 80) == 3 * 8 * walk
