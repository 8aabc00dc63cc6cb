"""The port's profiling helpers and stem probe against the JAX package, on
the CPU.

- `StepTimer.summary()` equals the JAX `StepTimer`'s on the same recorded
  times; `trace` and `annotate` write a Chrome trace holding the region.
- `profile_stages.stem_forward` at upto 26 / 43 / 52 equals the three
  routes of the JAX `_backbone_forward` (`models/yolov3.py`) at 64^2 in
  fp32, with the weights carried across by `from_jax_variables`: atol 1e-5
  on each route divided by its largest magnitude. The frameworks sum a
  conv's products in different orders; the residual adds grow the deep
  routes to |x| ~ 10, where an fp32 ulp is ~1e-6 and the two differ by up
  to 1.6e-5 (16 ulps, 2e-6 of the route's scale); route 26 (|x| ~ 2)
  differs by 2.6e-6.
"""

import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov3_tensorflow_tpu.models import layers as jl
from yolov3_tensorflow_tpu.models import yolov3 as jy
from yolov3_tensorflow_tpu.utils import profiling as jprof
from yolov3_tensorflow_tpu_torch.models.convert import from_jax_variables
from yolov3_tensorflow_tpu_torch.models.yolov3 import (BACKBONE_PLAN,
                                                       fold_batch_norm)
from yolov3_tensorflow_tpu_torch.scripts import profile_stages
from yolov3_tensorflow_tpu_torch.testing import numpy_variables
from yolov3_tensorflow_tpu_torch.utils import profiling

CPU = torch.device("cpu")
SIZE = 64


@pytest.mark.parametrize("window", [500, 4])
def test_step_timer_summary_equals_jax(window):
    times = np.random.default_rng(window).uniform(0.001, 0.05, 9).tolist()
    port, ref = profiling.StepTimer(window), jprof.StepTimer(window)
    assert port.summary() == ref.summary() == {"count": 0}
    for t in times:
        port.record(t)
        ref.record(t)
    assert port.summary() == ref.summary()
    assert port.summary()["count"] == min(window, len(times))


def test_step_timer_times_a_step_on_the_cpu():
    timer = profiling.StepTimer()
    x = torch.ones(8)
    for _ in range(3):
        with timer.step(result={"y": [x * 2, (x + 1,)]}):
            x = x + 1
    s = timer.summary()
    assert s["count"] == 3 and s["last_ms"] >= 0.0
    assert set(s) == {"count", "mean_ms", "p50_ms", "p95_ms", "last_ms"}


def test_trace_and_annotate_write_a_trace(tmp_path):
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.annotate("port_region"):
            torch.ones(16).sum()
    files = glob.glob(os.path.join(str(tmp_path), "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "port_region" for e in events)
    assert any(e.key == "port_region" for e in prof.key_averages())


def test_cuda_ms_refuses_to_time_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        profiling.cuda_ms(lambda: None, 1)
    with pytest.raises(RuntimeError):
        profiling.device_busy_ms(lambda: None, 1)


@pytest.mark.parametrize("spans,want", [
    ([], 0.0),
    ([(0.0, 2.0), (5.0, 6.0)], 3.0),          # apart
    ([(0.0, 4.0), (1.0, 2.0)], 4.0),          # one inside the other
    ([(3.0, 7.0), (0.0, 4.0), (6.0, 9.0)], 9.0),   # chained, out of order
])
def test_device_busy_counts_overlapping_work_once(spans, want):
    assert profiling.union_length(spans) == want


@pytest.fixture(scope="module")
def routes():
    """(JAX routes, port folded params, images) at 64^2, fp32."""
    variables = numpy_variables(80, seed=5)
    folded = jy.fold_batch_norm(variables, dtype=jnp.float32)
    images = np.random.default_rng(5).uniform(
        0, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    bb = folded["backbone"]

    @jax.jit
    def backbone(im):
        return jy._backbone_forward(
            lambda i, x, s: jl.conv_folded(x, bb[f"conv_{i}"], stride=s,
                                           compute_dtype=jnp.float32), im)

    want = [np.asarray(r) for r in backbone(jnp.asarray(images))]
    port = fold_batch_norm(from_jax_variables(variables, device=CPU),
                           dtype=torch.float32)
    return want, port, torch.from_numpy(images)


@pytest.mark.parametrize("route,upto", [(0, 26), (1, 43), (2, 52)])
def test_stem_forward_equals_jax_routes(route, upto, routes):
    want, port, images = routes
    got = profile_stages.stem_forward(port, images, upto,
                                      compute_dtype=torch.float32)
    assert got.shape == want[route].shape
    scale = np.abs(want[route]).max()
    assert 1.0 < scale < 20.0
    np.testing.assert_allclose(got.numpy() / scale, want[route] / scale,
                               rtol=0, atol=1e-5)


def test_stem_forward_stops_before_conv_upto(routes):
    _, port, images = routes
    n_convs = sum(1 for op in BACKBONE_PLAN if op[0] == "conv")
    assert n_convs == 52 == profile_stages.STEM_UPTO[-1]
    assert torch.equal(profile_stages.stem_forward(port, images, 0,
                                                   compute_dtype=torch.float32),
                       images)
    x = profile_stages.stem_forward(port, images, 2,
                                    compute_dtype=torch.float32)
    assert x.shape == (2, SIZE // 2, SIZE // 2, 64)


def test_profile_needs_a_gpu():
    with pytest.raises(RuntimeError):
        profile_stages.profile({}, 2, (64, 64), device=CPU)
