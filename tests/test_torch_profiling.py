"""The port's profiling helpers and stem probe against the JAX package, on
the CPU.

- `StepTimer.summary()` equals the JAX `StepTimer`'s on the same recorded
  times; `trace` and `annotate` write a Chrome trace holding the region.
- `annotate` off makes no CUDA event and enters no `record_function`;
  inside `recording()` it keeps the spans' order and nesting (host stamps
  on the CPU; events resolved against the origin with a stand-in CUDA);
  the packed detector's outputs and the train step's new state and
  metrics are bit-equal with recording on and off, and carry their spans.
- `profile_stages.stem_forward` at upto 26 / 43 / 52 equals the three
  routes of the JAX `_backbone_forward` (`models/yolov3.py`) at 64^2 in
  fp32, with the weights carried across by `from_jax_variables`: atol 1e-5
  on each route divided by its largest magnitude. The frameworks sum a
  conv's products in different orders; the residual adds grow the deep
  routes to |x| ~ 10, where an fp32 ulp is ~1e-6 and the two differ by up
  to 1.6e-5 (16 ulps, 2e-6 of the route's scale); route 26 (|x| ~ 2)
  differs by 2.6e-6.
"""

import contextlib
import glob
import json
import os
import time

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
from yolov3_tensorflow_tpu_torch.testing import (CPU_TEST_THREADS,
                                                 numpy_variables)
from yolov3_tensorflow_tpu_torch.utils import profiling

torch.set_num_threads(CPU_TEST_THREADS)

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


def _no_event_no_range(monkeypatch):
    def refuse(*args, **kw):
        raise AssertionError("annotate made a CUDA event or a range")
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)


def test_annotate_off_makes_no_event_and_no_range(monkeypatch):
    _no_event_no_range(monkeypatch)
    assert profiling._state is None
    for _ in range(2):
        with profiling.annotate("off") as got:
            assert got is None
    with pytest.raises(KeyError):
        with profiling.annotate("off"):
            raise KeyError("an error inside a span goes through")


def test_recording_keeps_order_and_nesting_on_the_cpu(monkeypatch):
    _no_event_no_range(monkeypatch)
    with profiling.recording() as rec:
        with profiling.annotate("a"):
            with profiling.annotate("a.b"):
                pass
            with profiling.annotate("a.c"):
                with profiling.annotate("a.c.d"):
                    pass
        with profiling.annotate("e"):
            pass
    with profiling.annotate("after"):          # off again
        pass
    spans = rec.spans()
    assert [(s.name, s.depth) for s in spans] == [
        ("a", 0), ("a.b", 1), ("a.c", 1), ("a.c.d", 2), ("e", 0)]
    assert all(s.device is None for s in spans)
    host = {s.name: s.host for s in spans}
    for outer, inner in (("a", "a.b"), ("a", "a.c"), ("a.c", "a.c.d")):
        assert host[outer][0] <= host[inner][0] <= host[inner][1] \
            <= host[outer][1]
    assert host["a.b"][1] <= host["a.c"][0] and host["a"][1] <= host["e"][0]
    assert profiling._state is None


def test_recording_inside_a_trace_and_back(monkeypatch):
    """The innermost block decides; each restores what it found."""
    entered = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: entered.append(name)
                        or contextlib.nullcontext())
    monkeypatch.setattr(profiling.torch.profiler, "profile",
                        lambda **kw: contextlib.nullcontext())
    monkeypatch.setattr(torch.profiler, "tensorboard_trace_handler",
                        lambda d: None)
    with profiling.trace("unused"):
        with profiling.annotate("traced"):
            pass
        with profiling.recording() as rec:
            with profiling.annotate("recorded"):
                pass
        with profiling.annotate("traced again"):
            pass
    assert entered == ["traced", "traced again"]
    assert [s.name for s in rec.spans()] == ["recorded"]
    assert profiling._state is None


class _FakeEvent:
    """A CUDA event on a stand-in device clock: record() stamps the clock's
    next tick (ms)."""
    clock = [0.0]
    made = []

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.at = None
        _FakeEvent.made.append(self)

    def record(self):
        _FakeEvent.clock[0] += 1.0
        self.at = _FakeEvent.clock[0]

    def elapsed_time(self, other):
        return other.at - self.at


def test_recording_resolves_events_against_its_origin(monkeypatch):
    """With a CUDA device each span records an event at entry and exit,
    drawn from the pool made (and recorded once) at open, doubled when it
    runs out; spans() synchronizes and gives each span's events in ms from
    the origin."""
    synced = []
    _FakeEvent.clock, _FakeEvent.made = [0.0], []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: synced.append(1))
    monkeypatch.setattr(profiling, "POOL", 5)
    with profiling.recording() as rec:
        # the pool's 5 first records (creation), then the origin at tick 6
        with profiling.annotate("outer"):          # ticks 7 and 10
            with profiling.annotate("inner"):      # ticks 8 and 9
                pass
    assert len(_FakeEvent.made) == 5
    assert not synced
    spans = rec.spans()
    assert synced
    assert [(s.name, s.depth, s.device) for s in spans] == [
        ("outer", 0, (1.0, 4.0)), ("inner", 1, (2.0, 3.0))]
    # a pool of one doubles as the spans need more (1 + 4 events: 8 made),
    # its new events recorded at their first use only
    _FakeEvent.made = []
    monkeypatch.setattr(profiling, "POOL", 1)
    with profiling.recording() as rec:
        with profiling.annotate("outer"):          # ticks 3 and 6
            with profiling.annotate("inner"):      # ticks 4 and 5
                pass
    assert len(_FakeEvent.made) == 8
    assert [s.device for s in rec.spans()] == [(1.0, 4.0), (2.0, 3.0)]


@pytest.fixture(scope="module")
def spans_setup():
    """A packed detector and a train step (device label encoding) at 64^2,
    fp32, on the CPU, with their inputs."""
    from yolov3_tensorflow_tpu_torch.config import DEFAULT_ANCHORS, Config
    from yolov3_tensorflow_tpu_torch.models.convert import spread_head
    from yolov3_tensorflow_tpu_torch.ops.postprocess import build_detector
    from yolov3_tensorflow_tpu_torch.train.optimizers import build_optimizer
    from yolov3_tensorflow_tpu_torch.train.schedules import fixed
    from yolov3_tensorflow_tpu_torch.train.trainer import make_train_step
    classes = 4
    cfg = Config()
    cfg.model.num_classes = classes
    cfg.model.compute_dtype = "float32"
    cfg.anchors = np.asarray(DEFAULT_ANCHORS, np.float32)
    variables = from_jax_variables(spread_head(numpy_variables(classes,
                                                               seed=3),
                                               seed=3), device=CPU)
    det = build_detector(variables, np.asarray(cfg.anchors, np.float32),
                         classes, (SIZE, SIZE), device=CPU, mode="packed",
                         max_out=16, box_topk=32, score_thresh=0.3,
                         iou_thresh=0.45, compute_dtype=torch.float32)
    opt = build_optimizer("momentum", fixed(1e-3))
    step = make_train_step(cfg, opt, fixed(1e-3), device_encode=True)
    state = {"params": variables["params"],
             "batch_stats": variables["batch_stats"],
             "opt_state": opt.init(variables["params"]), "step": 0}
    g = torch.Generator().manual_seed(3)
    images = torch.rand((2, SIZE, SIZE, 3), generator=g)
    boxes = torch.tensor([[[4., 6., 30., 40., 1.], [20., 8., 60., 50., 1.]],
                          [[10., 10., 50., 44., 1.], [0., 0., 0., 0., 0.]]])
    gt = (boxes, torch.tensor([[1, 3], [2, 0]]),
          torch.tensor([[True, True], [True, False]]))
    return det, step, state, images, gt


def _equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b)
    else:
        assert a == b


def test_packed_detector_bit_equal_with_recording(spans_setup):
    det, _, _, images, _ = spans_setup
    off = det(images)
    with profiling.recording() as rec:
        on = det(images)
    _equal(off, on)
    assert off["valid"].any()
    assert [(s.name, s.depth) for s in rec.spans()] == [
        ("packed.forward", 0), ("packed.postprocess", 0)]


def test_train_step_bit_equal_with_recording(spans_setup):
    _, step, state, images, gt = spans_setup
    new_off, metrics_off = step(state, images, gt)
    with profiling.recording() as rec:
        new_on, metrics_on = step(state, images, gt)
    _equal(new_off, new_on)
    _equal(metrics_off, metrics_on)
    assert torch.isfinite(metrics_on["total"])
    assert [(s.name, s.depth) for s in rec.spans()] == [
        ("train_step", 0), ("train_step.encode", 1),
        ("train_step.forward", 1), ("train_step.loss", 1),
        ("train_step.backward", 1), ("train_step.update", 1)]


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


SPIN = "at::cuda::(anonymous namespace)::spin_kernel(long)"


MARK = profiling.MARK_MS * 1e3
SPAN = 2 * MARK + 9                       # the markers and the calls, us


def _events(guard_us, lead=True, trail=True, stretch=1.0):
    """A profiler session's device events as `_session` sees them: the
    guard spin, a marker, two calls' kernels (one overlapping a copy), a
    marker, SPAN us from the first marker's start to the second's end on
    the device; the profiler's clock runs `stretch` times the device's."""
    t0 = guard_us
    ev = [(SPIN, 0.0, guard_us)]
    spans = [("k", MARK + 1, MARK + 4), ("copy", MARK + 3, MARK + 5),
             ("k", MARK + 7, MARK + 8)]
    if lead:
        spans.insert(0, (SPIN, 0.0, MARK))
    if trail:
        spans.append((SPIN, MARK + 9, SPAN))
    ev += [(name, t0 + lo * stretch, t0 + hi * stretch)
           for name, lo, hi in spans]
    return ev


@pytest.mark.parametrize("lead,trail", [(True, True), (False, True),
                                        (True, False), (False, False)])
def test_marked_events_need_both_markers(lead, trail):
    guard = 40e3
    got = profiling.marked_events(_events(guard, lead, trail), guard, SPAN)
    if lead and trail:
        assert [e[0] for e in got] == ["k", "copy", "k"]
    else:
        assert got is None
    # a session whose guard was dropped, markers kept, is whole
    assert profiling.marked_events(_events(guard)[1:], guard, SPAN) \
        is not None


def test_marked_events_rescale_to_the_device_clock():
    """A profiler clock running 3% fast stretches every span by 3%; the
    device's time across the markers takes it back."""
    guard = 40e3
    got = profiling.marked_events(_events(guard, stretch=1.03), guard, SPAN)
    spans = [(lo - guard - MARK, hi - guard - MARK) for _, lo, hi in got]
    np.testing.assert_allclose(spans, [(1, 4), (3, 5), (7, 8)], atol=1e-6)
    assert profiling.union_length(spans) == pytest.approx(5.0)


def _stub_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)


def test_settle_teardown_launches_and_synchronises_until_settle_ms(
        monkeypatch):
    """After a session: short launches, each followed by a synchronise,
    until SETTLE_MS has passed; the longest launch and synchronise (here a
    hold of 4 ms in the third) is returned."""
    log = []

    def synchronize(device=None):
        log.append("sync")
        if log.count("sync") == 3:
            time.sleep(0.004)
    monkeypatch.setattr(torch.cuda, "_sleep",
                        lambda cycles: log.append(("spin", cycles)))
    monkeypatch.setattr(torch.cuda, "synchronize", synchronize)
    monkeypatch.setattr(profiling, "SETTLE_MS", 20.0)
    t0 = time.perf_counter()
    longest = profiling.settle_teardown()
    assert time.perf_counter() - t0 >= 0.020
    assert 4.0 <= longest < 20.0
    assert len(log) >= 6 and log[::2] == [
        ("spin", profiling.SETTLE_SPIN)] * (len(log) // 2)
    assert log[1::2] == ["sync"] * (len(log) // 2)


def test_device_events_rerun_with_a_longer_guard(monkeypatch):
    """A session that lost a marker runs again with a guard GUARD_GROWTH
    times longer; the busy time is the union of the session's events
    (without the spins, on the device's clock) per call."""
    _stub_cuda(monkeypatch)
    guards = []

    def session(fn, iters, guard_ms, record_ranges):
        guards.append(guard_ms)
        return (_events(guard_ms * 1e3, lead=len(guards) > 1, stretch=1.1),
                SPAN / 1e3)

    monkeypatch.setattr(profiling, "_session", session)
    calls = []
    assert profiling.device_busy_ms(lambda: calls.append(1), 2) == \
        pytest.approx(5.0 / 1e3 / 2)
    assert calls == [1, 1, 1]             # the untimed calls
    assert guards == [profiling.GUARD_MS,
                      profiling.GUARD_MS * profiling.GUARD_GROWTH]


def test_device_timeline_gives_the_calls_time_between_the_markers(
        monkeypatch):
    """Beside the events, the device's time from the first marker's end to
    the second's start, on the rescaled clock: the events' union (5 us)
    falls short of it (9 us) by the gaps between them."""
    _stub_cuda(monkeypatch)
    monkeypatch.setattr(profiling, "_session",
                        lambda fn, iters, guard_ms, record_ranges: (
                            _events(guard_ms * 1e3, stretch=1.1), SPAN / 1e3))
    events, calls_us = profiling.device_timeline(lambda: None, 2)
    assert [e[0] for e in events] == ["k", "copy", "k"]
    assert calls_us == pytest.approx(9.0)
    assert profiling.union_length([e[1:] for e in events]) == \
        pytest.approx(5.0)
    assert profiling.device_events(lambda: None, 2) == events


def test_device_events_raise_when_every_session_loses_a_marker(monkeypatch):
    _stub_cuda(monkeypatch)
    guards = []

    def session(fn, iters, guard_ms, record_ranges):
        guards.append(guard_ms)
        return _events(guard_ms * 1e3, trail=False), SPAN / 1e3

    monkeypatch.setattr(profiling, "_session", session)
    with pytest.raises(RuntimeError, match="dropped"):
        profiling.device_events(lambda: None, 1)
    assert len(guards) == profiling.SESSION_TRIES


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


def test_k1_phases_from_stamps():
    """K1's phase stamps (K1_PHASES layout: globaltimer ns at entry and
    exit, clock64 at entry, after load, mask, share, classes and at exit)
    become the span and each phase's mean and largest time over the CTAs,
    cycles at 2 GHz."""
    from yolov3_tensorflow_tpu_torch.scripts.k1_phases import phases
    stamps = np.array([[1000, 0, 2000, 4000, 5000, 9000, 9500, 9000],
                       [1500, 0, 1000, 3000, 3100, 3200, 3300, 7000]],
                      np.uint64)
    got = phases(stamps, 2.0)
    assert got["span_us"] == 8.0
    assert got["mean_us"] == {"load": 0.75, "mask": 1.0, "share": 0.275,
                              "classes": 1.025, "exit": 0.15}
    assert got["max_us"] == {"load": 1.0, "mask": 1.0, "share": 0.5,
                             "classes": 2.0, "exit": 0.25}


def test_stage_hold_follows_the_call_host_time(monkeypatch):
    """profile_stages.stage_ms times through cuda_ms, which holds the
    stream for twice a call's host-inclusive time (at least
    HOST_MS_PER_CALL): a call whose host time is long gets a longer _sleep
    than a short one. torch.cuda is stubbed: the device is present, events
    read 0 ms, _sleep records its cycles."""
    holds = []

    class Event:
        def __init__(self, enable_timing=False):
            pass

        def record(self):
            pass

        def elapsed_time(self, other):
            return 0.0

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "_sleep", holds.append)
    iters = 4
    for host_s in (0.0, 0.004, 0.020):
        profile_stages.stage_ms("stage", lambda s=host_s: time.sleep(s),
                                iters)
    floor, short, long = holds
    # cycles at 2 GHz: iters * hold ms * 2e6; a host sleep lasts at least
    # what it asks for
    assert int(iters * profiling.HOST_MS_PER_CALL * 2e6) <= floor < short
    assert short < long
    assert short >= int(iters * 2 * 4.0 * 2e6)
    assert long >= int(iters * 2 * 20.0 * 2e6)


def test_differential_ms_takes_the_least_of_each_total(monkeypatch):
    """Noise in one short run does not pull the differential low: each
    total T(n) is the least of its readings before the difference. On a
    host clock where every call takes 1 ms and the first call of the
    first T(2) 5 ms more, the least of the differences would read
    (6 - 7) / 4 < 0 ms; the least of each total reads 1 ms."""
    clock, calls = [0.0], [0]

    def fn():
        calls[0] += 1
        clock[0] += 1e-3 + (5e-3 if calls[0] == 2 else 0.0)

    monkeypatch.setattr(profiling.time, "perf_counter", lambda: clock[0])
    ms = profiling.differential_ms(fn, CPU, 2, 6)
    assert calls[0] == 1 + 3 * (2 + 6)
    assert ms == pytest.approx(1.0, rel=1e-9)


def test_profile_needs_a_gpu():
    with pytest.raises(RuntimeError):
        profile_stages.profile({}, 2, (64, 64), device=CPU)
