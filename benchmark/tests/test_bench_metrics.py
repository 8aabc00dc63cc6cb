"""The metric arithmetic on hand-made traces, and the frozen cost model
against the program's own script."""

from types import SimpleNamespace

import pytest
import torch

from benchmark import costs, harness
from benchmark.trace import Tracer, breakdown, busy_s, marked, union_length


def tracer(events, window=(0.0, 1e6), host=()):
    t = Tracer()
    t.device = list(events)
    t.host = list(host)
    t.window = window
    t.window_s = (window[1] - window[0]) / 1e6
    return t


def ctx(config):
    return SimpleNamespace(config=config)


def test_union_counts_overlap_once():
    assert union_length([(0, 10), (5, 15), (20, 30)]) == 25
    assert union_length([]) == 0


def test_idle_share_from_a_trace():
    t = tracer([("a", 0, 2e5), ("b", 1e5, 4e5), ("copy", 5e5, 6e5)])
    assert busy_s(t) == pytest.approx(0.5)
    idle = harness.metric_reader("serve.idle_share").read({"tracer": t},
                                                          None)
    assert idle == pytest.approx(50.0)


def test_breakdown_names_gaps_by_host_range():
    t = tracer([("k", 0, 2e5), ("k", 6e5, 1e6)],
               host=[("bench.wait_copy", 1.5e5, 7e5),
                     ("bench.consume", 3e5, 5e5)])
    b = breakdown(t)
    assert b["device_ops"] == [["k", pytest.approx(0.6)]]
    assert b["idle_gaps"] == [["bench.wait_copy", pytest.approx(0.4)]]


def test_marker_rescale():
    events = [("spin_kernel", 0.0, 1000.0), ("k", 1500.0, 1600.0),
              ("spin_kernel", 2000.0, 2100.0)]
    origin, scale = marked(events, guard_us=40000.0, span_us=4200.0)
    assert (origin, scale) == (0.0, 2.0)
    assert marked(events[:2], 40000.0, 4200.0) is None


def test_forward_flops_match_the_program_script():
    from yolov3_tensorflow_tpu_torch.scripts import roofline
    for c in (80, 20):
        ours = costs.walk(4, 416, 416, c)
        theirs = roofline.walk(4, 416, 416, c)
        assert [r[1:] for r in ours] == [r[1:] for r in theirs]
        assert [r[1:] for r in costs.train_cost(ours)] == [
            r[1:] for r in roofline.train_cost(theirs)]
    assert costs.forward_flops(416, 416, 80) / 1e9 == pytest.approx(
        65.864, abs=5e-4)


def test_kernel_bounds_match_the_program_script():
    from yolov3_tensorflow_tpu_torch.scripts import roofline
    assert costs.bound_nms_shared(128, 64, 80) == roofline.bound_nms_shared(
        128, 64, 80)
    assert costs.bound_nms(160, 1024, 12345) == roofline.bound_nms(
        160, 1024, 12345)
    valid = torch.tensor([[True, True, False, True]])
    keep = torch.tensor([[True, False, False, True]])
    assert costs.nms_pairs(valid, keep) == roofline.nms_pairs(valid, keep)
    assert costs.H100_PEAKS == roofline.H100_PEAKS


def test_mfu_and_k1_roofline_readers():
    cfg = {"height": 416, "width": 416, "num_classes": 80}
    t = tracer([("void nms_shared_kernel<32>", 0, 10.0),
                ("void nms_shared_kernel<32>", 20.0, 30.0)],
               window=(0.0, 1e6))
    view = {"tracer": t, "images": 2000, "k1_calls": 2, "k1_launches": 2,
            "k1_shape": (128, 64, 80)}
    mfu = harness.metric_reader("serve.mfu").read(view, ctx(cfg))
    assert mfu == pytest.approx(100 * 65.864e9 * 2000 / 989e12, rel=1e-4)
    k1 = harness.metric_reader("serve.k1_roofline").read(view, ctx(cfg))
    bound_ms = costs.bound_nms_shared(128, 64, 80)[0]
    assert k1 == pytest.approx(100 * 2 * bound_ms / 1e3 / 20e-6)
    train = harness.metric_reader("train.mfu").read(view, ctx(
        dict(cfg, num_classes=20)))
    assert train == pytest.approx(100 * 3 * costs.forward_flops(
        416, 416, 20) * 2000 / 989e12)


def test_k1_reader_refuses_a_launch_count_that_disagrees():
    t = tracer([("nms_shared_kernel", 0, 10.0)])
    view = {"tracer": t, "k1_calls": 2, "k1_launches": 2,
            "k1_shape": (128, 64, 80)}
    with pytest.raises(RuntimeError):
        harness.metric_reader("serve.k1_roofline").read(view, None)


def test_k1_reader_reads_nothing_without_launches():
    view = {"tracer": tracer([("k", 0, 1.0)]), "k1_calls": 0,
            "k1_launches": 0, "k1_shape": (1, 1, 1)}
    assert harness.metric_reader("serve.k1_roofline").read(view,
                                                           None) is None
