"""The readers of the program's spans (`benchmark/spans.py`): their
arithmetic on hand-made span traces, their refusal of a span count that
is not one a traced batch or step, nothing read from a program without
spans, `breakdown` naming a gap by the program span around it, and the
traced part replayed by each cell's own loop at a size the CPU holds.
On the card (`-m cuda`): the spans on the trace's clock, and a traced run
of each cell reporting every metric of its spans.

    python -m pytest benchmark/tests/test_bench_spans.py -q [-m cuda]
"""

import contextlib
import json
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

from benchmark import costs, harness, spans
from benchmark.tests.tiny import CELLS, run_cell
from benchmark.trace import Tracer, breakdown

SPEC = harness.load_spec()
SERVE = {"height": 416, "width": 416, "num_classes": 80}
TRAIN = {"height": 416, "width": 416, "num_classes": 20}
TRAIN_CHILDREN = ("encode", "forward", "loss", "backward", "update")


def span_tracer(rows):
    t = spans.SpanTracer()
    t.spans = list(rows)
    return t


def serve_view(batches=2, batch=128):
    """Batches of 10 ms forward, 1 ms postprocess on the device (us)."""
    rows = []
    for i in range(batches):
        t = i * 20e3
        rows += [("packed.forward", t, t + 10e3, t, t + 3e3),
                 ("packed.postprocess", t + 10e3, t + 11e3, t + 3e3,
                  t + 4e3)]
    view = {"images": batches * batch,
            "spans": span_tracer(rows)}
    return view, SimpleNamespace(config=SERVE, traffic={"batch": batch})


def train_view(steps=3, batch=64):
    """Steps of 200 ms on the device, 150 ms on the host: encode 2,
    forward 60, loss 8, backward 120, update 9 ms (us)."""
    length = {"encode": 2e3, "forward": 60e3, "loss": 8e3,
              "backward": 120e3, "update": 9e3}
    rows = []
    for i in range(steps):
        t = i * 250e3
        rows.append(("train_step", t, t + 200e3, t, t + 150e3))
        d = t
        for child in TRAIN_CHILDREN:
            rows.append((f"train_step.{child}", d, d + length[child], t, t))
            d += length[child]
    view = {"images": steps * batch,
            "spans": span_tracer(rows)}
    return view, SimpleNamespace(config=TRAIN, traffic={"batch": batch})


def read(name, view, ctx):
    return harness.metric_reader(name).read(view, ctx)


NEW = [m["name"] for m in SPEC["per_layer"] if m["source"] == "program_span"]


def test_the_new_entries_read_spans():
    assert sorted(NEW) == sorted([
        "serve.forward_mfu", "serve.postprocess_ms", "train.forward_mfu",
        "train.backward_mfu", "train.encode_ms", "train.loss_ms",
        "train.update_ms", "train.dispatch_ms"])
    for m in SPEC["per_layer"]:
        if m["name"] in NEW:
            assert m["workloads"] == (["coco416-offline-b128"]
                                      if m["name"].startswith("serve.")
                                      else ["voc416-train-b64"])


def test_serve_readers():
    view, ctx = serve_view()
    flops = costs.forward_flops(416, 416, 80)
    assert read("serve.forward_mfu", view, ctx) == pytest.approx(
        100 * flops * 256 / 20e-3 / 989e12)
    assert read("serve.postprocess_ms", view, ctx) == pytest.approx(1.0)


def test_train_readers():
    view, ctx = train_view()
    fwd = costs.forward_flops(416, 416, 20)
    assert read("train.forward_mfu", view, ctx) == pytest.approx(
        100 * fwd * 192 / 180e-3 / 989e12)
    assert read("train.backward_mfu", view, ctx) == pytest.approx(
        100 * 2 * fwd * 192 / 360e-3 / 989e12)
    assert read("train.encode_ms", view, ctx) == pytest.approx(2.0)
    assert read("train.loss_ms", view, ctx) == pytest.approx(8.0)
    assert read("train.update_ms", view, ctx) == pytest.approx(9.0)
    assert read("train.dispatch_ms", view, ctx) == pytest.approx(150.0)


@pytest.mark.parametrize("name", NEW)
def test_a_reader_refuses_a_span_count_that_disagrees(name):
    view, ctx = (serve_view if name.startswith("serve.") else
                 train_view)()
    # each reader's own span name missing once, or doubled once
    span = {"serve.forward_mfu": "packed.forward",
            "serve.postprocess_ms": "packed.postprocess",
            "train.dispatch_ms": "train_step"}.get(
        name, "train_step." + name.split(".")[1].rsplit("_", 1)[0])
    rows = view["spans"].spans
    first = next(r for r in rows if r[0] == span)
    for wrong in ([r for r in rows if r is not first], rows + [first]):
        view["spans"] = span_tracer(wrong)
        with pytest.raises(RuntimeError, match="spans"):
            read(name, view, ctx)


@pytest.mark.parametrize("name", NEW)
def test_no_spans_without_recording(name, monkeypatch):
    """A program without `recording` (an older checkout): no replay is
    built and every reader reads nothing."""
    from yolov3_tensorflow_tpu_torch.utils import profiling

    def refuse(*a, **k):
        raise AssertionError("the replay ran without spans to read")
    cell = ("coco416-offline-b128" if name.startswith("serve.")
            else "voc416-train-b64")
    ctx = SimpleNamespace(traffic=harness.resolve(SPEC, cell)["traffic"],
                          config={}, device=torch.device("cpu"))
    reader = harness.metric_reader(name)
    monkeypatch.delattr(profiling, "recording")
    monkeypatch.setattr(harness, "load_module", refuse)
    view = {"images": 128}
    assert reader.read(view, ctx) is None
    assert view["spans"] is None


def test_breakdown_names_a_gap_by_the_program_span():
    t = Tracer()
    t.window = (0.0, 1e6)
    t.window_s = 1.0
    t.device = [("k", 0, 2e5), ("k", 3e5, 6e5), ("k", 6.5e5, 1e6)]
    t.host = [("bench.step", 0, 9e5), ("train_step", 1e4, 8e5),
              ("train_step.backward", 1.5e5, 4e5)]
    gaps = dict(breakdown(t)["idle_gaps"])
    assert gaps == {"train_step.backward": pytest.approx(0.1),
                    "train_step": pytest.approx(0.05)}


@contextlib.contextmanager
def host_session(self):
    """SpanTracer.session without a card: the recording alone, each span
    on the host clock (us)."""
    from yolov3_tensorflow_tpu_torch.utils import profiling
    self._spans = []
    with profiling.recording() as rec:
        yield self
    self._spans = None
    self.spans = [(s.name, s.host[0] * 1e6, s.host[1] * 1e6,
                   s.host[0] * 1e6, s.host[1] * 1e6) for s in rec.spans()]


@pytest.mark.parametrize("cell", CELLS)
def test_the_traced_part_replays_with_spans(cell, monkeypatch):
    """Each cell's loop runs its traced part again under a SpanTracer
    (here its session without the device trace): one span of each name a
    traced batch or step, and the run's own checks left as they were."""
    monkeypatch.setattr(spans.SpanTracer, "session", host_session)
    ctx, _ = run_cell(cell)
    checks = ctx.checks.as_dict()
    tr = ctx.traffic
    # the offline loop takes one batch past its count
    traced = (tr["trace_batches"] + 1 if "trace_batches" in tr
              else tr["trace_steps"])
    view = {"images": traced * tr["batch"]}
    names = [m["name"] for m in SPEC["per_layer"] if m["name"] in NEW
             and cell in m["workloads"]]
    for name in names:
        assert harness.metric_reader(name).read(view, ctx) > 0
    assert ctx.checks.as_dict() == checks
    got = [s[0] for s in view["spans"].spans]
    if cell.startswith("coco"):
        assert got == ["packed.forward", "packed.postprocess"] * traced
    else:
        assert got == (["train_step"] + [f"train_step.{c}" for c in
                                         TRAIN_CHILDREN]) * traced


def _card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the spans' clock is the card's")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_spans_on_the_trace_clock():
    """Every kernel of a call lies inside the device interval of the span
    it was launched in, to 5 us; the trace holds the same device event
    names with and without spans, and none named after a span."""
    from yolov3_tensorflow_tpu_torch.ops.postprocess import build_detector

    from benchmark import scenes, weights
    device = _card()
    cfg = harness.read_json(harness.ROOT / "benchmark/configs/"
                            "yolov3-coco-416.json")
    s = cfg["serving"]
    variables = weights.draw(2147483659, 80, device, spread=True)
    det = build_detector(variables, torch.tensor(cfg["anchors"]).numpy(),
                         80, (416, 416), device=device, mode="packed",
                         max_out=s["max_out"], box_topk=s["box_topk"],
                         score_thresh=s["score_thresh"],
                         iou_thresh=s["iou_thresh"])
    gen = weights.generator(2147483659, device, stream=1)
    images = scenes.to_rgb_float(scenes.draw(
        gen, 16, (416, 416), num_classes=80, boxes_min=1,
        boxes_max=8)["images"])
    for _ in range(3):
        det(images)
    torch.cuda.synchronize()
    names = []
    for tracer in (Tracer(), spans.SpanTracer()):
        with tracer.session():
            for _ in range(4):
                det(images)
        names.append({n for n, _, _ in tracer.device})
    assert names[0] == names[1]
    assert not names[1] & {"packed.forward", "packed.postprocess"}
    got = tracer.spans
    assert [n for n, *_ in got] == ["packed.forward",
                                    "packed.postprocess"] * 4
    tol = 5.0
    for name, lo, hi in tracer.device:
        inside = [n for n, d0, d1, _, _ in got
                  if d0 - tol <= lo and hi <= d1 + tol]
        assert inside, (name, lo, hi)
        if "nms_shared_kernel" in name:
            assert inside == ["packed.postprocess"]
    # each span's host interval is on the trace's clock, and began before
    # its device interval could
    for _, d0, _, h0, _ in got:
        assert h0 <= d0 + tol


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_reports_every_span_metric(cell):
    _card()
    out = subprocess.run([sys.executable, "-m", "benchmark.run",
                          "--workload", cell, "--seed", "2147483659",
                          "--seconds", "3", "--trace", "1"],
                         cwd=harness.ROOT, capture_output=True, text=True,
                         timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    want = {m["name"] for m in SPEC["per_layer"]
            if cell in m.get("workloads", [cell])}
    assert want <= set(line["metrics"]), line["metrics"]
    assert line["correct"], line["checks"]
