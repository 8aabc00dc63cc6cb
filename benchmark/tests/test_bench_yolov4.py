"""The YOLOv4 cell (`yolov4-coco608-offline-b64`) from its spec at a size
the CPU holds, and its yardsticks: the comparison true on the program's
path and false under each planted fault and under the float8 control,
the frozen cost walk against the cfg's count, the Mish epilogue's bytes
against the forward's own operands, and the reference's decode against
YOLOv3's where the two coincide.

    python -m pytest benchmark/tests/test_bench_yolov4.py -q
"""

import pytest
import torch

from benchmark import control_yolov4, costs_yolov4, harness, weights
from benchmark.drivers import offline_yolov4
from benchmark.reference import model, yolov4

CELL = "yolov4-coco608-offline-b64"
TINY = {"config": {"height": 64, "width": 96,
                   "spread_calibration_images": 2},
        "traffic": {"batch": 2, "ring": 2, "sample": 64, "warm": 1}}
SEED = 2 ** 31 + 77


def run(faults=()):
    return harness.run_here(CELL, SEED, 0.5, device="cpu", overrides=TINY,
                            faults=faults)


def test_the_cell_is_correct_on_the_program_path():
    ctx, out = run()
    assert ctx.checks.correct, ctx.checks.as_dict()
    assert set(out["metrics"]) == {"serve_img_per_s", "setup_s"}
    assert out["attempted"] >= 2 and out["failed"] == 0
    assert out["readings"]["sure"] > 0


@pytest.mark.parametrize("fault", offline_yolov4.FAULTS)
def test_a_planted_fault_is_not_correct(fault):
    ctx, _ = run(faults=(fault,))
    assert not ctx.checks.correct, ctx.checks.as_dict()


def test_the_float8_control_is_not_correct():
    got = control_yolov4.low_precision(SEED, torch.device("cpu"), TINY)
    limits = harness.resolve(harness.load_spec(), CELL)["traffic"]["limits"]
    assert any(got[k] > limits[k] for k in limits), got


def test_the_walk_is_the_cfg_at_608():
    rows = costs_yolov4.walk(1, 608, 608)
    assert len(rows) == 110
    assert costs_yolov4.forward_flops(608, 608) / 1e9 == pytest.approx(
        128.39, abs=0.005)
    convs = costs_yolov4.convs(1, 608, 608)
    assert sum(c["act"] == "mish" for c in convs) == 72
    assert sum(c["shortcut"] for c in convs) == 23


def test_mish_bytes_are_the_forwards_operands(monkeypatch):
    """At 64^2, the bytes of every Mish-mode epilogue call of the packed
    forward (y read and written, the bias, the shortcut) sum to the frozen
    count."""
    from yolov3_tensorflow_tpu_torch.models import layers
    from yolov3_tensorflow_tpu_torch.models import yolov4 as program
    from yolov3_tensorflow_tpu_torch.models.yolov3 import fold_batch_norm
    from yolov3_tensorflow_tpu_torch.ops import conv_epilogue as ce
    from yolov3_tensorflow_tpu_torch.ops import fast_postprocess as fp
    moved = []

    def counted(y, bias, *, shortcut=None, mish=False, **kw):
        if mish:
            moved.append(2 * y.numel() * y.element_size()
                         + bias.numel() * bias.element_size()
                         + (0 if shortcut is None else
                            shortcut.numel() * shortcut.element_size()))
        return ce.conv_epilogue(y, bias, shortcut=shortcut, mish=mish, **kw)
    monkeypatch.setattr(layers, "conv_epilogue", counted)
    v = program.init_yolov4(torch.Generator().manual_seed(0), 80,
                            device=torch.device("cpu"))
    tree = fp.pack_serving_head(fold_batch_norm(v), 80,
                                names=program.DETECTION_CONVS)
    with torch.inference_mode():
        program.yolov4_forward_packed(tree, torch.rand(2, 64, 64, 3))
    assert len(moved) == 72
    assert sum(moved) == costs_yolov4.mish_bytes(2, 64, 64)


def test_the_decode_is_yolov3s_at_scale_1():
    """With every scale_x_y 1 and YOLOv3's masks (6-8, 3-5, 0-2 for strides
    32, 16, 8), the YOLOv4 reference's rows are YOLOv3's `flat_rows`."""
    gen = weights.generator(5, "cpu", stream=1)
    maps = [torch.randn(2, 64 // s, 96 // s, 255, generator=gen)
            for s in (32, 16, 8)]
    anchors = [[10, 13], [16, 30], [33, 23], [30, 61], [62, 45], [59, 119],
               [116, 90], [156, 198], [373, 326]]
    layers = yolov4.layers(80)
    ones = [op[:2] + (1.0,) if op[0] == "yolo" else op for op in layers]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(yolov4, "layers", lambda num_classes: ones)
        got = yolov4.flat_rows(maps, anchors, (64, 96), 80)
    want = model.flat_rows(maps, anchors, (64, 96))
    for k in ("box", "conf", "cls"):
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=1e-4)
