"""YOLOv4 (`models/yolov4.py`) on the port's packed serving path, against
the benchmark's plain float32 reference (`benchmark/reference/yolov4.py`),
on the CPU at 64^2 and 96x128.

- the plan: the cfg's 162 layers and 110 convs (72 Mish, 35 LeakyReLU, 3
  linear), 64.3 M parameters at 80 classes, the reference's conv table,
  the three output grids;
- the live-BN eval forward and the folded forward in fp32 against the
  reference: max |difference| <= 1e-4 of each map's largest magnitude;
- the scale_x_y decode of the packed rows against the reference's rows;
- the packed detector (`build_detector(arch="yolov4")`) against the
  reference's detections through `check.compare_detections`, every share
  0, with its spans nested inside `packed.forward`;
- the conv epilogue's Mish modes against the plain formula;
- YOLOv3's packed detector through the generalised decode tables and
  packed head: the same detections, and YOLOv3's box formula bit for bit.

The weights are the benchmark's (`benchmark/weights_yolov4.py`): with the
moving statistics at their initial values YOLOv4's maps shrink to their
biases (that module's docstring says why).
"""

import functools

import numpy as np
import pytest
import torch

from benchmark import check, scenes, weights, weights_yolov4
from benchmark.reference import yolov4 as ref
from yolov3_tensorflow_tpu_torch.models import yolov4 as y4
from yolov3_tensorflow_tpu_torch.models.convert import (from_jax_variables,
                                                        spread_head)
from yolov3_tensorflow_tpu_torch.models.yolov3 import fold_batch_norm
from yolov3_tensorflow_tpu_torch.ops import conv_epilogue as ce
from yolov3_tensorflow_tpu_torch.ops import fast_postprocess as fp
from yolov3_tensorflow_tpu_torch.ops.postprocess import (PackedDetector,
                                                         build_detector,
                                                         pack_detections,
                                                         unpack_detections)
from yolov3_tensorflow_tpu_torch.testing import (CPU_TEST_THREADS,
                                                 numpy_variables)
from yolov3_tensorflow_tpu_torch.utils import profiling

torch.set_num_threads(CPU_TEST_THREADS)

CPU = torch.device("cpu")
C = 80
SIZES = {"64": (64, 64), "96x128": (96, 128)}
SEED = 2 ** 31 + 11
SERVE = dict(max_out=128, box_topk=64, score_thresh=0.25, iou_thresh=0.45)
SELECT = dict(k_select=64, k_pool=256, score_thresh=0.25, iou_thresh=0.45,
              tie=0.01, iou_tie=0.02)


@functools.lru_cache(maxsize=None)
def _setup(size: str):
    """(weights, images [3, H, W, 3]): the benchmark's draw, its moving
    statistics settled and class biases calibrated on these images."""
    hw = SIZES[size]
    v = weights_yolov4.draw(SEED, C, CPU, spread=True)
    gen = weights.generator(SEED, CPU, stream=1)
    images = scenes.to_rgb_float(scenes.draw(
        gen, 3, hw, num_classes=C, boxes_min=1, boxes_max=8)["images"])
    weights_yolov4.settle(v, images, C)
    weights_yolov4.calibrate(v, images, ref.ANCHORS, C, k_select=64,
                             score_thresh=0.25, target=100)
    return v, images


@functools.lru_cache(maxsize=None)
def _reference_maps(size: str):
    v, images = _setup(size)
    with torch.no_grad(), check.tf32_off():
        return ref.Net(v, C)(images)


def _close(got, want, tol=1e-4):
    for g, w in zip(got, want):
        assert g.shape == w.shape
        scale = float(w.abs().max())
        assert float((g.float() - w).abs().max()) <= tol * scale


def test_plan_is_the_cfg():
    plan = y4.layer_plan(C)
    table = y4.conv_table(C)
    assert len(plan) == 162 and len(table) == 110
    acts = [row[7] for row in table]
    assert (acts.count("mish"), acts.count("leaky"), acts.count("linear")) \
        == (72, 35, 3)
    assert [r for r in table if r[1] == "backbone"][-1][2] == "conv_71"
    assert [r[2] for r in table if r[7] == "linear"] == [
        "conv_21", "conv_29", "conv_37"]
    assert sum(1 for op in plan if op[0] == "shortcut") == 23
    assert [op[1:] for op in plan if op[0] == "yolo"] == [
        ((0, 1, 2), 1.2), ((3, 4, 5), 1.1), ((6, 7, 8), 1.05)]
    # the routes of the cfg, in darknet's channel orders
    assert plan[113] == ("route", (112, 110, 108, 107))
    assert plan[121] == ("route", (120, 118))
    assert plan[142] == ("route", (141, 126))
    assert plan[153] == ("route", (152, 116))
    assert plan[53] == ("route", (52, 25))
    assert [(s, n, ci, co, k, st, a != "linear")
            for _, s, n, ci, co, k, st, a in table] == ref.conv_table(C)
    v = y4.init_yolov4(torch.Generator().manual_seed(0), C, device=CPU)
    n = sum(t.numel() for scope in v["params"].values()
            for p in scope.values() for t in p.values())
    assert n == 64_363_101
    assert set(v["batch_stats"]["head"]) == {
        r[2] for r in table if r[1] == "head" and r[7] != "linear"}


@pytest.mark.parametrize("size", sorted(SIZES))
def test_live_bn_forward_equals_the_reference(size):
    v, images = _setup(size)
    with torch.no_grad():
        got = y4.yolov4_forward(v, images, compute_dtype=torch.float32)
    h, w = SIZES[size]
    assert [tuple(g.shape) for g in got] == [
        (3, h // s, w // s, 255) for s in (32, 16, 8)]
    _close(got, _reference_maps(size))


@pytest.mark.parametrize("size", sorted(SIZES))
def test_folded_forward_equals_the_reference(size):
    v, images = _setup(size)
    folded = fold_batch_norm(v, dtype=torch.float32)
    with torch.no_grad():
        got = y4.yolov4_forward_folded(folded, images,
                                       compute_dtype=torch.float32)
    _close(got, _reference_maps(size))


def _packed_rows(maps):
    """Plain maps [N, H, W, 3*(5+C)] -> packed [N, H, W, 3*row] in the
    packed head's lane order (classes, conf, tx ty tw th, padding)."""
    out = []
    for m in maps:
        r = m.reshape(*m.shape[:3], 3, 5 + C)
        pad = torch.full(r.shape[:-1] + (128 - 5 - C,), -30.0)
        out.append(torch.cat([r[..., 5:], r[..., 4:5], r[..., :4], pad],
                             -1).reshape(*m.shape[:3], 3 * 128))
    return out


@pytest.mark.parametrize("size", sorted(SIZES))
def test_scale_x_y_decode_equals_the_reference_rows(size):
    maps = _reference_maps(size)
    hw = SIZES[size]
    want = ref.flat_rows(maps, ref.ANCHORS, hw, C)
    tables = fp.decode_tables(hw, np.asarray(ref.ANCHORS, np.float32),
                              device=CPU, scale_x_y=y4.SCALE_X_Y)
    assert tables.shape[0] == 7
    a = want["box"].shape[1]
    cand = torch.arange(a).expand(len(maps[0]), a)
    boxes, scores = fp.packed_decode(_packed_rows(maps), cand, C, tables)
    torch.testing.assert_close(boxes, want["box"], rtol=1e-5, atol=1e-3)
    torch.testing.assert_close(scores, torch.sigmoid(want["conf"])[..., None]
                               * torch.sigmoid(want["cls"]))


@pytest.mark.parametrize("size", sorted(SIZES))
def test_packed_detector_equals_the_reference_detections(size):
    v, images = _setup(size)
    hw = SIZES[size]
    det = build_detector(v, np.asarray(ref.ANCHORS, np.float32), C, hw,
                         device=CPU, mode="packed", arch="yolov4",
                         compute_dtype=torch.float32, **SERVE)
    assert isinstance(det, PackedDetector)
    with profiling.recording() as rec:
        rows = pack_detections(det(images)).numpy()
    spans = rec.spans()
    assert [(s.name, s.depth) for s in spans] == [
        ("packed.forward", 0), ("yolov4.backbone", 1), ("yolov4.neck", 1),
        ("packed.postprocess", 0)]
    prog = [unpack_detections(rows, i) for i in range(len(images))]
    maps = _reference_maps(size)
    flat = ref.flat_rows(maps, ref.ANCHORS, hw, C)
    refs = [check.reference_image(flat["box"][i], flat["conf"][i],
                                  flat["cls"][i], **SELECT)
            for i in range(len(images))]
    got = check.compare_detections(prog, refs, margin=0.05)
    assert sum(len(p[0]) for p in prog) > 3 * 20
    for share in ("wrong_share", "bad_image_share", "missed_share",
                  "extra_share", "empty_share"):
        assert got[share] == 0, got


@pytest.mark.parametrize("arch,mode", [("yolov4", "split"),
                                       ("yolov4", "prefilter"),
                                       ("yolov4", "exact"),
                                       ("yolov4", "stem8"),
                                       ("yolov5", "packed")])
def test_build_detector_refuses_what_it_does_not_serve(arch, mode):
    v, _ = _setup("64")
    with pytest.raises(ValueError):
        build_detector(v, np.asarray(ref.ANCHORS, np.float32), C, (64, 64),
                       device=CPU, mode=mode, arch=arch)


def _mish_operands(dtype, mode, seed):
    rng = np.random.default_rng(seed)
    shape = (2, 16, 4, 6)
    vals = np.concatenate([rng.normal(0, 4, 300), [0.0, -0.0, 20.0, 20.5,
                                                   -20.0, 19.99, 88.0, -90.0,
                                                   1e-30, np.nan, 1e4, -1e4]])
    y = torch.from_numpy(rng.choice(vals, shape).astype(np.float32)).to(
        dtype).contiguous(memory_format=torch.channels_last)
    bias = torch.from_numpy(rng.normal(0, 1, 16).astype(np.float32))
    e = (torch.from_numpy(rng.normal(0, 2, shape).astype(np.float32)).to(
        dtype).contiguous(memory_format=torch.channels_last)
        if mode == "mish_residual" else None)
    return y, bias, e


def _bits(t):
    return t.contiguous().view(torch.int16 if t.dtype == torch.bfloat16
                               else torch.int32)


@pytest.mark.parametrize("mode", ["mish", "mish_residual"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mish_epilogue_is_the_plain_formula(dtype, mode):
    """The reference chain and, on the CPU, the wrapper: rnd(mish(rnd(y +
    rnd(b)))) (+ e, rounded), with mish(x) = x * tanh(softplus(x)),
    softplus(x) = x above 20. Against the formula in float64, rounded to
    the dtype: within one unit of the dtype's last place (PyTorch's
    vectorized CPU softplus and tanh are off the correctly rounded value
    by an fp32 ulp at some inputs), NaN where the formula gives NaN."""
    y, bias, e = _mish_operands(dtype, mode, seed=4)
    x = (y + bias.to(dtype).view(1, -1, 1, 1)).double()
    sp = torch.where(x > 20, x, torch.log1p(torch.exp(x)))
    m = (x * torch.tanh(sp)).to(dtype)
    want = (m if e is None else m + e).double()
    # an ulp of the Mish value, and of the sum after the shortcut's add
    ulp = 2.0 ** (-23 if dtype == torch.float32 else -7)
    room = 2 * ulp * (m.double().abs() + want.abs()) + 1e-37
    for fn in (ce.conv_epilogue_reference, ce.conv_epilogue):
        got = fn(y, bias, shortcut=e, mish=True)
        assert got.dtype == dtype
        nan = torch.isnan(want)
        assert torch.equal(torch.isnan(got), nan)
        assert ((got.double() - want).abs() <= room)[~nan].all()
    assert ce._mode(True, e, None, mish=True) == (
        ce.MISH if e is None else ce.MISH_RESIDUAL)
    with pytest.raises(ValueError):
        ce.conv_epilogue_reference(y, bias, low=y[:, :, :2, :3], mish=True)


@pytest.mark.parametrize("size", sorted(SIZES))
def test_yolov3_packed_detections_unchanged(size):
    """YOLOv3 through build_detector (the packed head packed by name,
    scale_x_y 1 at every scale): the same detections as the packed forward
    and postprocess called directly, and the decode's boxes bit for bit
    YOLOv3's formula, (sigmoid(t) + cell) * stride."""
    hw = SIZES[size]
    anchors = np.asarray([[10, 13], [16, 30], [33, 23], [30, 61], [62, 45],
                          [59, 119], [116, 90], [156, 198], [373, 326]],
                         np.float32)
    v = spread_head(from_jax_variables(numpy_variables(C), device=CPU))
    gen = torch.Generator().manual_seed(3)
    images = torch.rand((2,) + hw + (3,), generator=gen)
    det = build_detector(v, anchors, C, hw, device=CPU, mode="packed",
                         compute_dtype=torch.float32, **SERVE)
    got = det(images)
    tree = fp.pack_serving_head(fold_batch_norm(v, dtype=torch.float32), C)
    with torch.inference_mode():
        outs = fp.yolov3_forward_packed(tree, images,
                                        compute_dtype=torch.float32)
        want = fp.postprocess_packed(outs, anchors, C, hw, **SERVE)
    for k in want:
        assert torch.equal(got[k], want[k])
    assert want["valid"].any()
    tables = det.tables
    cand = torch.randint(0, tables.shape[1], (2, 64), generator=gen)
    t = torch.randn((2, 64, 4), generator=gen) * 4
    gx, gy, grw, grh, gaw, gah = tables[:6, cand]
    w, h = torch.exp(t[..., 2]) * gaw, torch.exp(t[..., 3]) * gah
    cx = (torch.sigmoid(t[..., 0]) + gx) * grw
    cy = (torch.sigmoid(t[..., 1]) + gy) * grh
    old = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    assert torch.equal(fp._decode(t, cand, tables), old)
