"""The port's serving-mode policy and int8 detectors against the JAX
package's, on the CPU.

- `select_serving_mode` gives JAX's answer over a grid of sizes and the
  three budgets on the CPU, and raises on an unknown budget; on CUDA it
  follows the H100's measured table (bf16 packed under every budget);
- `build_auto_detector` takes JAX's route for each budget (packed, stem8
  or the int8 packed detector) and falls back to packed without
  calibration images;
- `build_detector_int8` in its three modes and `build_detector(mode=
  "stem8")` find the same detections as JAX's detectors at 96^2, 4
  classes, on the same spread-head weights and inputs, both packages
  quantizing with the same activation scales, the port's (the
  calibrations are compared in test_torch_quantize.py): same label, IoU
  >= 0.9, for every detection scored at least 0.02 above the threshold,
  both ways. There is no fp32 form of these detectors: in the int8 ones
  only the bf16 detection convs can differ (by a bf16 step), and no
  detection may go missing; the stem8 detector's 63 bf16 convs drift
  further, and at least 95% of the detections must be found both ways.

JAX's detectors run unjitted.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov3_tensorflow_tpu.ops import postprocess as jpp
from yolov3_tensorflow_tpu.ops import quantize as jq
from yolov3_tensorflow_tpu_torch.config import DEFAULT_ANCHORS
from yolov3_tensorflow_tpu_torch.models.convert import (from_jax_variables,
                                                        spread_head)
from yolov3_tensorflow_tpu_torch.ops import postprocess as tpp
from yolov3_tensorflow_tpu_torch.ops import quantize as tq
from yolov3_tensorflow_tpu_torch.ops.postprocess import detections_to_numpy
from yolov3_tensorflow_tpu_torch.testing import (CPU_TEST_THREADS,
                                                 match_detections,
                                                 numpy_variables)

torch.set_num_threads(CPU_TEST_THREADS)

CPU = torch.device("cpu")
ANCHORS = np.asarray(DEFAULT_ANCHORS, np.float32)
C = 4
SIZE = 96
SCORE_T = 0.3
KW = dict(max_out=128, box_topk=64, score_thresh=SCORE_T, iou_thresh=0.45)
SIZES = [(320, 320), (416, 416), (608, 608), (608, 800), (700, 700),
         (701, 700), (800, 608), (896, 1344), (1344, 896)]


@pytest.mark.parametrize("quantize", ["none", "hybrid", "full"])
def test_select_serving_mode_matches_jax(quantize):
    for size in SIZES:
        assert tpp.select_serving_mode(size, quantize=quantize,
                                       device=CPU) == \
            jpp.select_serving_mode(size, quantize=quantize), size
    assert tpp._INT8_MAX_AREA == jpp._INT8_MAX_AREA


def test_select_serving_mode_rejects_unknown_budget():
    with pytest.raises(ValueError, match="none|hybrid|full"):
        tpp.select_serving_mode((416, 416), quantize="fast", device=CPU)


CUDA = torch.device("cuda")       # a device type only: nothing runs there


def test_select_serving_mode_needs_a_device():
    """The device is a required keyword: a caller who leaves it out gets
    a TypeError, not the CPU's (JAX's TPU) policy on a CUDA card."""
    with pytest.raises(TypeError, match="device"):
        tpp.select_serving_mode((416, 416), quantize="full")
    assert tpp.select_serving_mode((416, 416), quantize="full",
                                   device=CPU) == "int8"
    assert tpp.select_serving_mode((416, 416), quantize="full",
                                   device=CUDA) == "packed"


@pytest.mark.parametrize("quantize", ["none", "hybrid", "full"])
def test_select_serving_mode_on_cuda_follows_the_h100_table(quantize):
    """On CUDA the policy is the H100's measured table, in which bf16
    packed beat stem8 and int8 at every benched size: packed under every
    budget there, and at every size of the CPU grid (the nearest table
    size decides). Never a mode the table measured slower than packed."""
    for size in tpp._CUDA_MODE_TABLE:
        assert tpp.select_serving_mode(size, quantize=quantize,
                                       device=CUDA) == "packed", size
    for size in SIZES:
        mode = tpp.select_serving_mode(size, quantize=quantize, device=CUDA)
        assert mode == "packed", size
    for rates in tpp._CUDA_MODE_TABLE.values():
        assert rates["packed"] > max(rates["stem8"], rates["int8"])
    assert tpp.select_serving_mode((416, 416), quantize=quantize,
                                   device=torch.device("cuda", 1)) == "packed"


def test_select_serving_mode_on_cuda_picks_the_fastest_allowed(monkeypatch):
    """The CUDA table is data: where a quantized mode measures faster, the
    budgets that allow it pick it, at the table size nearest in area."""
    table = {(416, 416): {"packed": 2.0, "stem8": 3.0, "int8": 4.0},
             (896, 1344): {"packed": 2.0, "stem8": 3.0, "int8": 1.0}}
    monkeypatch.setattr(tpp, "_CUDA_MODE_TABLE", table)
    pick = {q: tpp.select_serving_mode((320, 320), quantize=q, device=CUDA)
            for q in ("none", "hybrid", "full")}
    assert pick == {"none": "packed", "hybrid": "stem8", "full": "int8"}
    assert tpp.select_serving_mode((1344, 896), quantize="full",
                                   device=CUDA) == "stem8"
    with pytest.raises(ValueError, match="none|hybrid|full"):
        tpp.select_serving_mode((416, 416), quantize="fast", device=CUDA)


def test_int8_warning_cites_the_device_table():
    """detect_image --mode int8 warns where the requested device's table
    says int8 loses (on CUDA at 416^2) and names that table."""
    assert tpp.select_serving_mode((416, 416), quantize="full",
                                   device=CUDA) != "int8"
    assert "H100" in tpp.SERVING_TABLES["cuda"]
    assert "TPU" in tpp.SERVING_TABLES["cpu"]


@pytest.fixture(scope="module")
def setup():
    jvars = spread_head(numpy_variables(C, seed=0), seed=0)
    tvars = from_jax_variables(jvars, device=CPU)
    rng = np.random.default_rng(96)
    calib = rng.uniform(0, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    images = rng.uniform(0, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    return jvars, tvars, calib, images


@pytest.mark.parametrize("quantize,route", [("none", "packed"),
                                            ("hybrid", "stem8"),
                                            ("full", "int8")])
def test_auto_detector_takes_jax_route(quantize, route, setup):
    _, tvars, calib, images = setup
    assert jpp.select_serving_mode((SIZE, SIZE), quantize=quantize) == route
    det = tpp.build_auto_detector(tvars, ANCHORS, C, (SIZE, SIZE),
                                  quantize=quantize, calibration_images=calib,
                                  device=CPU, **KW)
    if route == "packed":
        assert isinstance(det, tpp.PackedDetector)
    else:
        assert isinstance(det, tq.QuantizedDetector)
        assert det.forward_fn is (tq.yolov3_forward_stem_int8_packed
                                  if route == "stem8"
                                  else tq.yolov3_forward_int8_packed)
    out = det(torch.from_numpy(images))
    assert out["boxes"].shape == (2, C * KW["max_out"], 4)
    assert bool(out["valid"].any())


def test_auto_detector_falls_back_without_calibration(setup):
    _, tvars, _, _ = setup
    for quantize in ("none", "hybrid", "full"):
        det = tpp.build_auto_detector(tvars, ANCHORS, C, (SIZE, SIZE),
                                      quantize=quantize, device=CPU, **KW)
        assert isinstance(det, tpp.PackedDetector)


@pytest.fixture(scope="module")
def scales(setup):
    _, tvars, calib, _ = setup
    return tq.calibrate_activation_scales(tvars, calib)


@pytest.mark.parametrize("mode", ["prefilter", "packed", "chained", "stem8"])
def test_int8_detectors_match_jax(mode, setup, scales, monkeypatch):
    jvars, tvars, calib, images = setup
    # both packages quantize with one set of activation scales
    # (the calibrations agree to ~1% in bf16, test_torch_quantize.py, and
    # a 1% other grid is another quantized model)
    for module in (jq, tq, tpp):
        monkeypatch.setattr(module, "calibrate_activation_scales",
                            lambda *a, **k: scales)
    if mode == "stem8":
        det = tpp.build_detector(tvars, ANCHORS, C, (SIZE, SIZE), device=CPU,
                                 mode="stem8", calibration_images=calib, **KW)
        jdet = jpp.build_detector(jvars, ANCHORS, C, (SIZE, SIZE),
                                  mode="stem8", calibration_images=calib,
                                  use_pallas=False, **KW)
        assert det.params["upto"] == 12             # JAX's default
    else:
        det, qparams = tq.build_detector_int8(
            tvars, ANCHORS, C, (SIZE, SIZE), device=CPU, mode=mode,
            calibration_images=calib, **KW)
        jdet, _ = jq.build_detector_int8(
            jvars, ANCHORS, C, (SIZE, SIZE), mode=mode,
            calibration_images=jnp.asarray(calib), **KW)
        assert qparams is det.params
    assert not det.training
    got = det(torch.from_numpy(images))
    # JAX's detector unjitted (its plain function): jitted, XLA fuses the
    # int8 epilogues and rounds them otherwise, which moves 22 of JAX's own
    # 117 confident detections here; the port follows the unjitted one
    want = jax.device_get(jdet.__wrapped__(jnp.asarray(images)))
    assert got["boxes"].shape == (2, C * KW["max_out"], 4)
    assert torch.isfinite(got["boxes"]).all()

    def jax_dets(i):
        v = want["valid"][i].astype(bool)
        return want["boxes"][i][v], want["scores"][i][v], want["labels"][i][v]

    g = [detections_to_numpy(got, i) for i in range(2)]
    w = [jax_dets(i) for i in range(2)]
    n_w, found_w = match_detections(w, g, SCORE_T + 0.02)
    n_g, found_g = match_detections(g, w, SCORE_T + 0.02)
    assert n_w >= 10 and n_g >= 10, (n_w, n_g)
    if mode == "stem8":
        # the bf16 remainder (63 convs) sums in another order here: 114 of
        # JAX's 117 confident detections found, 114 of the port's 118
        assert found_w >= 0.95 * n_w and found_g >= 0.95 * n_g, \
            (found_w, n_w, found_g, n_g)
        return
    assert found_w == n_w, f"port misses {n_w - found_w} of {n_w}"
    assert found_g == n_g, f"port adds {n_g - found_g} of {n_g}"


def test_int8_detector_rejects_unknown_mode(setup):
    _, tvars, calib, _ = setup
    with pytest.raises(ValueError, match="unsupported int8 detector mode"):
        tq.build_detector_int8(tvars, ANCHORS, C, (SIZE, SIZE), device=CPU,
                               mode="split", calibration_images=calib)
    with pytest.raises(ValueError, match="calibration_images"):
        tpp.build_detector(tvars, ANCHORS, C, (SIZE, SIZE), device=CPU,
                           mode="stem8")
