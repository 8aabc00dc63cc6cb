"""The port's `detect_image` in its quantized modes against the JAX
package's, on the CPU (the other modes are in tests/test_torch_cli.py).

Both CLIs read the same 3-class weights (seeded, with the spread head;
the port loads them from a `.weights` file, the JAX CLI gets the tree the
file was written from) and the same image at 96x96. Both calibrate on the
input image; both calibrations are replaced by one set of scales, the
port's calibration of that image (the two calibrations agree to ~1% in
bf16, tests/test_torch_quantize.py, and a 1% other grid is another
quantized model). JAX's CLI runs with
`jax.jit` as the identity: jitted, XLA fuses the int8 epilogues and rounds
them otherwise than JAX's own plain functions, which the port follows bit
for bit. Detections are recorded by
wrapping each CLI's `plot_one_box`, in source-image pixels, and held to
detection identity both ways (same label, IoU >= 0.9, every detection
scored at least 0.02 above the threshold): all of them for the int8
routes, at least 90% for the stem8 routes, whose 63 bf16 convs sum in
another order in each package.

- `--mode stem8` and `--mode auto --quantize full|hybrid` on both
  packages, `--device cpu` for the port;
- the port's `--mode int8` against JAX's `build_auto_detector(quantize=
  "full")` route through its `--mode auto --quantize full` (JAX's own
  `--mode int8` binds a `(detector, qparams)` tuple to its detector and
  fails), and its warning where the policy would not pick int8;
- `scripts/validate_quantized.py` on a small CPU overfit-gate checkpoint:
  its JSON line has the keys of the JAX script's record
  (docs/results/quantize_validation.json) less the approximate top-k
  ones, plus "device" and "calib_images".
"""

import json
from pathlib import Path

import cv2
import jax
import numpy as np
import pytest
import torch

from yolov3_tensorflow_tpu.cli import detect_image as jax_image
from yolov3_tensorflow_tpu.ops import quantize as jax_quant
from yolov3_tensorflow_tpu.utils import cache as jax_cache
from yolov3_tensorflow_tpu_torch.cli import detect_image as port_image
from yolov3_tensorflow_tpu_torch.models.convert import (from_jax_variables,
                                                        spread_head)
from yolov3_tensorflow_tpu_torch.ops import postprocess as port_post
from yolov3_tensorflow_tpu_torch.ops import quantize as port_quant
from yolov3_tensorflow_tpu_torch.scripts import (overfit_gate,
                                                 validate_quantized)
from yolov3_tensorflow_tpu_torch.testing import (CPU_TEST_THREADS,
                                                 match_detections,
                                                 numpy_variables)
from yolov3_tensorflow_tpu_torch.utils.weights import save_darknet_weights

torch.set_num_threads(CPU_TEST_THREADS)

ROOT = Path(__file__).resolve().parent.parent
ASSETS = ROOT / "assets"
IMAGE = str(ASSETS / "demo_data" / "synth_shapes_1.jpg")
NAMES = str(ASSETS / "demo_data" / "synth.names")
CLASSES = ["circle", "box", "triangle"]
SCORE_T = 0.3


@pytest.fixture(scope="module")
def variables():
    """The tree the `.weights` file holds: its values, bit for bit, are what
    both CLIs load (tests/test_torch_weights.py), and the JAX CLI takes
    them from here (its loader costs ~12 s a call)."""
    return spread_head(numpy_variables(len(CLASSES), seed=0), seed=0)


@pytest.fixture(scope="module")
def weights(tmp_path_factory, variables):
    path = tmp_path_factory.mktemp("cli_int8") / "synth3.weights"
    save_darknet_weights(from_jax_variables(variables,
                                            device=torch.device("cpu")),
                         str(path), len(CLASSES))
    return str(path)


@pytest.fixture(scope="module")
def shared_scales(variables):
    """Activation scales of the CLIs' own network input (the image
    letterboxed to 96x96, as both CLIs make it), from the port's
    calibration (test_torch_quantize.py holds it to JAX's)."""
    inp, _ = jax_image.preprocess(cv2.imread(IMAGE), [96, 96], True)
    return inp.tobytes(), port_quant.calibrate_activation_scales(
        from_jax_variables(variables, device=torch.device("cpu")), inp)


@pytest.fixture
def shared_calibration(monkeypatch, shared_scales, variables):
    """Both packages' CLIs quantize with `shared_scales`, and only for that
    input; the JAX CLI gets its variables from `variables`."""
    key, scales = shared_scales

    def recorded(variables, images, **kw):
        assert np.asarray(images).tobytes() == key
        return scales

    monkeypatch.setattr(jax_cache, "enable_compile_cache",
                        lambda *a, **k: None)
    monkeypatch.setattr(jax_image, "load_variables",
                        lambda path, n: variables)
    for module in (jax_quant, port_quant, port_post):
        monkeypatch.setattr(module, "calibrate_activation_scales", recorded)


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX CLI's detections per argv: the stem8 and auto-hybrid cases
    run one JAX route, the int8 and auto-full cases another."""
    return {}


def _run(monkeypatch, module, argv):
    """Run one CLI; returns the (boxes, scores, labels) it drew."""
    plot, drawn = module.plot_one_box, []

    def plot_one_box(img, coord, label=None, color=None,
                     line_thickness=None):
        name, pct = label.rsplit(", ", 1)
        drawn.append((np.asarray(coord, np.float32),
                      float(pct.rstrip("%")) / 100, CLASSES.index(name)))
        plot(img, coord, label=label, color=color,
             line_thickness=line_thickness)

    with monkeypatch.context() as m:
        m.setattr(module, "plot_one_box", plot_one_box)
        if module is jax_image:
            m.setattr(jax, "jit", lambda f, *a, **k: f)
        assert module.main(argv) == 0
    return [(np.array([d[0] for d in drawn], np.float32).reshape(-1, 4),
             np.array([d[1] for d in drawn], np.float32),
             np.array([d[2] for d in drawn], np.int64))]


def _same_detections(port, jax_dets, share):
    n_j, found_j = match_detections(jax_dets, port, SCORE_T + 0.02)
    n_p, found_p = match_detections(port, jax_dets, SCORE_T + 0.02)
    assert n_j >= 10 and n_p >= 10, (n_j, n_p)
    assert found_j >= share * n_j, f"port misses {n_j - found_j} of {n_j}"
    assert found_p >= share * n_p, f"port adds {n_p - found_p} of {n_p}"


# port argv -> (JAX argv, share of detections found both ways); the full
# int8 route first: its unjitted JAX run compiles most of the operations
# the stem8 route then reuses
CASES = {
    "auto_full": (["--mode", "auto", "--quantize", "full"],
                  ["--mode", "auto", "--quantize", "full"], 1.0),
    "int8": (["--mode", "int8"], ["--mode", "auto", "--quantize", "full"],
             1.0),
    "stem8": (["--mode", "stem8"], ["--mode", "stem8"], 0.9),
    "auto_hybrid": (["--mode", "auto", "--quantize", "hybrid"],
                    ["--mode", "auto", "--quantize", "hybrid"], 0.9),
}


@pytest.mark.parametrize("case", list(CASES))
def test_detect_image_quantized_matches_jax(case, weights, shared_calibration,
                                            jax_runs, monkeypatch, tmp_path):
    port_args, jax_args, share = CASES[case]
    common = [IMAGE, "--restore_path", weights, "--class_name_path", NAMES,
              "--new_size", "96", "96"]
    key = tuple(jax_args)
    if key not in jax_runs:
        jax_runs[key] = _run(monkeypatch, jax_image, common + jax_args + [
            "--output", str(tmp_path / "jax.jpg")])
    want = jax_runs[key]
    out = str(tmp_path / "port.jpg")
    got = _run(monkeypatch, port_image, common + port_args + [
        "--device", "cpu", "--output", out])
    assert cv2.imread(out).shape == cv2.imread(IMAGE).shape
    _same_detections(got, want, share)


def test_detect_image_int8_warns_where_int8_is_not_picked(weights,
                                                          monkeypatch,
                                                          capsys, tmp_path):
    """Above the policy's area full int8 still runs, with JAX's warning;
    the calibration here is the port's own."""
    monkeypatch.setattr(port_post, "_INT8_MAX_AREA", 64 * 64)
    assert port_image.main([IMAGE, "--restore_path", weights,
                            "--class_name_path", NAMES, "--new_size", "96",
                            "96", "--mode", "int8", "--device", "cpu",
                            "--output", str(tmp_path / "port.jpg")]) == 0
    assert "consider --mode auto" in capsys.readouterr().err


def test_validate_quantized_script(tmp_path, capsys):
    out = tmp_path / "gate"
    assert overfit_gate.main(["--preset", "quick", "--num_images", "8",
                              "--img_size", "64", "--epochs", "2",
                              "--device", "cpu", "--target_map", "0",
                              "--out_dir", str(out)]) == 0
    capsys.readouterr()
    data = out / "data"
    assert validate_quantized.main([
        "--ckpt", str(out / "ckpt" / "overfit_final"),
        "--data", str(data / "train.txt"), "--names",
        str(data / "synth.names"), "--img_size", "64", "--device", "cpu",
        "--out", str(tmp_path)]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    with open(ROOT / "docs" / "results" / "quantize_validation.json") as f:
        jax_keys = {k for k in json.load(f) if not k.startswith("approx")}
    assert set(summary) == jax_keys | {"device", "calib_images"}
    assert summary["device"] == "cpu" and summary["images"] == 8
    assert summary["calib_images"] == 8
    assert summary["stem_int8_upto"] == 12
    for key in ("mAP_bf16", "mAP_int8", "mAP_int8_chained", "mAP_stem_int8"):
        assert 0.0 <= summary[key] <= 1.0
    with open(tmp_path / "quantize_validation.json") as f:
        assert json.load(f) == summary
