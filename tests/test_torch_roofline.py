"""The port's roofline against the JAX script's, on the CPU.

`scripts/roofline.py` (JAX) is imported by path and not changed. Its rows
and the port's are equal in label, FLOPs and bytes, but for one: the
lateral 1x1 conv of the 13->26 junction (head conv_7). The JAX script
counts its input at the channel count `yolo_block` returns, 1024 (the
block's last conv, conv_5); the conv reads `inter1`, the 512-channel
output of head conv_4 (`models/yolov3.py`, `_head_forward` and
`_head_input_channels`), which the port counts.
"""

import importlib.util
from pathlib import Path

import pytest
import torch

from yolov3_tensorflow_tpu_torch.models.yolov3 import _head_input_channels
from yolov3_tensorflow_tpu_torch.scripts import roofline

ROOT = Path(__file__).resolve().parents[1]
BATCH = 128


@pytest.fixture(scope="module")
def jroof():
    pytest.importorskip("jax")
    spec = importlib.util.spec_from_file_location(
        "jax_roofline", ROOT / "scripts" / "roofline.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _lateral_13_by_hand():
    """head conv_7 at batch 128, 416^2: 1x1, 512 -> 256 at 13x13, bf16."""
    h = w = 13
    cin, cout = 512, 256
    flops = 2.0 * BATCH * h * w * cin * cout
    bytes_ = 2 * BATCH * (h * w * cin + h * w * cout) + 2 * cin * cout
    return flops, bytes_


@pytest.mark.parametrize("train", [False, True])
def test_rows_equal_jax_but_the_lateral_cin(train, jroof):
    want = jroof.walk(BATCH, 416, 416)
    got = roofline.walk(BATCH, 416, 416)
    if train:
        want, got = jroof.train_cost(want), roofline.train_cost(got)
    assert len(got) == len(want) == 77
    scale = (3.0, 2.5) if train else (1.0, 1.0)
    for (gl, gf, gb), (wl, wf, wb) in zip(got, want):
        assert gl == wl
        if gl == "lat13->26":
            f, b = _lateral_13_by_hand()
            assert (gf, gb) == (scale[0] * f, scale[1] * b)
            assert wf == 2 * gf                 # JAX counts cin 1024
        else:
            assert (gf, gb) == (wf, wb), gl


def test_lateral_cin_is_the_model_s():
    assert _head_input_channels(80)[7] == 512
    assert _head_input_channels(80)[15] == 256


@pytest.mark.parametrize("size", [(320, 320), (608, 416)])
def test_rows_follow_the_plan_at_other_sizes(size, jroof):
    got = roofline.walk(4, *size)
    want = jroof.walk(4, *size)
    assert [r[0] for r in got] == [r[0] for r in want]
    diff = [g for g, w in zip(got, want) if g != w]
    assert [d[0] for d in diff] == ["lat13->26"]


def test_totals_per_image():
    s = roofline.roofline(BATCH, (416, 416), 1000.0, 3000.0)
    rows = roofline.walk(BATCH, 416, 416)
    assert s["flops"] == sum(r[1] for r in rows)
    assert round(s["flops"] / BATCH / 1e9, 1) == 65.9
    assert round(s["bytes"] / BATCH / 1e6) == 191
    assert s["n_rows"] == 77
    assert max(s["t_flop"], s["t_hbm"]) <= s["t_bound"] \
        <= s["t_flop"] + s["t_hbm"]
    assert s["t_flop"] == pytest.approx(s["flops"] / 1e15)
    assert s["t_hbm"] == pytest.approx(s["bytes"] / 3e12)


def test_kernel_bounds_against_hand_numbers():
    """Each kernel's bound at its path's shape, worked out by hand from the
    published H100 SXM peaks (989 TF/s bf16, 67 TF/s fp32, 3.35 TB/s)."""
    # K3 ctrl 512x512, M 16384, reps 64: 549.8 GF of bf16 products
    ms, by = roofline.bound_mma_chain(16384, 512, 512, 64)
    assert 2.0 * 16384 * 512 * 512 * 64 == pytest.approx(549.76e9, rel=1e-4)
    assert (round(ms, 4), by) == (0.5559, "operations")
    # K4 c=128, M 65536: 16.8 MB read + 148.6 MB of patches written
    ms, by = roofline.bound_patch_build(65536, 128)
    assert 2 * 65536 * 128 + 2 * 64 * 1008 * 9 * 128 == 165412864
    assert (round(ms, 4), by) == (0.0494, "bytes")
    # K2 at G=640, K=1024, every candidate valid and kept: K(K-1)/2 pairs
    every = torch.ones((640, 1024), dtype=torch.bool)
    pairs = roofline.nms_pairs(every, every)
    assert pairs == 640 * 1024 * 1023 // 2 == 335216640
    ms, by = roofline.bound_nms(640, 1024, pairs)
    assert (round(ms, 4), by) == (0.0700, "operations")
    assert 640 * 1024 * 18 / 3.35e12 * 1e3 == pytest.approx(0.0035, abs=1e-4)
    # K1 at B=128, K=64, C=80: 3.4 MB, mostly the [B, K, C] scores
    ms, by = roofline.bound_nms_shared(128, 64, 80)
    assert (round(ms, 4), by) == (0.001, "bytes")


def test_nms_pairs_counts_only_what_the_inputs_need():
    valid = torch.tensor([[True, False, True, True, False]])
    keep = torch.tensor([[True, False, False, True, False]])
    # kept 0 meets valid 2 and 3; kept 3 meets no later valid candidate
    assert roofline.nms_pairs(valid, keep) == 2
    assert roofline.nms_pairs(valid, torch.zeros_like(keep)) == 0
    assert roofline.nms_pairs(valid[:, :0], keep[:, :0]) == 0


def test_main_refuses_to_run_without_the_constants(capsys):
    for argv in ([], ["--peak_tflops", "800"], ["--hbm_gbs", "3000"]):
        with pytest.raises(SystemExit) as exc:
            roofline.main(argv)
        assert exc.value.code == 2
    assert "required" in capsys.readouterr().err


def test_main_prints_the_bound(capsys):
    s = roofline.main(["--peak_tflops", "800", "--hbm_gbs", "3000",
                       "--measured_ms", "43.5"])
    out = capsys.readouterr().out
    assert "total FLOPs/img: 65.9 GF" in out
    assert f"{s['t_bound'] * 1e3:.2f} ms/batch" in out
    assert f"{s['t_bound'] * 1e3 / 43.5 * 100:.0f}% of the bound" in out
    assert out.count(" hbm ") == 8
    t = roofline.main(["--peak_tflops", "800", "--hbm_gbs", "3000",
                       "--train"])
    assert t["flops"] == pytest.approx(3 * s["flops"])
