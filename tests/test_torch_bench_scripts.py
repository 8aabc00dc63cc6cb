"""The port's measurement scripts on the CPU, at small sizes.

`scripts.bench`, `bench_train`, `profile_train`, `bench_loader` and
`bench_video` time the card; here each runs with `--device cpu` (the
host's clock, no device metric) to hold what does not depend on the
device: the bench times the real packed serving detector and prints the
JAX bench's five keys last; bench_train prints its row keys, with the
FLOPs of the roofline walk and no MFU or busy time off the card;
profile_train's full step is one make_train_step call, bit for bit;
bench_loader counts every image of an epoch in all five loader modes;
bench_video runs the video CLI and writes its JSON where --out says
(default under build/, which git ignores); the timing helpers call as
often as they say; and no script falls back to the CPU when CUDA is asked
for and absent. Nothing here imports JAX: the FLOP and loss parity with
the JAX package are in test_torch_bench_flops.py and
test_torch_bench_loss.py.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from yolov3_tensorflow_tpu_torch.config import DEFAULT_ANCHORS
from yolov3_tensorflow_tpu_torch.data.synthetic import generate_dataset
from yolov3_tensorflow_tpu_torch.ops.postprocess import build_detector
from yolov3_tensorflow_tpu_torch.scripts import (bench, bench_loader,
                                                 bench_train, bench_video,
                                                 profile_train, roofline)
from yolov3_tensorflow_tpu_torch.testing import CPU_TEST_THREADS
from yolov3_tensorflow_tpu_torch.utils import profiling

torch.set_num_threads(CPU_TEST_THREADS)

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
SIZE = 64
# the JAX bench's serving config (bench.py at the repository root)
JAX_SERVING = dict(max_out=128, box_topk=64, score_thresh=0.3,
                   iou_thresh=0.45)
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "mode"}
ROW_KEYS = {"batch", "ms_per_step", "img_per_sec", "model_flops_per_step",
            "mfu_vs_bf16_peak", "busy_ms", "idle_share"}


def last_json(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])


def test_bench_times_the_packed_detector():
    """The bench's timed bf16 callable gives build_detector(mode="packed")'s
    outputs at the JAX serving config, bit for bit, on a seeded batch."""
    variables = bench.serving_variables(CPU)
    images = bench.bench_images(2, (SIZE, SIZE), CPU)
    got = bench.packed_detector(variables, (SIZE, SIZE), CPU)(images)
    want = build_detector(variables, np.asarray(DEFAULT_ANCHORS, np.float32),
                          80, (SIZE, SIZE), device=CPU,
                          compute_dtype=torch.bfloat16, mode="packed",
                          **JAX_SERVING)(images)
    assert set(got) == set(want)
    for key in want:
        assert torch.equal(got[key], want[key]), key
    assert bool(want["valid"].any()), "the spread head leaves detections"


def test_bench_contract(capsys, tmp_path):
    record_path = tmp_path / "bench.json"
    rc = bench.main(["--device", "cpu", "--size", str(SIZE), str(SIZE),
                     "--batches", "1", "--record", str(record_path)])
    assert rc == 0
    out = last_json(capsys.readouterr().out)
    assert set(out) == BENCH_KEYS
    assert out["metric"] == "images_per_sec_416_inference"
    assert out["unit"] == "img/s"
    assert out["mode"] in ("bf16", "stem_int8_hybrid")
    assert out["value"] > 0
    assert out["vs_baseline"] == round(out["value"] / 43.5, 2)
    record = json.loads(record_path.read_text())
    assert record["device"] == "cpu"
    assert [r["batch"] for r in record["bf16"]] == [1]
    assert record["best_batch"] == 1
    # a differential of (1, 3) calls: 1 untimed + 3 x (1 + 3), no busy time
    # on the CPU
    for row in record["bf16"] + [record["stem8"], record["int8"]]:
        assert row["requests"] == 13 and row["busy_ms"] is None
    assert record["p50"]["calls"] == bench.P50_CALLS
    assert record["p50"]["requests"] == bench.P50_CALLS + 1
    assert record["requests"] == 3 * 13 + bench.P50_CALLS + 1


def test_bench_train_contract(capsys):
    rc = bench_train.main(["--device", "cpu", "--img", str(SIZE),
                           "--batches", "1", "--iters", "1,2"])
    assert rc == 0
    out = last_json(capsys.readouterr().out)
    assert out["metric"] == "train_step_416"
    (row,) = out["rows"]
    assert set(row) == ROW_KEYS
    assert row["batch"] == 1 and row["ms_per_step"] > 0
    assert row["model_flops_per_step"] == sum(
        3 * f for _, f, _ in roofline.walk(1, SIZE, SIZE))
    # a CPU time is never a share of the H100's peak
    assert row["mfu_vs_bf16_peak"] is None
    assert row["busy_ms"] is None and row["idle_share"] is None


def test_bench_train_reference_recipe():
    cfg = bench_train.reference_config()
    assert cfg.train.update_part is None
    assert cfg.train.restore_exclude is None
    # finalize derives the batches per epoch from the 117000 images
    assert cfg.train_img_cnt == 117000
    assert cfg.train_batch_num == -(-117000 // cfg.train.batch_size)
    assert bench_train.PEAK_BF16_FLOPS == 989e12


def test_profile_train_full_step_is_the_train_step():
    """The `full step` stage is one make_train_step call, bit for bit, and
    the stages come in the JAX script's order with the roofline's FLOPs."""
    cfg = bench_train.reference_config()
    step, optimizer = bench_train.train_setup(cfg)
    state = bench_train.fresh_state(optimizer, 80, CPU)
    images, y_true = profile_train.train_inputs(2, SIZE, 80, CPU)
    stages = profile_train.stages(cfg, step, optimizer, state, images,
                                  y_true)
    assert [s[0] for s in stages] == [
        "fwd(train)", "loss(fmaps)", "fwd+loss", "grad(fwd+bwd)",
        "opt(grads)", "l2(params)", "full step"]
    fwd = sum(f for _, f, _ in roofline.walk(2, SIZE, SIZE))
    assert [s[2] for s in stages] == [fwd, 0.0, fwd, 3 * fwd, 0.0, 0.0,
                                      3 * fwd]
    got = dict((name, fn) for name, fn, _ in stages)["full step"]()
    _, metrics = bench_train.train_setup(cfg)[0](state, images, y_true)
    assert torch.equal(got, metrics["total"])


def test_profile_train_derived_lines():
    rows = [{"stage": s, "ms": ms} for s, ms in (
        ("fwd(train)", 10.0), ("fwd+loss", 12.5), ("grad(fwd+bwd)", 40.0),
        ("opt(grads)", 3.0), ("full step", 45.0))]
    lines = profile_train.derived(rows)
    assert lines[1].endswith("2.50") and lines[2].endswith("27.50")
    assert lines[3].endswith("2.00")


@pytest.fixture(scope="module")
def loader_data(tmp_path_factory):
    return generate_dataset(str(tmp_path_factory.mktemp("loader")),
                            num_images=16, seed=0, img_size=(416, 416))


@pytest.mark.parametrize("mode", list(bench_loader.MODES))
def test_bench_loader_counts_every_image(loader_data, mode):
    counts, seconds = bench_loader.count_images(
        loader_data["annotation_file"], mode, threads=2, batch=4, epochs=1)
    assert counts == [16] and seconds > 0


def test_bench_loader_line(capsys, tmp_path):
    rc = bench_loader.main(["--device", "cpu", "--images", "8", "--batch",
                            "4", "--threads", "2", "--epochs", "1",
                            "--out_dir", str(tmp_path)])
    assert rc == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("threads   2: train ")
    for name in ("train+mixup", "val", "device-augment", "+device-encode"):
        assert f"| {name} " in line


def test_bench_video(capsys, tmp_path):
    out = tmp_path / "sub" / "video.json"
    rc = bench_video.main(["--device", "cpu", "--frames", "12", "--size",
                           str(SIZE), "--batches", "1,4", "--out", str(out)])
    assert rc == 0
    record = json.loads(out.read_text())
    assert record["frames"] == 12 and record["size"] == SIZE
    assert set(record["results"]) == {"1", "4"}
    for r in record["results"].values():
        assert r["rc"] == 0
        assert r["steady_fps"] > 0 and r["overall_fps"] > 0
    assert last_json(capsys.readouterr().out) == record["results"]


def test_bench_video_default_out_under_build():
    """The default --out lies under build/, which .gitignore lists, so a run
    can never overwrite the JAX package's docs/results record."""
    default = Path(bench_video.build_parser().parse_args(["--frames", "1"])
                   .out)
    assert default.parts[0] == "build"
    ignored = (ROOT / ".gitignore").read_text().splitlines()
    assert "build/" in ignored


def test_parse_rates():
    text = ("12 frames in 1.00s (12.0 FPS incl. decode+draw+first call); "
            "steady-state 29.2 FPS (first batch excluded)")
    assert bench_video.parse_rates(text) == {"steady_fps": 29.2,
                                             "overall_fps": 12.0}
    assert bench_video.parse_rates("") == {"steady_fps": None,
                                           "overall_fps": None}


def test_differential_ms_calls():
    calls = []
    ms = profiling.differential_ms(lambda: calls.append(1), CPU, 2, 5)
    assert len(calls) == 1 + 3 * (2 + 5)
    assert ms > 0
    with pytest.raises(ValueError):
        profiling.differential_ms(lambda: None, CPU, 3, 3)
    with pytest.raises(ValueError):
        profiling.differential_ms(lambda: None, torch.device("meta"), 1, 2)


def test_call_samples_ms():
    calls = []
    samples = profiling.call_samples_ms(lambda: calls.append(1), CPU, 7)
    assert len(samples) == 7 and len(calls) == 8
    assert all(s >= 0 for s in samples)


@pytest.mark.parametrize("script", [bench, bench_train, profile_train,
                                    bench_loader, bench_video])
def test_no_silent_cpu_path(script):
    """--device cuda (each script's default) where there is no CUDA device
    exits with a message instead of timing the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        script.main(["--device", "cuda"])
