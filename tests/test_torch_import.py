"""The PyTorch port imports without jax, optax or orbax: the GPU machine it
runs on has none of them."""

import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import yolov3_tensorflow_tpu_torch

PKG_DIR = Path(yolov3_tensorflow_tpu_torch.__file__).parent


def _modules():
    names = ["yolov3_tensorflow_tpu_torch"]
    for info in pkgutil.walk_packages([str(PKG_DIR)],
                                      prefix="yolov3_tensorflow_tpu_torch."):
        names.append(info.name)
    return names


def test_every_module_imports_with_jax_blocked():
    names = _modules()
    for name in ("ops.nms_cuda", "ops.nms", "ops.preprocess",
                 "models.decode", "utils.weights", "utils.kernels",
                 "utils.profiling", "utils.coco", "utils.viz", "config",
                 "data.augment", "cli.common", "cli.detect_image",
                 "cli.detect_video", "scripts.exp_mxu_shapes",
                 "scripts.roofline", "scripts.profile_stages",
                 "scripts.compare_revisions", "scripts.k1_phases",
                 "testing", "models.layers", "models.yolov3", "ops.boxes",
                 "ops.losses", "data.annotations", "data.encoder",
                 "data.loader", "data.synthetic", "evaluation.metrics",
                 "evaluation.voc", "utils.summary", "train.schedules",
                 "train.optimizers", "train.checkpoint", "train.trainer",
                 "cli.train", "data.device_augment", "data.device_encode",
                 "cli.evaluate", "cli.convert_weights",
                 "cli.strip_checkpoint", "cli.kmeans_anchors",
                 "cli.parse_voc", "utils.kmeans", "scripts.overfit_gate",
                 "parallel", "parallel.multihost", "parallel.mesh",
                 "parallel.data_parallel", "parallel.serving",
                 "scripts.parity_demo", "scripts.bench",
                 "scripts.bench_train", "scripts.profile_train",
                 "scripts.bench_loader", "scripts.bench_video",
                 "scripts.experiments", "scripts.exp_score",
                 "scripts.exp_topk", "scripts.exp_tail",
                 "scripts.exp_pp_incr", "scripts.exp_postprocess",
                 "scripts.exp_stem_int8", "scripts.exp_highres_int8",
                 "scripts.analyze_recipe_precision", "utils.native",
                 "entry"):
        assert f"yolov3_tensorflow_tpu_torch.{name}" in names
    code = ("import importlib, sys\n"
            "for blocked in ('jax', 'optax', 'orbax'):\n"
            "    sys.modules[blocked] = None\n"
            f"for name in {names!r}:\n"
            "    importlib.import_module(name)\n"
            "bad = sorted(m for m, mod in sys.modules.items()\n"
            "             if (m.split('.')[0] in ('jax', 'optax', 'orbax')\n"
            "                 and mod is not None)\n"
            "             or m.split('.')[0] == 'yolov3_tensorflow_tpu')\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          cwd=str(PKG_DIR.parent))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_no_source_imports_jax():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|optax|orbax)\b",
                         re.MULTILINE)
    offenders = [str(p) for p in PKG_DIR.rglob("*.py")
                 if pattern.search(p.read_text())]
    assert not offenders, offenders


def test_no_source_imports_the_jax_package():
    """Not even its host-only modules (config, utils.coco, utils.viz,
    data.augment): the port keeps its own copies."""
    pattern = re.compile(r"^\s*(import|from)\s+yolov3_tensorflow_tpu\b"
                         r"(?!_torch)", re.MULTILINE)
    offenders = [str(p) for p in PKG_DIR.rglob("*.py")
                 if pattern.search(p.read_text())]
    assert not offenders, offenders
