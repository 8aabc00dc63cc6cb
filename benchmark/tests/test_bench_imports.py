"""The import check compares whole top-level names, and the reference
imports neither JAX nor either package."""

import ast
from pathlib import Path

import pytest

from benchmark import harness

REFERENCE = Path(harness.HERE) / "reference"


@pytest.mark.parametrize("name,caught", [
    ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True),
    ("flax.linen", True), ("yolov3_tensorflow_tpu", True),
    ("yolov3_tensorflow_tpu.ops.nms", True),
    ("yolov3_tensorflow_tpu_torch", False),
    ("yolov3_tensorflow_tpu_torch.ops.nms_cuda", False),
    ("jaxtyping", False), ("torch", False)])
def test_forbidden_by_whole_top_level_name(name, caught):
    found = harness.forbidden_modules({name: None, "torch": None})
    assert bool(found) == caught


def imported_roots(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(REFERENCE.glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_neither_package(path):
    roots = set(imported_roots(path))
    assert not roots & {"jax", "jaxlib", "flax", "yolov3_tensorflow_tpu",
                        "yolov3_tensorflow_tpu_torch"}
    assert roots <= {"__future__", "math", "typing", "numpy", "torch"}


def test_harness_sources_import_no_jax():
    for path in Path(harness.HERE).rglob("*.py"):
        if "tests" in path.parts:
            continue
        roots = set(imported_roots(path))
        assert not roots & {"jax", "jaxlib", "flax",
                            "yolov3_tensorflow_tpu"}, path
