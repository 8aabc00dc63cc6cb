"""BENCHMARK.json against its rules, and every cell's files found by
name."""

import copy
import json
import re

import pytest

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = harness.load_spec()


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_names_units_and_keys():
    names = set()
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        for key in ("name", "config", "traffic"):
            assert NAME.match(w[key]), w[key]
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["name"] not in names
        names.add(m["name"])
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_resolves_by_name(cell):
    r = harness.resolve(SPEC, cell)
    assert r["config"]["name"] == r["cell"]["config"]
    assert hasattr(r["driver"], "run")
    reported = {m["name"] for m in r["end_to_end"]}
    assert "setup_s" in reported and len(reported) >= 2
    assert r["per_layer"]
    for m in r["per_layer"]:
        reader = harness.metric_reader(m["name"])
        assert (reader.UNIT, reader.LAYER, reader.MOVES) == (
            m["unit"], m["layer"], m["moves"])
        assert m["moves"] in reported


def test_a_cell_added_by_an_entry_alone():
    """A new cell made of existing files needs one new entry and no edit:
    here a second traffic name for the offline mix, with a throwaway
    metric reader from a file of its own."""
    spec = copy.deepcopy(SPEC)
    spec["workloads"].append({"name": "throwaway", "config":
                              "yolov3-coco-416", "traffic": "offline-b128",
                              "chips": 1, "why": "test"})
    spec["per_layer"][0]["workloads"].append("throwaway")
    r = harness.resolve(spec, "throwaway")
    assert r["traffic"]["driver"] == "offline"
    assert [m["name"] for m in r["per_layer"]] == [spec["per_layer"][0][
        "name"]]


def test_a_metric_reader_from_any_file(tmp_path):
    path = tmp_path / "x.new_metric.py"
    path.write_text("UNIT = '%'\ndef read(view, ctx):\n    return 1.5\n")
    assert harness.load_module(path).read(None, None) == 1.5


def test_unknown_cell_raises():
    with pytest.raises(KeyError):
        harness.resolve(SPEC, "no-such-cell")
