"""A whole run of each cell on the card (`cuda` tests, skipped here where
there is none):

    python -m pytest benchmark/tests -q -m cuda
"""

import json
import subprocess
import sys

import pytest

from benchmark import harness

CELLS = [w["name"] for w in harness.load_spec()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_run_on_the_card_is_correct(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the benchmark runs on the card only")
    out = subprocess.run([sys.executable, "-m", "benchmark.run",
                          "--workload", cell, "--seed", "2147483659",
                          "--seconds", "3", "--trace", "0"],
                         cwd=harness.ROOT, capture_output=True, text=True,
                         timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"


def test_no_card_no_result(monkeypatch, capsys):
    import torch
    from benchmark import run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(harness, "set_cache_dirs", lambda: None)
    assert run.main(["--workload", CELLS[0], "--seed", "1", "--seconds",
                     "1"]) != 0
    assert capsys.readouterr().out == ""
