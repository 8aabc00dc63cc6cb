"""The comparison fails what it must: each fault a cell can have, planted
in the timed path of a whole run, and the control, the reference one
precision below the configuration's in the program's place."""

import pytest
import torch

from benchmark import control, harness
from benchmark.tests.tiny import CELLS, TINY, run_cell

KIND = {c: harness.resolve(harness.load_spec(), c)["traffic"]["driver"]
        for c in CELLS}


@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS
                                        for f in control.FAULTS[KIND[c]]])
def test_a_fault_is_not_correct(cell, fault):
    ctx, _ = run_cell(cell, faults=(fault,))
    assert not ctx.checks.correct, ctx.checks.as_dict()


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    limits = harness.resolve(harness.load_spec(), cell)["traffic"]["limits"]
    rows = list(control.readings(cell, [5], 0.5, torch.device("cpu"),
                                 ["control"], TINY[cell]))
    fp8 = [r for r in rows if r["variant"] == "control_fp8"]
    assert fp8
    for r in fp8:
        assert any(r[k] > limits[k] for k in limits if k in r), r
