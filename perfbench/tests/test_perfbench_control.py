"""The control on the card: the reference one precision below the
configurations' (TF32 matmuls) in the program's place reads as not
correct, and the program reads as correct, at each cell's own size for
one seed and a short window. ``python -m pytest -m gpu perfbench/tests``
on the card; ``perfbench/control.py`` reads more seeds."""
import sys
from pathlib import Path

import pytest

from perfbench import harness

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

CELLS = [w["name"] for w in harness.load_bench(harness.ROOT.parent)[
    "workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_and_program_passes(cuda, workload):
    import control
    cell = harness.resolve(harness.load_bench(harness.ROOT.parent),
                           workload, trace=False)
    res = harness.run_cell(cell, 2 ** 31 + 77, 20.0, False,
                           log=lambda m: None,
                           checker=control.control_checker)
    limit = cell.limits["gap_max"]["limit"]
    assert res["checks"]["gap_max"]["value"] <= limit
    assert res["checks"]["control_gap_max"] == pytest.approx(
        {"value": res["checks"]["control_gap_max"]["value"], "limit": limit})
    assert res["checks"]["control_gap_max"]["value"] > limit
    assert res["correct"] is False
