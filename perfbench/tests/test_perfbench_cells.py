"""BENCHMARK.json against the contract's shape rules, and every cell and
metric resolving to its files by name."""
import json
import re

import pytest

from perfbench import harness

BENCH = harness.load_bench(harness.ROOT.parent)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["paths"] == ["perfbench"]
    assert len(json.dumps(BENCH)) < 64 * 1024
    for w in BENCH["workloads"]:
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200


def test_names_and_units():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics]
    assert len(names) == len(set(names))
    for n in names + CELLS + [c["name"] for c in BENCH["configs"]]:
        assert NAME.match(n), n
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_per_layer_metrics_move_a_reported_end_to_end_metric():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        for w in m["workloads"]:
            assert w in CELLS
            assert "workloads" not in moved or w in moved["workloads"], \
                (m["name"], w)


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_cell_resolves_to_its_files(workload, trace):
    cell = harness.resolve(BENCH, workload, trace=trace)
    assert cell.metrics, "a cell reports metrics in both kinds of run"
    for name, path in cell.metrics.items():
        assert path.is_file(), path
        assert callable(harness.load_reader(path))
    assert cell.config["arch"]["name"] == cell.config["name"]
    assert {"loop", "serve", "prompt", "output"} <= set(cell.traffic)
    assert "gap_max" in cell.limits
    if not trace:
        assert "setup_s" in cell.metrics and len(cell.metrics) >= 2


def test_configs_list_their_files_and_changed_keys():
    for c in BENCH["configs"]:
        with open(harness.ROOT.parent / c["file"]) as f:
            conf = json.load(f)
        assert conf["reduced"] == c["reduced"] and conf["source"] == c["source"]
        for key in c["reduced"]:
            assert not key.endswith(("_dim", "_rank")) and key != "d_model"


def test_every_reader_file_is_a_metric():
    named = {m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}
    files = {p.name[:-3] for p in (harness.ROOT / "metrics").glob("*.py")}
    assert files == named
