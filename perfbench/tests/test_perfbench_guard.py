"""run.py's guards: no result without a card, none without the program
beside the benchmark, and none once JAX or the JAX package is loaded."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
RUN = ROOT / "perfbench" / "run.py"
ARGS = ["--workload", "qwen2-vl-2b.docs-open", "--seed", "2147483659",
        "--seconds", "1", "--trace", "0"]


def _run(cwd: Path, env=None):
    return subprocess.run([sys.executable, "perfbench/run.py", *ARGS],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=300, env=env)


def _last_line_is_result(out: str) -> bool:
    lines = out.strip().splitlines()
    if not lines:
        return False
    try:
        return "correct" in json.loads(lines[-1])
    except json.JSONDecodeError:
        return False


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    sys.path.insert(0, str(RUN.parent))
    import run
    for name in ("jax", "jaxlib.xla", "flax", "repro", "repro.core.spx"):
        monkeypatch.setitem(sys.modules, name, sys)
        assert name.split(".")[0] in run.forbidden_modules()
        monkeypatch.delitem(sys.modules, name)
    for name in ("repro_torch", "repro_torch.nn", "jaxtyping", "reprox"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert run.forbidden_modules() == sorted(
        {n.split(".")[0] for n in sys.modules} & set(run.FORBIDDEN))
    assert not {"repro_torch", "jaxtyping", "reprox"} & set(
        run.forbidden_modules())


def test_pin_environment_drops_every_program_knob(monkeypatch):
    sys.path.insert(0, str(RUN.parent))
    import run
    monkeypatch.setenv("REPRO_SPEC_K", "4")
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", "/elsewhere")
    dropped = run.pin_environment()
    assert {"REPRO_SPEC_K", "REPRO_TORCH_BUILD_DIR"} <= set(dropped)
    assert not any(k.startswith("REPRO_") for k in os.environ)


def test_no_card_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    res = _run(ROOT)
    assert res.returncode != 0 and not _last_line_is_result(res.stdout)
    assert "CUDA device" in res.stderr


def test_no_program_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = _run(tmp_path)
    assert res.returncode != 0 and not _last_line_is_result(res.stdout)


def test_the_benchmark_imports_nothing_of_jax():
    """The harness and the reference name neither JAX nor the JAX
    package in an import (the run's own guard checks what is loaded)."""
    for path in (ROOT / "perfbench").rglob("*.py"):
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                top = words[1].split(".")[0]
                assert top not in ("jax", "jaxlib", "flax", "repro"), \
                    (path, line)
