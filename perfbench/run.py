"""The port's benchmark: one run of one cell.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The cell (an entry of ``BENCHMARK.json``'s
``workloads``) is served by ``repro_torch`` on one CUDA device; the last
line of standard output is the result, one JSON object. ``--trace 0``
reports the cell's end-to-end metrics, ``--trace 1`` its per-layer
metrics: host readings from the window, device readings from a profiled
stretch of the same traffic after it. Exits non-zero with no
result when there is no CUDA device (or fewer than the cell asks for),
when the program is not beside the benchmark, and when a module of JAX
or of the JAX package is loaded once the window has closed.
"""
import time

T_PROCESS = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: top-level module names no run may hold: JAX, and the JAX package the
#: port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def pin_environment() -> list:
    """Drop every ``REPRO_`` knob of the program from this process's
    environment: the cell's traffic file sets the engine's settings, and
    the program's planner and build directory keep their defaults."""
    dropped = sorted(k for k in os.environ if k.startswith("REPRO_"))
    for k in dropped:
        del os.environ[k]
    return dropped


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    of ``FORBIDDEN``, compared whole."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable ({exc})"


def err(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    dropped = pin_environment()
    if not (ROOT / "src" / "repro_torch").is_dir():
        err(f"[perfbench] the program (src/repro_torch) is not beside the "
            f"benchmark under {ROOT}")
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from perfbench import harness
    bench = harness.load_bench(ROOT)
    cell = harness.resolve(bench, args.workload, trace=bool(args.trace))

    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        err(f"[perfbench] {args.workload} needs {cell.chips} CUDA "
            f"device(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    # the configurations state f32 activations: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    err(f"[perfbench] card: {card_line()}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; TF32 off; dropped {dropped}")
    seed = args.seed % (1 << 64)
    result = harness.run_cell(cell, seed, args.seconds, bool(args.trace),
                              t_process=T_PROCESS)
    found = forbidden_modules()
    if found:
        err(f"[perfbench] the run loaded forbidden modules: {found}")
        return 4
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
