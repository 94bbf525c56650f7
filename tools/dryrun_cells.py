"""Run production dry-run cells (``repro_torch.launch.dryrun``) side by side,
one process each, and record per cell its wall seconds, its peak
resident bytes and its report (``build/dryrun/`` artifacts).

Each cell is ``arch:shape:single|multi``, or ``arch:shape:DxM``: the
cell's per-device work on a smaller ``meta`` mesh of D data groups and
M model shards (its rows scaled by the device count: how the run's cost
grows with the devices); a cell past ``--limit`` seconds
or ``--rss-gib`` GiB of resident memory is stopped, and the summary says
so with the time and memory it reached. ``--profile`` also runs
``cProfile`` over one 4-device meta run (gemma-2b's train step at full
width on a (2, 2) mesh, 4 rows of 4096 tokens) and keeps its top
functions. The summary (``--out``, JSON) is rewritten as each cell ends.
No card is needed: every step runs on ``meta``.

  PYTHONPATH=src python tools/dryrun_cells.py --jobs 6 \\
      gemma-2b:train_4k:single kimi-k2-1t-a32b:train_4k:multi ...
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.normpath(os.path.join(os.path.dirname(__file__), ".."))

_PROFILE = r"""
import cProfile, io, pstats, sys, time
import torch
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch.dryrun import dry_report
from repro_torch.launch.mesh import make_host_mesh
torch.set_num_threads(1)
prof = cProfile.Profile()
t0 = time.monotonic()
prof.enable()
rep = dry_report(get_config("gemma-2b"), ShapeConfig("t", 4096, 4, "train"),
                 make_host_mesh(2, 2, ["meta"] * 4))
prof.disable()
out = io.StringIO()
stats = pstats.Stats(prof, stream=out)
stats.sort_stats("tottime").print_stats(25)
stats.sort_stats("cumulative").print_stats(25)
print(out.getvalue())
print("PROFILE", rep["build_s"], rep["run_s"], time.monotonic() - t0)
"""

#: one ``arch:shape:DxM`` cell: the shape's rows per device on a D x M
#: meta mesh; argv: arch, shape, D, M, artifact dir
_SCALED = r"""
import dataclasses, json, os, resource, sys, time
import torch
from repro_torch.configs import get_config
from repro_torch.configs.base import LM_SHAPES
from repro_torch.launch.dryrun import dry_report
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
torch.set_num_threads(1)
arch, name, d, m, out = sys.argv[1:6]
d, m = int(d), int(m)
shape = next(s for s in LM_SHAPES if s.name == name)
rows = shape.global_batch * d * m // len(make_production_mesh().devices)
shape = dataclasses.replace(shape, global_batch=max(rows, 1))
rep = dry_report(get_config(arch), shape, make_host_mesh(d, m, ["meta"] * (d * m)))
rep["host_max_rss_bytes"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
rep.pop("argument_by_device")
rep["collectives"].pop("by_device")
os.makedirs(out, exist_ok=True)
with open(os.path.join(out, f"dryrun_{arch}_{name}_{d}x{m}.json"), "w") as f:
    json.dump(rep, f, indent=1)
print("SCALED", arch, name, d, m, rep["build_s"], rep["run_s"])
"""


def _rss(pid: int) -> int:
    """Resident bytes of a process (0 once it is gone)."""
    try:
        with open(f"/proc/{pid}/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("cells", nargs="+", help="arch:shape:single|multi|DxM")
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--limit", type=float, default=3600.0)
    ap.add_argument("--rss-gib", type=float, default=24.0)
    ap.add_argument("--artifact-dir",
                    default=os.path.join(REPO, "build", "dryrun"))
    ap.add_argument("--out", default=os.path.join(REPO, "build",
                                                  "dryrun_cells.json"))
    ap.add_argument("--logs", default=os.path.join(REPO, "build",
                                                   "dryrun_logs"))
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args(argv)
    os.makedirs(args.logs, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    todo = [c.split(":") for c in args.cells]
    if args.profile:
        todo.insert(0, ["profile", "gemma-2b", "2x2"])
    running: dict = {}
    summary: dict = {}

    def write():
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)

    while todo or running:
        while todo and len(running) < args.jobs:
            cell = todo.pop(0)
            name = ":".join(cell)
            log = open(os.path.join(args.logs, name.replace(":", "_")
                                    + ".log"), "w")
            if cell[0] == "profile":
                cmd = [sys.executable, "-c", _PROFILE]
            elif cell[2] not in ("single", "multi"):
                d, m = cell[2].split("x")
                cmd = [sys.executable, "-c", _SCALED, cell[0], cell[1], d, m,
                       args.artifact_dir]
            else:
                arch, shape, mesh = cell
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", arch, "--shape", shape,
                       "--artifact-dir", args.artifact_dir]
                if mesh == "multi":
                    cmd.append("--multi-pod")
            proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                                    env=env, cwd=REPO)
            running[name] = (proc, time.monotonic(), log, [0])
        time.sleep(2.0)
        for name, (proc, t0, log, peak) in list(running.items()):
            peak[0] = max(peak[0], _rss(proc.pid))
            seconds = time.monotonic() - t0
            why = None
            if proc.poll() is None:
                if seconds > args.limit:
                    why = f"stopped at {seconds:.0f} s (limit {args.limit:.0f})"
                elif peak[0] > args.rss_gib * 2 ** 30:
                    why = (f"stopped at {peak[0] / 2 ** 30:.1f} GiB resident "
                           f"(limit {args.rss_gib})")
                if why is None:
                    continue
                proc.kill()
                proc.wait()
            log.close()
            del running[name]
            summary[name] = {"status": why or f"exit {proc.returncode}",
                             "seconds": seconds,
                             "peak_rss_bytes": peak[0]}
            print(name, summary[name], flush=True)
            write()
    write()
    return 0


if __name__ == "__main__":
    sys.exit(main())
