"""Run production dry-run cells (``repro_torch.launch.dryrun``) side by side,
one process each, and record per cell its wall seconds, its peak
resident bytes and the figures of its report (``build/dryrun/``
artifacts).

Each cell is ``arch:shape:single|multi`` (the CLI's cell on the 16 x 16 or
2 x 16 x 16 mesh, one representative per symmetric class), the same with
``-all`` (``single-all``: every device run, the artifact under ``all/``;
run after the class-path cell, its summary says whether every field the
class path holds equal is equal), or
``arch:shape:DxM``: the cell's per-device work on a smaller ``meta`` mesh
of D data groups and M model shards, every device run (its rows scaled
by the device count: how the all-devices run's cost grows with the
devices). ``--all`` adds every production cell of both meshes; a cell
the arch skips is recorded with the reference's status and not run. A
cell past ``--limit`` seconds or ``--rss-gib`` GiB of resident memory is
stopped, and the summary says so with the time and memory it reached.
``--profile CELL`` (repeatable; ``arch:shape:DxM`` or
``arch:shape:single|multi`` as above) runs ``cProfile`` over that cell
and keeps its top functions in the summary. The summary (``--out``,
JSON) is rewritten as each cell ends; ``--table`` prints PERF.md's table
of the production cells from it. No card is needed: every step runs on
``meta``.

  PYTHONPATH=src python tools/dryrun_cells.py --jobs 6 --limit 900 \\
      --rss-gib 8 --all
  PYTHONPATH=src python tools/dryrun_cells.py \\
      --profile kimi-k2-1t-a32b:train_4k:1x16
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.normpath(os.path.join(os.path.dirname(__file__), ".."))

#: one cell in this process: argv arch, shape, mesh (single, multi or
#: DxM), artifact dir, profile (0 or 1)
_CELL = r"""
import cProfile, dataclasses, io, json, os, pstats, resource, sys, time
import torch
from repro_torch.configs import get_config
from repro_torch.configs.base import LM_SHAPES
from repro_torch.launch.dryrun import dry_report, run_cell
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
torch.set_num_threads(1)
arch, name, mesh, out, profile = sys.argv[1:6]
prof = cProfile.Profile()
if profile == "1":
    prof.enable()
if mesh.split("-")[0] in ("single", "multi"):
    every = mesh.endswith("-all")
    rep = run_cell(arch, name, multi_pod=mesh.startswith("multi"),
                   artifact_dir=os.path.join(out, "all") if every else out,
                   classes=not every)
else:
    d, m = (int(v) for v in mesh.split("x"))
    shape = next(s for s in LM_SHAPES if s.name == name)
    rows = shape.global_batch * d * m // len(make_production_mesh().devices)
    shape = dataclasses.replace(shape, global_batch=max(rows, 1))
    rep = dry_report(get_config(arch), shape,
                     make_host_mesh(d, m, ["meta"] * (d * m)))
    rep["host_max_rss_bytes"] = resource.getrusage(
        resource.RUSAGE_SELF).ru_maxrss * 1024
    rep.pop("argument_by_device")
    rep["collectives"].pop("by_device")
    os.makedirs(out, exist_ok=True)
    fname = f"dryrun_{arch.replace('.', '_')}_{name}_{mesh}.json"
    with open(os.path.join(out, fname), "w") as f:
        json.dump(rep, f, indent=1)
if profile == "1":
    prof.disable()
    text = io.StringIO()
    stats = pstats.Stats(prof, stream=text)
    stats.sort_stats("tottime").print_stats(15)
    stats.sort_stats("cumulative").print_stats(30)
    print(text.getvalue())
print("CELL", arch, name, mesh, rep.get("build_s"), rep.get("run_s"))
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


def _artifact(artifact_dir: str, arch: str, shape: str, mesh: str) -> str:
    if mesh.endswith("-all"):
        artifact_dir, mesh = os.path.join(artifact_dir, "all"), mesh[:-4]
    return os.path.join(artifact_dir, f"dryrun_{arch.replace('.', '_')}_"
                        f"{shape}_{mesh}.json")


def _held_fields(path: str) -> dict:
    """The fields of an artifact the class path holds equal to the
    all-devices run's."""
    with open(path) as f:
        rep = json.load(f)
    mem = rep["memory"]
    return {"memory": {k: mem[k] for k in ("argument_bytes",
                                           "argument_parts", "output_bytes",
                                           "alias_bytes")},
            "cost": {k: rep["cost"][k] for k in ("flops", "flops_total")},
            **{k: rep[k] for k in ("argument_by_device", "collectives",
                                   "departures", "uneven",
                                   "argument_leaves", "meta")}}


def _figures(path: str) -> dict:
    """What PERF.md's table reads from a cell's artifact: per-device
    peak and argument bytes, flops, the busiest device's collective bytes
    by kind, the classes run and the host seconds."""
    with open(path) as f:
        rep = json.load(f)
    mem = rep["memory"]
    classes = rep.get("classes")
    return {"peak_per_device_bytes": mem["peak_per_device_bytes"],
            "argument_bytes": mem["argument_bytes"],
            "temp_bytes": mem["temp_bytes"],
            "temp_over": mem.get("temp_over"),
            "flops_per_device": rep["cost"]["flops"],
            "collective_bytes": {k: c["bytes"] for k, c in
                                 rep["collectives"]["busiest"].items()},
            "meta": {k: rep["meta"].get(k) for k in
                     ("parallelism", "accum_steps", "fsdp",
                      "context_parallel")},
            "classes": None if classes is None else [
                [c["representative"][0], len(c["representative"]),
                 c["units"]] for c in classes],
            "build_s": rep["build_s"], "run_s": rep["run_s"]}


#: the collective kinds, abbreviated in ``table``
_KINDS = (("all-gather", "AG"), ("all-reduce", "AR"),
          ("reduce-scatter", "RS"), ("all-to-all", "A2A"))


def table(summary: dict) -> str:
    """PERF.md's table of the production cells from a summary (``--out``):
    one row per (arch, shape), each column ``16x16 · 2x16x16``: per
    device the peak and argument GB (the H100 holds 80), TFLOP and the
    busiest device's collective GB by kind; the devices the class path
    ran, the host seconds and the resident GB; a cell that did not finish
    shows its status."""
    rows, seen = [], {}
    for name, rec in summary.items():
        arch, shape, mesh = name.split(" ")[0].split(":")
        seen.setdefault((arch, shape), {})[mesh] = rec

    def cell(rec, f):
        if rec is None:
            return "—"
        if "peak_per_device_bytes" not in rec:
            return rec["status"]
        return f(rec)
    cols = (("peak GB", lambda r: f"{r['peak_per_device_bytes'] / 1e9:.2f}"),
            ("args GB", lambda r: f"{r['argument_bytes'] / 1e9:.2f}"),
            ("TFLOP", lambda r: f"{r['flops_per_device'] / 1e12:.3g}"),
            ("AG / AR / RS / A2A GB", lambda r: " / ".join(
                f"{r['collective_bytes'].get(k, 0) / 1e9:.3g}"
                for k, _ in _KINDS)),
            ("run", lambda r: str(sum(n for _, n, _ in r["classes"]))
             if r["classes"] else "all"),
            ("host s", lambda r: f"{r['seconds']:.0f}"),
            ("RSS GB", lambda r: f"{r['peak_rss_bytes'] / 1e9:.2f}"))
    out = ["| arch | shape | " + " | ".join(c for c, _ in cols) + " |",
           "|---|---|" + "---|" * len(cols)]
    skipped: dict = {}
    order = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
    for (arch, shape), by in sorted(seen.items(), key=lambda kv: (
            kv[0][0], order.index(kv[0][1]) if kv[0][1] in order else 9)):
        if all(set(r) == {"status"} for r in by.values()):
            status = " · ".join(by[m]["status"] for m in ("single", "multi")
                                if m in by)
            skipped.setdefault((shape, status), []).append(arch)
            continue
        out.append(f"| {arch} | {shape} | " + " | ".join(
            " · ".join(cell(by.get(m), f) for m in ("single", "multi"))
            for _, f in cols) + " |")
    for (shape, status), archs in skipped.items():
        out.append(f"\n{shape}: {status} on {', '.join(archs)}.")
    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("cells", nargs="*", help="arch:shape:single|multi|DxM")
    ap.add_argument("--all", action="store_true",
                    help="every production cell of both meshes")
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--limit", type=float, default=3600.0)
    ap.add_argument("--rss-gib", type=float, default=24.0)
    ap.add_argument("--artifact-dir",
                    default=os.path.join(REPO, "build", "dryrun"))
    ap.add_argument("--out", default=os.path.join(REPO, "build",
                                                  "dryrun_cells.json"))
    ap.add_argument("--logs", default=os.path.join(REPO, "build",
                                                   "dryrun_logs"))
    ap.add_argument("--profile", action="append", default=[],
                    metavar="CELL", help="arch:shape:single|multi|DxM")
    ap.add_argument("--table", action="store_true",
                    help="print the markdown table of the summary --out "
                         "holds, and run nothing")
    args = ap.parse_args(argv)
    if args.table:
        with open(args.out) as f:
            print(table(json.load(f)))
        return 0
    os.makedirs(args.logs, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    sys.path.insert(0, os.path.join(REPO, "src"))
    from repro_torch.configs import assigned_archs, get_config

    summary: dict = {}
    todo = [c.split(":") + ["0"] for c in args.cells]
    todo += [c.split(":") + ["1"] for c in args.profile]
    if args.all:
        for mesh in ("single", "multi"):
            for arch in assigned_archs():
                for s, skip in get_config(arch).shapes():
                    name = f"{arch}:{s.name}:{mesh}"
                    if skip:
                        summary[name] = {"status": skip}
                    else:
                        todo.append([arch, s.name, mesh, "0"])
    running: dict = {}

    def write():
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)

    while todo or running:
        while todo and len(running) < args.jobs:
            cell = todo.pop(0)
            name = ":".join(cell[:3]) + (" profile" if cell[3] == "1"
                                         else "")
            log_path = os.path.join(args.logs, name.replace(":", "_")
                                    .replace(" ", "_") + ".log")
            log = open(log_path, "w")
            cmd = [sys.executable, "-c", _CELL, *cell[:3],
                   args.artifact_dir, cell[3]]
            proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                                    env=env, cwd=REPO)
            running[name] = (proc, time.monotonic(), log, [0], cell,
                             log_path)
        time.sleep(2.0)
        for name, (proc, t0, log, peak, cell, log_path) in \
                list(running.items()):
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
            rec = {"status": why or f"exit {proc.returncode}",
                   "seconds": seconds, "peak_rss_bytes": peak[0]}
            path = _artifact(args.artifact_dir, *cell[:3])
            if why is None and proc.returncode == 0 and os.path.exists(path):
                rec.update(_figures(path))
                # an all-devices cell beside its class-path artifact
                pair = _artifact(args.artifact_dir, *cell[:2],
                                 cell[2][:-4])
                if cell[2].endswith("-all") and os.path.exists(pair):
                    rec["equal_to_class_path"] = \
                        _held_fields(path) == _held_fields(pair)
            if cell[3] == "1":
                with open(log_path) as f:
                    rec["profile"] = f.read().splitlines()[:120]
            summary[name] = rec
            print(name, {k: rec[k] for k in ("status", "seconds",
                                             "peak_rss_bytes")}, flush=True)
            write()
    write()
    return 0


if __name__ == "__main__":
    sys.exit(main())
