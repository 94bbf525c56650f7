"""One run of one cell: build the program from the cell's files, warm its
shapes, serve the cell's traffic for a window, read the metrics, and hold
what it served to the plain reference.

Everything a cell needs is found by name: ``configs/<config>.json`` (the
model as it is run, and the module of its plain reference under
``reference/``), ``traffic/<traffic>.json`` (the engine's settings and the
mix the one generator draws), ``limits/<workload>.json`` (the limit of
each number that decides ``correct``) and ``metrics/<metric>.py`` (one
reader per metric, ``read(run) -> float | None``).

Timeline of a run: set-up (imports, the weights drawn on the device and
quantized by the program, the engine, one warm-up request per prefill
width; in a traced run also one profiler session over a tiny op, which
pays the profiler's first start), then the traffic from ``t_start``; the
window opens at the end of the first engine tick that ends ``ramp_s``
after it, so that it finds the engine running, and closes at the end of
the last tick that started within ``seconds`` of the opening. A traced
run serves its window as an untraced one does, so that every host
reading of the window is taken alike, and then profiles ``trace_s``
seconds more of the same traffic: the device readings come from there.
Every engine tick is synchronous; the host stamps every output token at
the end of the tick that produced it, when a client would see it.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from perfbench import trace as trace_mod
from perfbench import weights
from perfbench.traffic import Traffic

ROOT = Path(__file__).resolve().parent
#: the program's step functions whose calls are timed and counted
STEP_FNS = ("lm_paged_step", "lm_paged_fused_step")
#: request ids of the warm-up requests, apart from the traffic's
WARM_RID = 1 << 40

clock = time.monotonic


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    metrics: dict            # metric name -> reader path
    units: dict              # metric name -> unit


def load_bench(root: Path) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def resolve(bench: dict, workload: str, *, trace: bool,
            here: Path = ROOT) -> Cell:
    """The cell ``workload`` of ``bench`` with its files read, and the
    metrics it reports in a run with (``trace``) or without tracing."""
    entry = next((w for w in bench["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json: "
                       f"{[w['name'] for w in bench['workloads']]}")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    with open(here.parent / conf["file"]) as f:
        config = json.load(f)
    with open(here / "traffic" / f"{entry['traffic']}.json") as f:
        traffic = json.load(f)
    with open(here / "limits" / f"{workload}.json") as f:
        limits = json.load(f)
    kind = "per_layer" if trace else "end_to_end"
    metrics, units = {}, {}
    for m in bench[kind]:
        if "workloads" in m and workload not in m["workloads"]:
            continue
        metrics[m["name"]] = here / "metrics" / f"{m['name']}.py"
        units[m["name"]] = m["unit"]
    return Cell(workload, entry["chips"], config, traffic, limits, metrics,
                units)


def load_reader(path: Path):
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# -- what a run records ------------------------------------------------------

@dataclasses.dataclass
class ReqLog:
    rid: int
    due: float
    prompt: np.ndarray
    max_new: int
    admit: float | None = None
    times: list = dataclasses.field(default_factory=list)
    output: list = dataclasses.field(default_factory=list)
    done: bool = False


@dataclasses.dataclass
class Run:
    """What the readers read."""
    cell: Cell
    arch: dict
    seconds: float
    t_process: float
    t_open: float = 0.0
    t_end: float = 0.0
    #: (t0, t1, slots held, traced, queued) of every tick
    steps: list = dataclasses.field(default_factory=list)
    calls: list = dataclasses.field(default_factory=list)
    spx: list = dataclasses.field(default_factory=list)     # traced launches
    reqs: dict = dataclasses.field(default_factory=dict)
    batch_slots: int = 0
    memory_peak: int = 0
    trace: object = None
    trace_ok: bool = False
    trace_why: str = ""
    traced_launches: dict = dataclasses.field(default_factory=dict)
    lateness: list = dataclasses.field(default_factory=list)
    #: seconds the profiler's start took, and the first traced tick
    profiler_start_s: float = 0.0

    @property
    def window_s(self) -> float:
        return self.t_end - self.t_open

    def in_window(self, t: float) -> bool:
        return self.t_open < t <= self.t_end

    def traced_span(self) -> tuple:
        traced = [s for s in self.steps if s[3]]
        return (traced[0][0], traced[-1][1]) if traced else (None, None)


# -- the program --------------------------------------------------------------

def arch_config(config: dict):
    from repro_torch.configs.base import ArchConfig
    arch = dict(config["arch"])
    for k in ("pattern", "mrope_sections"):
        if arch.get(k) is not None:
            arch[k] = tuple(arch[k])
    return ArchConfig(**arch)


def _stack(trees: list):
    """Per-layer trees stacked along a new leading (period) dim;
    quantized leaves by their codes and scales."""
    from repro_torch.core.quantized import QuantizedTensor
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if isinstance(first, QuantizedTensor):
        return QuantizedTensor(torch.stack([t.codes for t in trees]),
                               torch.stack([t.scale for t in trees]),
                               first.scheme, first.packed)
    return torch.stack(trees)


def build_params(arch: dict, scheme: str, seed: int, device) -> dict:
    """The benchmark's seeded weights in the program's tree, each layer
    quantized by the program's deployment step before the next is
    drawn."""
    from repro_torch.nn.layers import quantize_params
    params = weights.nest(weights.global_weights(arch, seed, device))
    pattern = arch["pattern"]
    per_slot = [[] for _ in pattern]
    for layer in range(arch["n_layers"]):
        tree = weights.nest(weights.layer_weights(arch, seed, layer, device))
        per_slot[layer % len(pattern)].append(quantize_params(tree, scheme))
    params["stack"] = {"slots": [_stack(t) for t in per_slot]}
    return params


class Instruments:
    """The benchmark's wrappers around the program's calls: every model
    step timed (synchronised at its end, so its span holds its device
    work) and annotated for the profiler, ``moe_apply`` annotated, and
    the shape of every ``spx_matmul`` launch recorded while ``traced``.
    Installed by attribute on the program's modules (the engine and the
    layers look them up at each call); ``restore`` puts them back."""

    def __init__(self, run: Run, device):
        from repro_torch.kernels import ops
        from repro_torch.models import lm
        from repro_torch.nn import transformer
        self.run, self.device, self.ops = run, device, ops
        self.traced = False
        self.saved = []
        for name in STEP_FNS:
            self._patch(lm, name, self._step(name, getattr(lm, name)))
        self._patch(transformer, "moe_apply",
                    self._annotated("moe_apply", transformer.moe_apply))
        self._patch(ops, "spx_matmul", self._spx(ops.spx_matmul))

    def _patch(self, mod, name, fn):
        self.saved.append((mod, name, getattr(mod, name)))
        setattr(mod, name, fn)

    def restore(self):
        for mod, name, fn in reversed(self.saved):
            setattr(mod, name, fn)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _step(self, name, fn):
        def call(params, tokens, ctx, bt, n_valid, *rest):
            nv, cx = n_valid.cpu().numpy(), ctx.cpu().numpy()
            before = self.ops.op_calls()
            t0 = clock()
            with torch.profiler.record_function(name):
                out = fn(params, tokens, ctx, bt, n_valid, *rest)
                self._sync()
            t1 = clock()
            after = self.ops.op_calls()
            self.run.calls.append(dict(
                name=name, c=int(tokens.shape[1]), n_valid=nv, ctx=cx,
                t0=t0, t1=t1, traced=self.traced,
                launches={k: after[k] - before.get(k, 0) for k in after
                          if after[k] != before.get(k, 0)}))
            return out
        return call

    @staticmethod
    def _annotated(name, fn):
        def call(*args, **kw):
            with torch.profiler.record_function(name):
                return fn(*args, **kw)
        return call

    def _spx(self, fn):
        def call(x, qt, **kw):
            if self.traced:
                k, n = qt.logical_shape
                self.run.spx.append((x.numel() // k, k, n, bool(qt.packed),
                                     16 if qt.scheme == "sp2_4" else 256))
            return fn(x, qt, **kw)
        return call


# -- the run -----------------------------------------------------------------

def _warm_up(eng, Request, traffic: Traffic, chunk: int, log=print):
    """One request per power-of-two prefill width up to the chunk, each
    alone in the engine (its prefill call at that width), then decoded
    for a tick: every shape the cell's traffic can ask for."""
    widths, w = [], 1
    while w <= chunk:
        widths.append(w)
        w *= 2
    t0 = clock()
    for i, w in enumerate(widths):
        item = traffic.item(i)
        eng.submit(Request(rid=WARM_RID + i,
                           prompt=np.resize(item.prompt, w).astype(np.int32),
                           max_new_tokens=2))
        while eng.has_work():
            eng.step()
    log(f"[perfbench] warm-up: prefill widths {widths}, "
        f"{clock() - t0:.3f} s")


def serve(run: Run, eng, Request, traffic: Traffic, spec: dict, *,
          trace: bool, instruments: Instruments, profile_dir: str | None):
    """The traffic's loop: the ramp, then the window."""
    closed = spec["loop"] == "closed"
    ramp_s = float(spec["ramp_s"])
    live: dict[int, list] = {}           # rid -> [ReqLog, Request, seen]
    next_index = 0
    t_start = clock()
    next_due = t_start + traffic.gap(0)

    def submit(due: float, now: float):
        nonlocal next_index
        item = traffic.item(next_index)
        log = ReqLog(next_index, due, item.prompt, item.max_new_tokens)
        req = Request(rid=next_index, prompt=item.prompt,
                      max_new_tokens=item.max_new_tokens)
        eng.submit(req)
        run.reqs[log.rid] = log
        live[log.rid] = [log, req, 0]
        run.lateness.append(now - due)
        next_index += 1

    if closed:
        for _ in range(int(spec["clients"])):
            submit(t_start, t_start)
    # the profiler covers trace_s seconds of the same traffic after the
    # window, so that neither its start nor its stop falls inside it
    trace_s = float(spec["trace_s"]) if trace else 0.0
    prof, t_traced = None, 0.0
    while True:
        now = clock()
        if run.t_open and now >= run.t_open + run.seconds:
            if not trace_s or (prof is not None
                               and now >= t_traced + trace_s):
                break
            if prof is None:
                prof = _start_profiler(instruments)
                run.traced_launches = {"before": instruments.ops.op_calls()}
                t_traced = clock()
                run.profiler_start_s = t_traced - now
        if not closed:
            while next_due <= now:
                submit(next_due, now)
                next_due += traffic.gap(next_index)
            if not eng.has_work():
                time.sleep(max(0.0, min(next_due - clock(), 0.05)))
                continue
        t0 = clock()
        with torch.profiler.record_function(trace_mod.STEP):
            eng.step()
        t1 = clock()
        traced = prof is not None
        busy = sum(r is not None for r in eng.slot_req)
        run.steps.append((t0, t1, busy, traced, len(eng.queue)))
        for rid in list(live):
            log, req, seen = live[rid]
            if log.admit is None and (req.output or req.done or any(
                    r is req for r in eng.slot_req)):
                log.admit = t0
            n = len(req.output)
            if n > seen:
                log.times.extend([t1] * (n - seen))
                live[rid][2] = n
            if req.done:
                log.done = True
                log.output = list(req.output)
                del live[rid]
                if closed:
                    submit(t1, t1)
        if not run.t_open and t1 >= t_start + ramp_s:
            run.t_open = t1
        if run.t_open and not traced:
            run.t_end = t1
    for log, req, _ in live.values():
        log.output = list(req.output)
    if prof is not None:
        instruments.traced = False
        run.traced_launches["after"] = instruments.ops.op_calls()
        prof.stop()
        path = os.path.join(profile_dir, "trace.json")
        prof.export_chrome_trace(path)
        run.trace = trace_mod.Trace.load(path)
        os.remove(path)


def _profiler(device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts, record_shapes=False,
                                  with_stack=False, profile_memory=False)


def _start_profiler(instruments: Instruments):
    prof = _profiler(instruments.device)
    prof.start()
    instruments.traced = True
    return prof


def warm_profiler(device, log) -> float:
    """One profiler session over a tiny op, in set-up: the profiler's
    first start in a process (loading and enabling its device tracing)
    stalls the host for seconds, which the traced stretch must not
    hold."""
    t0 = clock()
    with _profiler(device):
        x = torch.ones(1024, device=device)
        float((x * 2).sum())
    log(f"[perfbench] profiler warm-up session: {clock() - t0:.3f} s")
    return clock() - t0


def check_launches(run: Run):
    """The profiler has to have seen every launch the program counted
    over the traced ticks: else no per-layer metric is read."""
    if run.trace is None:
        run.trace_why = "no trace"
        return
    before = run.traced_launches.get("before", {})
    after = run.traced_launches.get("after", {})
    delta = {k: after.get(k, 0) - before.get(k, 0) for k in after}
    want = {"spx_matmul_kernel": delta.get("spx_matmul", 0),
            "paged_decode_kernel": delta.get("paged_decode_ragged", 0)
            + delta.get("paged_attention", 0)}
    got = {k: run.trace.count(k) for k in want}
    if run.trace.t0 is None:
        run.trace_why = "the trace holds no engine tick"
    elif got != want:
        run.trace_why = (f"the profiler saw {got} kernels where the program "
                         f"launched {want}")
    else:
        run.trace_ok = True


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", t_process: float | None = None,
             log=None, fault=None, checker=None) -> dict:
    """One run of ``cell``; returns the result line's object. ``fault``,
    for the benchmark's own tests, is called with the engine before the
    traffic starts and may break the program underneath; ``checker``
    replaces ``check.check`` (the control's readings)."""
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    t_process = clock() if t_process is None else t_process
    from repro_torch.runtime import Runtime
    from repro_torch.serving import Request, ServeConfig, ServeEngine

    dev = torch.device(device)
    config, spec = cell.config, cell.traffic
    arch = dict(config["arch"])
    cfg = arch_config(config)
    run = Run(cell, arch, float(seconds), t_process)
    t0 = clock()
    params = build_params(arch, config["quantized"]["scheme"], seed, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    log(f"[perfbench] weights: {clock() - t0:.3f} s")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    sc = ServeConfig(**spec["serve"])
    eng = ServeEngine(params, cfg, sc, rt=Runtime(device=device))
    del params
    run.batch_slots = eng.batch_slots
    log("[perfbench] serve config: " + json.dumps(
        {k: str(v) for k, v in dataclasses.asdict(eng.config).items()}))
    instruments = Instruments(run, dev)
    try:
        traffic = Traffic(spec, seed, arch["vocab_size"])
        _warm_up(eng, Request, Traffic(spec, seed, arch["vocab_size"],
                                       stream=1),
                 eng.config.prefill_chunk, log)
        eng.reset_metrics()
        run.calls.clear()
        if fault is not None:
            fault(eng)
        if trace:
            warm_profiler(dev, log)
        with tempfile.TemporaryDirectory() as tmp:
            serve(run, eng, Request, traffic, spec, trace=trace,
                  instruments=instruments, profile_dir=tmp)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            run.memory_peak = int(torch.cuda.max_memory_allocated(dev))
        late = sorted(run.lateness)
        log(f"[perfbench] window {run.window_s:.3f} s, "
            f"{sum(1 for s in run.steps if run.in_window(s[1]))} ticks; "
            f"{len(late)} requests submitted, late by (p50, p95, max) "
            f"{late[len(late) // 2]:.4f}, {late[int(0.95 * (len(late) - 1))]:.4f}, "
            f"{late[-1]:.4f} s")
        if trace:
            traced = [s for s in run.steps if s[3]]
            log(f"[perfbench] traced after the window: "
                f"{len(traced)} ticks, profiler start "
                f"{run.profiler_start_s:.3f} s, first traced tick "
                f"{traced[0][1] - traced[0][0] if traced else 0.0:.3f} s")
    finally:
        instruments.restore()
    del eng
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if trace:
        check_launches(run)
        if not run.trace_ok:
            log(f"[perfbench] no per-layer metric: {run.trace_why}")
    metrics = {}
    for name, path in cell.metrics.items():
        if trace and not run.trace_ok:
            break
        value = load_reader(path)(run)
        if value is not None:
            metrics[name] = {"value": float(value), "unit": cell.units[name]}
    from perfbench import check
    checks = (checker or check.check)(run, seed, dev, log)
    result = {
        "correct": all(c["value"] <= c["limit"] for c in checks.values()),
        "attempted": len(run.reqs),
        "failed": int(checks["bad_outputs"]["value"]),
        "metrics": metrics,
        "device": device_info(run, dev, trace),
    }
    if trace and run.trace is not None and run.trace.t0 is not None:
        result["breakdown"] = run.trace.breakdown()
    result["checks"] = checks
    return result


def device_info(run: Run, dev, trace: bool) -> dict:
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu"),
            "count": run.cell.chips,
            "memory_peak_bytes": run.memory_peak}
    if trace and run.trace is not None:
        info["busy_s"] = run.trace.busy_s()
        info["window_s"] = run.trace.span_s
    return info
