"""The arithmetic of the metric readers (``metrics/<name>.py``), over what
a run recorded (``harness.Run``). A reader returns None where it finds
nothing to read; a device reading needs the profiler's trace, so it is
None in a run without one.
"""
from __future__ import annotations

from perfbench import yardstick as ys

# -- end to end ---------------------------------------------------------------


def tokens_per_s(run):
    """Every output token stamped inside the window, over its seconds."""
    n = sum(1 for r in run.reqs.values() for t in r.times
            if run.in_window(t))
    return n / run.window_s if run.window_s > 0 else None


def itl_ms(run, q: float):
    """The q-quantile of every gap between consecutive output tokens of a
    request whose later token falls inside the window."""
    gaps = [b - a for r in run.reqs.values()
            for a, b in zip(r.times, r.times[1:]) if run.in_window(b)]
    return 1e3 * ys.nearest_rank(gaps, q) if gaps else None


def due_in_window(run):
    return [r for r in run.reqs.values()
            if run.t_open <= r.due < run.t_open + run.seconds]


def ttft_ms(run, q: float):
    """The q-quantile over every request due inside the window, from its
    due time to its first token; one with none by the window's end
    counts with the time it had waited then."""
    waits = [(r.times[0] if r.times and r.times[0] <= run.t_end
              else run.t_end) - r.due for r in due_in_window(run)]
    return 1e3 * ys.nearest_rank(waits, q) if waits else None


def queue_wait_ms(run, q: float):
    """The q-quantile over every request due inside the window, from its
    due time to the start of the tick that admitted it (or the window's
    end)."""
    waits = [(r.admit if r.admit is not None and r.admit <= run.t_end
              else run.t_end) - r.due for r in due_in_window(run)]
    return 1e3 * ys.nearest_rank(waits, q) if waits else None


def setup_s(run):
    return run.t_open - run.t_process


def peak_device_gib(run):
    return run.memory_peak / 2 ** 30 if run.memory_peak else None


# -- engine and model step ----------------------------------------------------


def slot_occupancy(run):
    """Mean share of the engine's slots holding a request after each
    tick of the window."""
    steps = [s for s in run.steps if run.in_window(s[1])]
    if not steps or not run.batch_slots:
        return None
    return 100.0 * sum(s[2] for s in steps) / (len(steps) * run.batch_slots)


def call_ms(run, name: str, min_c: int = 1):
    """Mean host ms per model call ``name`` of width >= ``min_c`` inside
    the window, from its start to the device's end of its work, outside
    the profiled ticks."""
    calls = [c for c in run.calls if c["name"] == name and c["c"] >= min_c
             and not c["traced"] and run.in_window(c["t1"])]
    if not calls:
        return None
    return 1e3 * sum(c["t1"] - c["t0"] for c in calls) / len(calls)


def _traced_calls(run):
    return [c for c in run.calls if c["traced"]]


def mfu(run):
    """Useful model flops of the profiled ticks over their host seconds,
    as a share of the card's dense bf16 peak (none off the card)."""
    t0, t1 = run.traced_span()
    calls = _traced_calls(run)
    if t0 is None or not calls or _trace(run) is None:
        return None
    flops = 0.0
    for c in calls:
        logit_rows = int((c["n_valid"] > 0).sum())
        flops += ys.step_flops(run.arch, c["ctx"], c["n_valid"], logit_rows)
    return 100.0 * flops / ((t1 - t0) * ys.PEAK_FLOPS)


# -- device (from the trace) --------------------------------------------------


def _trace(run):
    """The run's trace where it holds engine ticks and device ops (a run
    off the card has none: no device reading comes from it)."""
    tr = run.trace
    ok = tr is not None and tr.t0 is not None and tr.kernels()
    return tr if ok else None


def device_idle_share(run):
    tr = _trace(run)
    if tr is None or tr.span_s <= 0:
        return None
    return 100.0 * (tr.span_s - tr.busy_s()) / tr.span_s


def moe_device_share(run):
    tr = _trace(run)
    if tr is None:
        return None
    total = tr.device_time(lambda op, label: True)
    moe = tr.device_time(lambda op, label: label == "moe_apply")
    return 100.0 * moe / total if total > 0 and moe > 0 else None


def moe_roofline(run):
    """The MoE layers' least time (``yardstick.moe_cost``) over the device
    time of the kernels launched inside ``moe_apply``."""
    tr = _trace(run)
    if tr is None or not run.arch.get("n_experts"):
        return None
    n_moe = sum(1 for i in range(run.arch["n_layers"]) if run.arch[
        "pattern"][i % len(run.arch["pattern"])].endswith("+moe"))
    bound = 0.0
    for c in _traced_calls(run):
        rows = len(c["n_valid"]) * c["c"]
        valid = int(c["n_valid"].sum())
        bound += n_moe * ys.tc_bound_s(*ys.moe_cost(run.arch, rows, valid))
    dev = tr.device_time(lambda op, label: label == "moe_apply")
    return 100.0 * bound / dev if dev > 0 and bound > 0 else None


def spx_matmul_roofline(run):
    """The recorded ``spx_matmul`` launches' least times over the device
    time of the kernels named ``spx_matmul_kernel*``."""
    tr = _trace(run)
    if tr is None or not run.spx:
        return None
    bound = sum(ys.tc_bound_s(*ys.spx_matmul_cost(*launch))
                for launch in run.spx)
    dev = tr.device_time(lambda op, label: "spx_matmul_kernel" in op[2])
    return 100.0 * bound / dev if dev > 0 else None


def paged_decode_roofline(run):
    """The decode ticks' ragged attention launches (one per attention
    layer per ``lm_paged_fused_step`` call), their least time from each
    row's context, over the device time of the ``paged_decode`` kernels
    launched inside those calls."""
    tr = _trace(run)
    if tr is None:
        return None
    a = run.arch
    bound = 0.0
    for c in _traced_calls(run):
        if c["name"] != "lm_paged_fused_step":
            continue
        n = c["launches"].get("paged_decode_ragged", 0)
        bound += n * ys.tc_bound_s(*ys.paged_decode_cost(
            c["ctx"], c["n_valid"], n_heads=a["n_heads"],
            n_kv_heads=a["n_kv_heads"], head_dim=a["head_dim"]))
    dev = tr.device_time(lambda op, label: "paged_decode" in op[2]
                         and label == "lm_paged_fused_step")
    return 100.0 * bound / dev if dev > 0 and bound > 0 else None
