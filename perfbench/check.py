"""What decides ``correct``: the served tokens held to the plain reference.

Once the window has closed, the memory peak has been read and the
engine is freed, every request the run finished (the longest finished
among them) goes through the configuration's plain reference, each
prompt with its served tokens appended: thousands of served tokens,
where a sample of some hundreds would let the control (TF32) pass on
some seeds. At every served position the reference's logits give a gap:
its best logit less its logit of the token the program served (0 where
they agree). The widest gap is compared with the cell's limit
(``limits/<workload>.json``). Served tokens are greedy, so a sound
program leaves only rounding there.

One rule leaves positions out, by the reference's own reading: where a
position's MoE routing is decided by less than ``router_margin`` (the
router logit of its k-th expert less its (k+1)-th's, at any MoE layer),
rounding alone picks the expert, and a sound f32 program may pick the
other one, moving that token's logits by a TF32 control's amount. Such
positions (about 1% of them) are not compared; both readings are
printed. Every finished request must also have served exactly its
``max_new_tokens`` tokens, each in the vocabulary.
"""
from __future__ import annotations

import importlib

import numpy as np
import torch

#: the gap of a run with nothing to compare: above every limit
NO_READING = 1e30


def finished(run) -> list:
    """Every request the run finished (in its ramp or its window), in
    request order: the longest finished among them."""
    return sorted((r for r in run.reqs.values() if r.done),
                  key=lambda r: r.rid)


def reference_module(config: dict):
    return importlib.import_module(
        f"perfbench.reference.{config['reference']}")


def reference_logits(config: dict, seed: int, reqs: list, device) -> tuple:
    """The reference's logits at each request's served positions (the
    logits after position P - 1 + j score served token j), and the
    routing margins there."""
    seqs = [np.concatenate([r.prompt, np.asarray(r.output[:-1], np.int32)])
            for r in reqs]
    want = [range(len(r.prompt) - 1, len(r.prompt) - 1 + len(r.output))
            for r in reqs]
    with torch.no_grad():
        return reference_module(config).logits_at(
            config["arch"], config["quantized"], seed, seqs, want, device)


def gaps_of(logits: list, tokens: list) -> np.ndarray:
    """Best logit less the logit of ``tokens[i][j]``, at every position."""
    out = []
    for lg, toks in zip(logits, tokens):
        t = torch.as_tensor(np.asarray(toks, np.int64), device=lg.device)
        best = lg.max(dim=-1).values
        out.append((best - lg.gather(1, t[:, None])[:, 0]).double().cpu())
    return torch.cat(out).numpy() if out else np.zeros(0)


def margins_of(margins: list) -> np.ndarray:
    return (torch.cat(margins).double().cpu().numpy() if margins
            else np.zeros(0))


def decided(margins: list, limits: dict) -> np.ndarray:
    """Positions whose routing the reference finds decided by more than
    rounding (every position without MoE layers)."""
    return margins_of(margins) >= float(
        limits["gap_max"].get("router_margin", 0.0))


def left_out(margins: list, gaps: np.ndarray, keep: np.ndarray) -> list:
    """(routing margin, gap) of every position the margin rule leaves
    out, by margin."""
    m = margins_of(margins)
    return sorted((float(a), float(b)) for a, b in zip(m[~keep],
                                                       gaps[~keep]))


def bad_outputs(run) -> int:
    """Finished requests that did not serve exactly ``max_new_tokens``
    tokens of the vocabulary."""
    vocab = run.arch["vocab_size"]
    return sum(1 for r in run.reqs.values() if r.done and (
        len(r.output) != r.max_new
        or any(not 0 <= t < vocab for t in r.output)))


def widest(gaps: np.ndarray) -> float:
    return float(gaps.max()) if gaps.size else NO_READING


def check(run, seed: int, device, log) -> dict:
    """{name: {"value", "limit"}} of every number compared; printed on
    standard error, each beside its limit, as the run's last lines."""
    limits = run.cell.limits
    reqs = finished(run)
    gap = NO_READING
    if reqs:
        logits, margins = reference_logits(run.cell.config, seed, reqs,
                                           device)
        gaps = gaps_of(logits, [r.output for r in reqs])
        del logits
        keep = decided(margins, limits)
        gap = widest(gaps[keep])
        log(f"[perfbench] reference: {len(reqs)} finished requests, "
            f"{gaps.size} served tokens ({int((~keep).sum())} with routing "
            f"within the margin, widest gap there {widest(gaps[~keep])!r}; "
            f"over all {widest(gaps)!r}), "
            f"{sum(len(r.prompt) for r in reqs)} prompt tokens")
        log(f"[perfbench] left out by the routing margin, (margin, gap): "
            f"{left_out(margins, gaps, keep)}")
    checks = {"gap_max": {"value": gap,
                          "limit": float(limits["gap_max"]["limit"])},
              "bad_outputs": {"value": bad_outputs(run), "limit": 0}}
    for name, c in checks.items():
        log(f"[perfbench] check {name}: {c['value']!r} (limit "
            f"{c['limit']!r})")
    return checks
