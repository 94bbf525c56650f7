"""Measured autotuning of the kernels' launches (``REPRO_AUTOTUNE=1``).

Under ``planner.autotune_enabled()`` the ops ask ``spx_plan`` or
``paged_plan`` for a launch on CUDA tensors. The first call at a shape key
times the analytical launch and its neighbours on the call's own inputs
(``planner.measured_best``) and keeps the fastest; later calls at the key
read the winner (``planner.measured_plan``). Nothing is measured while the
current stream captures a graph: the analytical launch runs then. A
``REPRO_BLOCKS_MATMUL`` pin wins over the tuner.

``event_runner`` times a launch with CUDA events on the current stream:
one warm call, then TIMED_GROUPS groups of back-to-back calls, each group
queued behind a spin of the card (so that the host's cost of a launch
stays out of the events) and between one pair of events; a group holds
as many calls as take about GROUP_US of the card (at most
MAX_GROUP_CALLS), so that a launch of a few microseconds is not lost in
the events' own resolution. The runner returns the median over the groups
of the seconds a call.
"""
from __future__ import annotations

import statistics
from typing import Callable

import torch

from repro_torch.runtime import planner

from . import cuda_lib, paged_attention, spx_matmul

__all__ = ["event_runner", "measured_launch", "spx_plan", "paged_plan",
           "TIMED_GROUPS", "GROUP_US", "MAX_GROUP_CALLS"]

#: timed groups of calls a candidate, after one warm call
TIMED_GROUPS = 5
#: the device microseconds a group aims at, and its most calls
GROUP_US = 100.0
MAX_GROUP_CALLS = 10
#: cycles of the spin each group queues behind: about a millisecond,
#: several times what the host takes to queue a group
_SPIN_CYCLES = 2_000_000


def _timed(launch, plan, calls: int) -> float:
    """Device milliseconds a call over one group of ``calls`` calls of
    ``launch(plan)`` queued behind a spin."""
    stream = torch.cuda.current_stream()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(_SPIN_CYCLES)
    start.record(stream)
    for _ in range(calls):
        launch(plan)
    end.record(stream)
    end.synchronize()
    return start.elapsed_time(end) / calls


def event_runner(launch: Callable[[object], object]) -> Callable:
    """A ``measured_best`` runner: seconds a call of ``launch(plan)`` on
    the card, the median over TIMED_GROUPS groups timed by CUDA events."""
    def run(plan) -> float:
        launch(plan)
        one_us = max(_timed(launch, plan, 1) * 1e3, 1e-3)
        calls = max(1, min(MAX_GROUP_CALLS, round(GROUP_US / one_us)))
        return statistics.median(_timed(launch, plan, calls)
                                 for _ in range(TIMED_GROUPS)) / 1e3
    return run


def measured_launch(key, candidates: Callable[[], tuple],
                    launch: Callable[[object], object]):
    """The winner at ``key``, measured now over ``candidates()`` when the
    key is new; None (the analytical launch) while the stream captures."""
    plan = planner.measured_plan(key)
    if plan is not None or torch.cuda.is_current_stream_capturing():
        return plan
    return planner.measured_best(key, candidates(), event_runner(launch))


def spx_plan(launch, x2: torch.Tensor, codes: torch.Tensor,
             scale: torch.Tensor, lut: torch.Tensor, *, packed: bool):
    """The tuned ``spx_matmul`` launch of x2 (M, K) against ``codes``, or
    None where the wrapper chooses (a pin, a capture). ``launch`` is the
    wrapper. The key: ``("spx_matmul", m, k, n, bits, packed, lut_size,
    sms)``, ``bits`` the code width of the codebook ``lut`` (whose
    ``spx.codebook`` size is 2 ** bits)."""
    m, k = x2.shape
    n, lut_size = scale.numel(), lut.numel()
    packed = bool(packed)
    if planner.pinned_spx_launch(m, k, n, packed, lut_size) is not None:
        return None
    sms = cuda_lib.sm_count(x2.device.index or 0)
    key = ("spx_matmul", m, k, n, max(1, (lut_size - 1).bit_length()),
           packed, lut_size, sms)
    return measured_launch(
        key,
        lambda: planner.spx_launch_candidates(
            m, k, n, packed, lut_size, sms,
            spx_matmul.library_splits(m, k, n, sms)),
        lambda plan: launch(x2, codes, scale, lut, packed=packed, plan=plan))


def paged_plan(launch, q4: torch.Tensor, pool: torch.Tensor,
               block_table: torch.Tensor, *, rep: int, w: int,
               kv_scheme: str | None):
    """The tuned split count or cluster of a paged-decode launch over
    ``pool`` (the K pool, or its codes), or None under a capture.
    ``launch(plan)`` runs the wrapper on the call's inputs. The key is
    ``planner.fused_decode_key`` (the single-token mode at ``w = 1``)."""
    b, hkv, rows, dh = q4.shape
    page_size, max_pages = pool.shape[2], block_table.shape[1]
    sms = cuda_lib.sm_count(q4.device.index or 0)
    key = planner.fused_decode_key(b, hkv, rep, w, dh, page_size, max_pages,
                                   kv_scheme, pool.dtype)
    return measured_launch(
        key,
        lambda: paged_attention.launch_candidates(
            pool.dtype, b, hkv, rows, dh, max_pages, page_size, sms),
        launch)
