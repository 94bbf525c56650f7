"""The metric arithmetic on synthetic event logs: a rate is all the work
over all the time of the window, tails are tails of every sample, and a
stall inside the window moves both."""
import numpy as np
import pytest

from perfbench import harness, readers
from perfbench import yardstick as ys


def _run(tick_s=0.5, ticks=40, clients=8, stalls=(), t_open=10.0):
    """A closed loop of ``clients`` requests that each get one token per
    tick from t_open on; a tick listed in ``stalls`` takes 2 s more."""
    run = harness.Run(cell=None, arch={}, seconds=ticks * tick_s,
                      t_process=0.0)
    run.t_open = t_open
    t, times = t_open, []
    for k in range(ticks):
        t += tick_s + (2.0 if k in stalls else 0.0)
        times.append(t)
    run.t_end = times[-1]
    for c in range(clients):
        r = harness.ReqLog(c, due=t_open - 1.0, prompt=np.zeros(4, np.int32),
                           max_new=ticks)
        r.times = list(times)
        r.admit = t_open - 0.5
        run.reqs[c] = r
    run.steps = [(a - tick_s, a, clients, False) for a in times]
    run.batch_slots = 2 * clients
    return run


def test_nearest_rank():
    assert ys.nearest_rank(range(1, 101), 0.95) == 95
    assert ys.nearest_rank(range(1, 21), 0.95) == 19
    assert ys.nearest_rank([3.0], 0.95) == 3.0
    with pytest.raises(ValueError):
        ys.nearest_rank([], 0.5)


def test_rate_is_all_work_over_all_time():
    run = _run()
    assert readers.tokens_per_s(run) == pytest.approx(8 * 40 / 20.0)
    stalled = _run(stalls=(20,))
    # the same work over 2 s more: the rate falls by the whole stall
    assert readers.tokens_per_s(stalled) == pytest.approx(8 * 40 / 22.0)


def test_a_stall_moves_the_itl_tail_and_the_rate():
    base = _run()
    assert readers.itl_ms(base, 0.95) == pytest.approx(500.0)
    # a 2 s stall on 1 tick in 10: every gap counts, so the tail is the
    # stall (a median of per-tick or per-chunk pieces would hide it)
    stalled = _run(stalls=range(5, 40, 10))
    assert readers.itl_ms(stalled, 0.95) == pytest.approx(2500.0)
    assert readers.tokens_per_s(stalled) < readers.tokens_per_s(base)


def test_ttft_counts_from_due_and_unserved_requests_wait_to_the_end():
    run = _run()
    for r in run.reqs.values():
        r.due = run.t_open + 1.0
        r.times = [run.t_open + 1.5]
    late = run.reqs[7]
    late.times = []                      # never served in the window
    ttft = sorted(readers.ttft_ms(run, q) for q in (0.5, 0.95))
    assert ttft[0] == pytest.approx(500.0)
    assert ttft[1] == pytest.approx(1e3 * (run.t_end - late.due))


def test_occupancy_setup_and_peak():
    run = _run()
    assert readers.slot_occupancy(run) == pytest.approx(50.0)
    assert readers.setup_s(run) == pytest.approx(10.0)
    assert readers.peak_device_gib(run) is None       # no device reading
    run.memory_peak = 3 * 2 ** 30
    assert readers.peak_device_gib(run) == pytest.approx(3.0)


def test_device_readings_need_a_trace_with_device_ops():
    run = _run()
    for read in (readers.device_idle_share, readers.moe_device_share,
                 readers.spx_matmul_roofline, readers.paged_decode_roofline,
                 readers.mfu):
        assert read(run) is None


def test_flop_and_byte_rules():
    arch = dict(n_layers=2, pattern=["attn+dense"], d_model=8, head_dim=2,
                n_heads=4, n_kv_heads=2, d_ff=16, vocab_size=10)
    per_tok = 2 * 2 * (2 * 8 * 8 + 2 * 8 * 4 + 3 * 8 * 16)   # 2 layers
    attn = 4 * 2 * 4 * 2
    # one row of 3 tokens after 5 in the pages, one padded row
    want = per_tok * 3 + attn * (6 + 7 + 8) + 2 * 8 * 10 * 1
    assert ys.step_flops(arch, [5, 9], [3, 0], 1) == want
    nbytes, flops = ys.spx_matmul_cost(4, 8, 6, True, 16)
    assert flops == 2 * 4 * 8 * 6
    assert nbytes == 4 * 8 * 4 + 8 * 6 // 2 + 6 * 4 + 16 * 4 + 4 * 6 * 4
    nbytes, flops = ys.paged_decode_cost([5], [1], n_heads=4, n_kv_heads=2,
                                         head_dim=2)
    assert flops == 4 * 4 * 2 * 6
    assert ys.tc_bound_s(ys.PEAK_BYTES, 0) == 1.0


def test_traced_run_traces_after_its_window():
    """A traced run serves its window untraced, as a run without the
    trace does, and profiles the ticks after it: no host reading of the
    window comes from a profiled tick."""
    from perfbench import check
    from perfbench.tests.tiny import tiny_cell
    seen = []

    def keep(run, *args):
        seen.append(run)
        return check.check(run, *args)
    harness.run_cell(tiny_cell("qwen2-vl-2b.docs-open", trace=True), 4243,
                     1.0, True, device="cpu", log=lambda m: None,
                     checker=keep)
    run = seen[0]
    window = [s for s in run.steps if run.in_window(s[1])]
    traced = [s for s in run.steps if s[3]]
    assert window and traced
    assert not any(s[3] for s in window)
    assert min(s[0] for s in traced) >= run.t_end
    assert all(not c["traced"] for c in run.calls if run.in_window(c["t1"]))
    assert run.trace is not None and run.trace.t0 is not None
