"""A run of each cell with the timed path broken underneath, on the CPU
at tiny sizes (past the harness's look for a card): ``correct`` has to
come out false for every fault a serving cell can have."""
import pytest
import torch

from perfbench import harness

from perfbench.tests.tiny import tiny_cell

WORKLOADS = ("olmoe-1b-7b.chat-closed", "qwen2-vl-2b.docs-open")


def _alter_tokens(eng):
    """A token altered where it is produced: every greedy pick moved to
    the next id."""
    pick = eng._pick_token
    vocab = eng.cfg.vocab_size

    def altered(row, req):
        return (pick(row, req) + 1) % vocab
    eng._pick_token = altered


def _state_unchanged(monkeypatch):
    """Each step returns its state unchanged: no K/V reaches the pages."""
    from repro_torch.nn import attention

    def keep(k_pages, v_pages, *args, **kw):
        return k_pages, v_pages
    monkeypatch.setattr(attention, "paged_kv_write", keep)


def _half_the_batch(monkeypatch):
    """Half of the batch left out: the odd rows of every decode call run
    with nothing valid."""
    from repro_torch.models import lm
    step = lm.lm_paged_fused_step

    def half(params, tokens, ctx, bt, n_valid, *rest):
        n_valid = n_valid.clone()
        n_valid[1::2] = 0
        return step(params, tokens, ctx, bt, n_valid, *rest)
    monkeypatch.setattr(lm, "lm_paged_fused_step", half)


def _run(workload, fault=None):
    return harness.run_cell(tiny_cell(workload), 4242, 1.0, False,
                            device="cpu", log=lambda m: None, fault=fault)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_sound_run_is_correct(workload):
    res = _run(workload)
    assert res["correct"] and res["checks"]["gap_max"]["value"] == 0.0


@pytest.mark.parametrize("workload", WORKLOADS)
def test_altered_tokens_are_not_correct(workload):
    res = _run(workload, fault=_alter_tokens)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_state_left_unchanged_is_not_correct(workload, monkeypatch):
    _state_unchanged(monkeypatch)
    res = _run(workload)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_half_the_batch_left_out_is_not_correct(workload, monkeypatch):
    _half_the_batch(monkeypatch)
    res = _run(workload)
    assert not res["correct"], res["checks"]
