"""The port's prefix cache and unfused decode tick against ``repro``'s on
the CPU, on the pinned workload (reduced gemma-2b, vocab 32, head_dim 128,
seed 3; page size pinned in both engines):

* prompts that share a page-aligned prefix, one of them the bare prefix
  itself (the copy-on-write case): greedy tokens and the prefix counters
  (``prefix_hits``, ``prefill_tokens_skipped``, ``cow_copies``, the pool's
  lookups and evictions) equal the JAX engine's, under both schedulers,
  with the SPx-coded KV cache, on the unfused tick, with a bounded prefix
  index and with preemption;
* ``fused_decode=False`` serves through the single-token op
  (``paged_attention``, or ``paged_attention_quant``) in every decode tick
  and gives the fused tick's and the JAX engine's greedy tokens."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

from repro.configs import get_config, reduced
from repro.models import lm as jlm
from repro.runtime import Runtime as JRuntime
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServeConfig as JServeConfig
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import reduced as treduced
from repro_torch.interop import params_from_reference
from repro_torch.kernels import ops
from repro_torch.runtime import Runtime
from repro_torch.serving import Request, ServeConfig, ServeEngine

JRT = JRuntime(impl="ref", q_chunk=16)
CPU = Runtime(device="cpu")
KV_SCHEME = "spx_8_x3"
KNOBS = dict(batch_slots=2, max_seq=64, page_size=8)
NEW = 6
_PREFIX_KEYS = ("prefix_hits", "prefill_tokens_skipped", "cow_copies",
                "prefix_lookups", "prefix_evictions", "prefix_hit_rate",
                "prefix_cache", "prefix_cache_pages", "model_calls",
                "engine_steps", "preemptions", "resumes")


@pytest.fixture(scope="module", autouse=True)
def _fresh_jax_caches():
    """Drop this module's compiled JAX steps when it ends: a later module
    on the same worker (tests/test_fused_decode.py) counts the compiles
    of the reference's fused step."""
    yield
    jax.clear_caches()


def _cfg(pkg_get, pkg_reduced):
    return dataclasses.replace(pkg_reduced(pkg_get("gemma-2b"), vocab=32),
                               head_dim=128)


@pytest.fixture(scope="module")
def pinned():
    cfg = _cfg(get_config, reduced)
    params = jlm.lm_init(jax.random.PRNGKey(3), cfg)
    rng = np.random.default_rng(3)
    system = rng.integers(0, cfg.vocab_size, 16).astype(np.int32)
    # a 16-token (two-page) shared prefix with distinct tails; tail 0 is
    # the bare prefix, page-aligned identical to what the first request
    # registers: its last page is copied on write
    shared = [np.concatenate([system, rng.integers(0, cfg.vocab_size, n)
                              .astype(np.int32)]) for n in (5, 11, 0, 3, 0)]
    lens = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
            for n in (33, 1, 12, 20, 5)]        # 33 and 1: one-token chunks
    return dict(jcfg=cfg, jparams=params, cfg=_cfg(tget_config, treduced),
                params=params_from_reference(params), shared=shared,
                lens=lens)


def _jax_serve(pinned, prompts, *, kv_quant=False, priority_at=None, **kw):
    rt = JRT.replace(kv_quant=True, kv_scheme=KV_SCHEME) if kv_quant else JRT
    eng = JServeEngine(pinned["jparams"], pinned["jcfg"],
                       JServeConfig(**{**KNOBS, **kw}), rt=rt)
    return _feed(eng, prompts, JRequest, priority_at)


def _serve(pinned, prompts, *, kv_quant=False, priority_at=None, **kw):
    rt = CPU.replace(kv_quant=True, kv_scheme=KV_SCHEME) if kv_quant else CPU
    eng = ServeEngine(pinned["params"], pinned["cfg"],
                      ServeConfig(**{**KNOBS, **kw}), rt=rt)
    out, m = _feed(eng, prompts, Request, priority_at)
    eng.pool.validate()
    assert eng.pool.stats.pages_in_use == 0
    return out, m


def _feed(eng, prompts, request, priority_at):
    for i, p in enumerate(prompts):
        if i != priority_at:
            eng.submit(request(rid=i, prompt=p, max_new_tokens=NEW))
    if priority_at is not None:
        for _ in range(3):
            eng.step()
        eng.submit(request(rid=priority_at, prompt=prompts[priority_at],
                           max_new_tokens=NEW, priority=1))
    out = {r.rid: list(r.output) for r in eng.run()}
    return out, eng.metrics()


@pytest.mark.parametrize("kv_quant,kw", [
    (False, dict(scheduler="cb")),
    (False, dict(scheduler="fifo")),
    (True, dict(scheduler="cb")),
    (False, dict(fused_decode=False)),
    (True, dict(fused_decode=False)),
    (False, dict(prefix_cache_pages=1)),
], ids=["cb", "fifo", "kv_quant", "unfused", "kv_quant-unfused",
        "cache_pages=1"])
def test_prefix_greedy_and_metrics_match_reference(pinned, kv_quant, kw):
    prompts = pinned["shared"]
    want, m_want = _jax_serve(pinned, prompts, kv_quant=kv_quant,
                              prefix_cache=True, **kw)
    got, m = _serve(pinned, prompts, kv_quant=kv_quant, prefix_cache=True,
                    **kw)
    off, _ = _serve(pinned, prompts, kv_quant=kv_quant, prefix_cache=False,
                    **kw)
    assert got == want == off
    assert {k: m[k] for k in _PREFIX_KEYS} \
        == {k: m_want[k] for k in _PREFIX_KEYS}
    if "prefix_cache_pages" in kw:
        # one cached page: the bound evicts the chain's head before any
        # later request can match it
        assert m["prefix_evictions"] > 0 and m["prefix_cache_pages"] == 1
    else:
        assert m["prefix_hits"] >= 1 and m["cow_copies"] >= 1
        assert m["prefill_tokens_skipped"] > 0


def test_prefix_with_preemption_matches_reference(pinned):
    """A pool of 15 pages holds two residents at most; a late priority-1
    request preempts one whose pages may be shared: its private pages go
    to the host tier, the shared ones stay with their other owner."""
    kw = dict(prefix_cache=True, pool_pages=15)
    want, m_want = _jax_serve(pinned, pinned["shared"], priority_at=3, **kw)
    got, m = _serve(pinned, pinned["shared"], priority_at=3, **kw)
    assert got == want
    assert m["preemptions"] >= 1
    assert {k: m[k] for k in _PREFIX_KEYS} \
        == {k: m_want[k] for k in _PREFIX_KEYS}


@pytest.mark.parametrize("kv_quant", [False, True], ids=["f32", "kv_quant"])
def test_unfused_tick_matches_fused_and_reference(pinned, kv_quant):
    """``fused_decode=False``: every decode tick runs the one-token step
    through the single-token op; the ragged op never runs."""
    prompts = pinned["lens"]
    want, _ = _jax_serve(pinned, prompts, kv_quant=kv_quant,
                         fused_decode=False)
    ops.reset_op_calls()
    got, m = _serve(pinned, prompts, kv_quant=kv_quant, fused_decode=False)
    single = "paged_attention_quant" if kv_quant else "paged_attention"
    ragged = "paged_decode_ragged_quant" if kv_quant else "paged_decode_ragged"
    plain = ops.ref_calls()
    fused, m_fused = _serve(pinned, prompts, kv_quant=kv_quant)
    assert got == fused == want
    assert m["fused_decode"] is False and m_fused["fused_decode"] is True
    # one single-token call per layer per decode tick (plus the one-token
    # prefill chunks of the prompts of 33 and 1)
    assert plain[single] >= m["model_calls"] - 4
    assert ragged not in plain and ops.op_calls() == {}
