"""The port's speculative decoding against ``repro``'s on the CPU, on the
pinned workload (reduced gemma-2b, vocab 32, head_dim 128, seed 3; f32
weights, page size pinned in both engines; repetition-heavy prompts):

* the prompt-lookup drafter (a copy of ``repro.serving.spec``) behaves as
  the reference's unit tests require;
* greedy tokens with speculation equal the port's without it and the JAX
  engine's, with and without the prefix cache and the SPx-coded KV cache,
  on the fused and the unfused tick, with the reference's model calls and
  acceptance counters;
* stub drafters drive the accept/rollback edges: rejection at position 0,
  full-window acceptance, rollback across a page boundary, the
  ``max_new_tokens`` cap;
* ``lm_paged_verify`` and ``lm_paged_fused_step`` at W > 1 give the
  reference's logits at every window position."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import get_config, reduced
from repro.models import lm as jlm
from repro.runtime import Runtime as JRuntime
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServeConfig as JServeConfig
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import reduced as treduced
from repro_torch.interop import params_from_reference
from repro_torch.models import lm as tlm
from repro_torch.runtime import Runtime
from repro_torch.serving import Request, ServeConfig, ServeEngine
from repro_torch.serving.spec import DEFAULT_SPEC_K, PromptLookupDrafter

JRT = JRuntime(impl="ref", q_chunk=16)
CPU = Runtime(device="cpu")
KV_SCHEME = "spx_8_x3"
KNOBS = dict(batch_slots=2, max_seq=64, quantize=None, page_size=8)


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


def _prompts(vocab, n=4, reps=3):
    """Tiled motifs, as the reference's spec tests: the n-gram drafter has
    something to find."""
    rng = np.random.default_rng(3)
    return [np.tile(rng.integers(0, vocab, 4).astype(np.int32), reps)
            for _ in range(n)]


@pytest.fixture(scope="module")
def pinned():
    cfg = _cfg(get_config, reduced)
    params = jlm.lm_init(jax.random.PRNGKey(3), cfg)
    return dict(jcfg=cfg, jparams=params, cfg=_cfg(tget_config, treduced),
                params=params_from_reference(params),
                prompts=_prompts(cfg.vocab_size))


def _jax_drive(pinned, prompts, *, kv_quant=False, new_tokens=8, **kw):
    rt = JRT.replace(kv_quant=True, kv_scheme=KV_SCHEME) if kv_quant else JRT
    eng = JServeEngine(pinned["jparams"], pinned["jcfg"],
                       JServeConfig(kv_layout="paged", **{**KNOBS, **kw}),
                       rt=rt)
    for i, p in enumerate(prompts):
        eng.submit(JRequest(rid=i, prompt=p, max_new_tokens=new_tokens))
    out = {r.rid: list(r.output) for r in eng.run()}
    return out, eng.metrics()


def _drive(pinned, prompts, *, kv_quant=False, new_tokens=8, drafter=None,
           **kw):
    rt = CPU.replace(kv_quant=True, kv_scheme=KV_SCHEME) if kv_quant else CPU
    eng = ServeEngine(pinned["params"], pinned["cfg"],
                      ServeConfig(**{**KNOBS, **kw}), rt=rt)
    if drafter is not None:
        eng.drafter = drafter
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=new_tokens))
    out = {r.rid: list(r.output) for r in eng.run()}
    eng.pool.validate()
    return out, eng.metrics()


@pytest.fixture(scope="module")
def reference_off(pinned):
    """The JAX engine's greedy tokens without speculation (2 requests of
    the pinned prompts, 8 and 9 new tokens)."""
    return {n: _jax_drive(pinned, pinned["prompts"][:2], new_tokens=n)[0]
            for n in (8, 9)}


# ---------------------------------------------------------------------------
# the drafter (host-side, no model): the reference's unit tests
# ---------------------------------------------------------------------------

def test_drafter_proposes_latest_continuation():
    d = PromptLookupDrafter(ngram_max=3, ngram_min=1)
    d.start(0, [1, 2, 3, 9, 1, 2, 3, 7, 1, 2, 3])
    assert d.propose(0, 4) == [7, 1, 2, 3]
    assert d.propose(0, 1) == [7]
    d.extend(0, 9)
    assert d.propose(0, 2) == [1, 2]
    assert d.propose(0, 0) == []
    assert DEFAULT_SPEC_K == 4


def test_drafter_novel_tail_proposes_nothing():
    d = PromptLookupDrafter()
    d.start(0, [5, 6, 7, 8])
    assert d.propose(0, 4) == []
    d.extend(0, 5)
    assert d.propose(0, 2) == [6, 7]


def test_drafter_lifecycle_errors():
    d = PromptLookupDrafter()
    d.start(0, [1, 1])
    with pytest.raises(KeyError):
        d.start(0, [2])
    d.drop(0)
    d.drop(0)
    with pytest.raises(KeyError):
        d.propose(0, 2)
    with pytest.raises(ValueError):
        PromptLookupDrafter(ngram_max=0)


# ---------------------------------------------------------------------------
# spec greedy == non-spec == JAX, every cache configuration
# ---------------------------------------------------------------------------

_SPEC_KEYS = ("model_calls", "engine_steps", "tokens_generated",
              "draft_acceptance_rate", "accepted_per_step", "spec_k",
              "spec_decode", "prefix_hits", "prefill_tokens_skipped",
              "cow_copies")


@pytest.mark.parametrize("kv_quant,prefix", [(False, False), (False, True),
                                             (True, False), (True, True)])
def test_spec_greedy_matches_nonspec_and_reference(pinned, kv_quant, prefix):
    prompts = pinned["prompts"]
    kw = dict(kv_quant=kv_quant, prefix_cache=prefix)
    want, m_want = _jax_drive(pinned, prompts, spec_decode=True, spec_k=4,
                              **kw)
    off, m_off = _drive(pinned, prompts, spec_decode=False, **kw)
    on, m_on = _drive(pinned, prompts, spec_decode=True, spec_k=4, **kw)
    assert on == off == want
    assert m_on["model_calls"] < m_off["model_calls"]
    assert m_on["draft_acceptance_rate"] > 0
    assert {k: m_on[k] for k in _SPEC_KEYS} \
        == {k: m_want[k] for k in _SPEC_KEYS}
    assert not m_off["spec_decode"] and m_off["spec_k"] == 0


@pytest.mark.parametrize("fused", [True, False])
def test_spec_fused_and_unfused_ticks_match_reference(pinned, fused):
    """The verify window through the ragged kernel (fused, W = 5) and
    through ``lm_paged_verify``'s page gather (unfused)."""
    prompts = pinned["prompts"]
    want, m_want = _jax_drive(pinned, prompts, spec_k=4, fused_decode=fused)
    got, m = _drive(pinned, prompts, spec_k=4, fused_decode=fused)
    assert got == want
    assert m["fused_decode"] is fused
    assert {k: m[k] for k in _SPEC_KEYS} == {k: m_want[k] for k in _SPEC_KEYS}


# ---------------------------------------------------------------------------
# accept/rollback edges via stub drafters
# ---------------------------------------------------------------------------

class _StubDrafter:
    """Engine-facing drafter driven by fn(rid, n_emitted, k) -> tokens."""

    def __init__(self, fn):
        self.fn = fn
        self.emitted: dict[int, int] = {}

    def start(self, rid, prompt):
        self.emitted[rid] = 0

    def extend(self, rid, tok):
        self.emitted[rid] += 1

    def drop(self, rid):
        self.emitted.pop(rid, None)

    def propose(self, rid, k):
        return list(self.fn(rid, self.emitted[rid], k))[:k]


@pytest.mark.parametrize("fused", [True, False])
def test_rejection_at_position_zero_yields_correction(pinned, reference_off,
                                                      fused):
    want = reference_off[8]
    vocab = pinned["cfg"].vocab_size
    _, m_off = _drive(pinned, pinned["prompts"][:2], fused_decode=fused)
    wrong = _StubDrafter(lambda rid, n, k: [(want[rid][n] + 1) % vocab] * k)
    on, m = _drive(pinned, pinned["prompts"][:2], spec_k=4, drafter=wrong,
                   fused_decode=fused)
    assert on == want
    assert m["draft_acceptance_rate"] == 0.0 and m["accepted_per_step"] == 0.0
    assert m["model_calls"] == m_off["model_calls"]


@pytest.mark.parametrize("fused", [True, False])
def test_oracle_drafter_full_window_acceptance(pinned, reference_off, fused):
    want = reference_off[9]
    _, m_off = _drive(pinned, pinned["prompts"][:2], new_tokens=9,
                      fused_decode=fused)
    oracle = _StubDrafter(lambda rid, n, k: want[rid][n:n + k])
    on, m = _drive(pinned, pinned["prompts"][:2], spec_k=4, drafter=oracle,
                   new_tokens=9, fused_decode=fused)
    assert on == want
    assert m["draft_acceptance_rate"] == 1.0
    assert m["model_calls"] < m_off["model_calls"]
    assert m["engine_steps"] < m_off["engine_steps"]


@pytest.mark.parametrize("fused", [True, False])
def test_rollback_across_page_boundary(pinned, fused):
    """Prompt of 6 at page size 4: the first window writes positions
    6..11 over pages 1 and 2; one draft is accepted, so the cursor rolls
    back to 8, the page-2 boundary, and the next windows overwrite the
    stale positions."""
    vocab = pinned["cfg"].vocab_size
    prompts = [np.tile(np.arange(3, dtype=np.int32) % vocab, 2)]
    want, _ = _jax_drive(pinned, prompts, new_tokens=12, page_size=4)

    def corrupt_at_1(rid, n, k):
        toks = list(want[rid][n:n + k])
        if len(toks) > 1:
            toks[1] = (toks[1] + 1) % vocab
        return toks

    on, m = _drive(pinned, prompts, spec_k=5, drafter=_StubDrafter(
        corrupt_at_1), new_tokens=12, page_size=4, fused_decode=fused)
    assert on == want
    assert 0 < m["draft_acceptance_rate"] < 1.0


def test_spec_never_emits_past_max_new_tokens(pinned):
    prompts = pinned["prompts"][:2]
    for new_tokens in (1, 2, 3):
        want, _ = _jax_drive(pinned, prompts, new_tokens=new_tokens)
        on, _ = _drive(pinned, prompts, spec_k=8, new_tokens=new_tokens)
        assert on == want
        assert all(len(out) == new_tokens for out in on.values())


def test_all_novel_tick_degrades_to_plain_decode(pinned, reference_off):
    _, m_off = _drive(pinned, pinned["prompts"][:2], fused_decode=False)
    on, m = _drive(pinned, pinned["prompts"][:2], spec_k=4,
                   fused_decode=False, drafter=_StubDrafter(
                       lambda rid, n, k: []))
    assert on == reference_off[8]
    assert m["model_calls"] == m_off["model_calls"]
    assert m["draft_acceptance_rate"] == 0.0


def test_spec_sampled_is_deterministic(pinned):
    """temperature > 0 under speculation draws from the request's own
    generator: a rerun reproduces the outputs token for token."""
    def run():
        eng = ServeEngine(pinned["params"], pinned["cfg"],
                          ServeConfig(spec_k=4, seed=5, **KNOBS), rt=CPU)
        for i, p in enumerate(pinned["prompts"][:2]):
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=8,
                               temperature=0.8))
        return {r.rid: list(r.output) for r in eng.run()}

    a = run()
    assert a == run()
    assert all(len(out) == 8 for out in a.values())


# ---------------------------------------------------------------------------
# the verify window's logits
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fused", [False, True])
def test_verify_window_logits_match_reference(pinned, fused):
    """A prefill chunk, then a W = 5 window per row (one row with one
    valid position, one idle row): logits at every valid window position
    within 1e-5 of the largest, and the pages as the reference wrote
    them."""
    jcfg, cfg = pinned["jcfg"], pinned["cfg"]
    b, ps, n_pages, w = 3, 8, 12, 5
    rng = np.random.default_rng(9)
    prompt = rng.integers(0, cfg.vocab_size, (b, 16)).astype(np.int32)
    window = rng.integers(0, cfg.vocab_size, (b, w)).astype(np.int32)
    bt = np.arange(n_pages, dtype=np.int32).reshape(b, 4)
    nv0 = np.array([16, 11, 7], np.int32)
    nv = np.array([5, 1, 0], np.int32)
    state_idx = np.zeros((b, 2), np.int32)

    jc = jlm.paged_init_caches(jcfg, n_pages, ps, dtype=jnp.float32)
    _, jc = jlm.lm_paged_step(pinned["jparams"], jnp.asarray(prompt),
                              jnp.zeros(b, jnp.int32), jnp.asarray(bt),
                              jnp.asarray(nv0), jnp.asarray(state_idx), jc,
                              jcfg, JRT)
    jfn = jlm.lm_paged_fused_step if fused else jlm.lm_paged_verify
    want, jc = jfn(pinned["jparams"], jnp.asarray(window), jnp.asarray(nv0),
                   jnp.asarray(bt), jnp.asarray(nv), jnp.asarray(state_idx),
                   jc, jcfg, JRT)
    want = np.asarray(want)

    t = lambda a: torch.as_tensor(a)
    tc = tlm.paged_init_caches(cfg, n_pages, ps, dtype=torch.float32,
                               device="cpu")
    _, tc = tlm.lm_paged_step(pinned["params"], t(prompt), t(nv0) * 0,
                              t(bt), t(nv0), t(state_idx), tc, cfg, CPU)
    tfn = tlm.lm_paged_fused_step if fused else tlm.lm_paged_verify
    got, tc = tfn(pinned["params"], t(window), t(nv0), t(bt), t(nv),
                  t(state_idx), tc, cfg, CPU)
    got = got.numpy()
    assert got.shape == want.shape == (b, w, cfg.vocab_size)
    for i in range(b):
        n = int(nv[i])
        err = np.abs(got[i, :n] - want[i, :n]).max(initial=0.0)
        assert err <= 1e-5 * np.abs(want).max(), (i, err)
    jk = np.asarray(jc[0]["kp"])
    tk = tc[0]["kp"].numpy()
    np.testing.assert_allclose(tk, jk, rtol=1e-5, atol=1e-5)
