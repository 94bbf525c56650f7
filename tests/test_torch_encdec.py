"""The port's encoder-decoder family (whisper-small, reduced: 2 encoder
and 2 decoder layers, 16 encoder frames) against ``repro.models.encdec``
and ``repro.serving.ServeEngine``: the encoder, the per-layer cross K/V,
the dense prefill and decode steps, the three paged steps over the state
cache's cross region, and the greedy tokens of the serving engine (paged
cb and dense fifo; f32 and JAX-quantized sp2_4 weights; speculative
decoding; one preemption; f16 pages and cross region), and the shared
encoder pass: identical frames share one cross entry.

The same numpy-seeded frames and tokens and the same JAX-made weights
(carried over by ``interop``) go through both packages; the JAX side runs
its plain reference ops (``impl="ref"``). Forward values are held within
1e-5 of the reference's largest magnitude (f32 sums in another order);
greedy tokens exactly. The page size is pinned in both engines."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config, reduced
from repro.models import encdec as jed
from repro.models import lm as jlm
from repro.nn.layers import quantize_params as jquantize
from repro.runtime import Runtime as JRuntime
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServeConfig as JServeConfig
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import reduced as treduced
from repro_torch.interop import params_from_reference
from repro_torch.models import encdec as ted
from repro_torch.models import lm as tlm
from repro_torch.runtime import Runtime
from repro_torch.serving import Request, ServeConfig, ServeEngine

CPU = Runtime(device="cpu", q_chunk=16)
JRT = JRuntime(impl="ref", q_chunk=16)
#: forward values: |port - ref| <= FWD_RTOL * max|ref|
FWD_RTOL = 1e-5
KNOBS = dict(batch_slots=4, max_seq=64, page_size=8, quantize=None)
NEW = 8
LENS = (7, 33, 12)                  # 33 ends in a one-token chunk


@pytest.fixture(scope="module", autouse=True)
def _fresh_jax_caches():
    yield
    jax.clear_caches()


def _cfgs():
    kw = dict(n_enc_layers=2)
    j = dataclasses.replace(reduced(get_config("whisper-small"),
                                    n_layers=2), **kw)
    t = dataclasses.replace(treduced(tget_config("whisper-small"),
                                     n_layers=2), **kw)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    return j, t


@pytest.fixture(scope="module")
def model():
    """(JAX cfg, port cfg, JAX params, port params, two distinct frame
    inputs (2, S_enc, D))."""
    jcfg, tcfg = _cfgs()
    jp = jed.encdec_init(jax.random.PRNGKey(2), jcfg)
    frames = np.random.default_rng(3).standard_normal(
        (2, jcfg.enc_seq_len, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, jp, params_from_reference(jp), frames


def _close(got, want, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    err = np.abs(got - want).max()
    assert err <= FWD_RTOL * np.abs(want).max(), (what, err)


def test_encode_matches_reference(model):
    jcfg, tcfg, jp, tp, frames = model
    want = jed.encdec_encode(jp, jnp.asarray(frames), jcfg, JRT)
    got = ted.encdec_encode(tp, torch.as_tensor(frames), tcfg, CPU)
    _close(got, want, "encoder output")


@pytest.mark.parametrize("quantized", [False, True])
def test_cross_kv_matches_reference(model, quantized):
    """Per-slot, per-period cross K/V (P, B, Hkv, S_enc, dh), the SPx
    weights through spx_matmul's plain version."""
    jcfg, tcfg, jp, _, frames = model
    if quantized:
        jp = jquantize(jp, "sp2_4")
    want = jed.encdec_cross_kv(jp, jnp.asarray(frames), jcfg, JRT)
    got = ted.encdec_cross_kv(params_from_reference(jp),
                              torch.as_tensor(frames), tcfg, CPU)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for k in ("xk", "xv"):
            assert tuple(g[k].shape) == w[k].shape
            _close(g[k], w[k], k)


def test_dense_prefill_and_decode_match_reference(model):
    """encdec_prefill fills the self- and cross-attention caches; three
    encdec_decode_step calls continue from them."""
    jcfg, tcfg, jp, tp, frames = model
    rng = np.random.default_rng(4)
    tokens = rng.integers(1, jcfg.vocab_size, (2, 9)).astype(np.int32)
    jc = jed.encdec_init_caches(jcfg, 2, 32, dtype=jnp.float32)
    tc = ted.encdec_init_caches(tcfg, 2, 32, dtype=torch.float32,
                                device="cpu")
    jl, jc = jed.encdec_prefill(jp, jnp.asarray(frames),
                                jnp.asarray(tokens), jc, jcfg, JRT)
    tl, tc = ted.encdec_prefill(tp, torch.as_tensor(frames),
                                torch.as_tensor(tokens), tc, tcfg, CPU)
    _close(tl, jl, "prefill logits")
    _close(tc[0]["xk"], jc[0]["xk"], "cached xk")
    pos = tokens.shape[1]
    for _ in range(3):
        nxt = np.array(jnp.argmax(jl, axis=-1), np.int32)
        jl, jc = jed.encdec_decode_step(jp, jnp.asarray(nxt),
                                        jnp.int32(pos), jc, jcfg, JRT)
        tl, tc = ted.encdec_decode_step(tp, torch.as_tensor(nxt), pos, tc,
                                        tcfg, CPU)
        _close(tl, jl, f"decode logits at {pos}")
        pos += 1


def test_paged_steps_match_reference(model):
    """The three paged steps over a cross region of two entries: a prefill
    chunk (rows of 8 and 5 tokens, each row on its own entry), the fused
    tick and the verify window over the pages it wrote."""
    jcfg, tcfg, jp, tp, frames = model
    ps, n_pages = 8, 8
    jc = jed.encdec_paged_init_caches(jcfg, n_pages, ps, dtype=jnp.float32,
                                      n_cross=2)
    tc = ted.encdec_paged_init_caches(tcfg, n_pages, ps,
                                      dtype=torch.float32, n_cross=2,
                                      device="cpu")
    for idx in (0, 1):
        ent = jed.encdec_cross_kv(jp, jnp.asarray(frames[idx:idx + 1]),
                                  jcfg, JRT)
        jc = jlm.paged_fill_cross(jc, jnp.int32(idx), ent)
        tent = ted.encdec_cross_kv(tp, torch.as_tensor(frames[idx:idx + 1]),
                                   tcfg, CPU)
        tlm.paged_fill_cross(tc, idx, tent)
    _close(tc[0]["xv"], jc[0]["xv"], "cross region")
    rng = np.random.default_rng(5)
    bt = np.array([[0, 1, 2, 3], [4, 5, 6, 7]], np.int32)
    # column 0 is the slab sentinel (no slab region), column 1 the entry:
    # row 0 reads entry 1, row 1 entry 0
    state_idx = np.array([[0, 1], [0, 0]], np.int32)
    tokens = rng.integers(1, jcfg.vocab_size, (2, 8)).astype(np.int32)
    ctx = np.zeros(2, np.int32)
    n_valid = np.array([8, 5], np.int32)

    def both(jfn, tfn, tokens, ctx, n_valid):
        nonlocal jc
        args = (tokens, ctx, bt, n_valid, state_idx)
        jl, jc = jfn(jp, *map(jnp.asarray, args), jc, jcfg, JRT)
        tl, _ = tfn(tp, *map(torch.as_tensor, args), tc, tcfg, CPU)
        return tl, np.asarray(jl)

    tl, jl = both(jed.encdec_paged_step, ted.encdec_paged_step, tokens,
                  ctx, n_valid)
    _close(tl, jl, "prefill chunk logits")
    ctx = n_valid.copy()
    nxt = rng.integers(1, jcfg.vocab_size, (2, 1)).astype(np.int32)
    one = np.ones(2, np.int32)
    tl, jl = both(jed.encdec_paged_fused_step, ted.encdec_paged_fused_step,
                  nxt, ctx, one)
    _close(tl, jl, "fused tick logits")
    ctx = ctx + 1
    window = rng.integers(1, jcfg.vocab_size, (2, 3)).astype(np.int32)
    n_win = np.array([3, 2], np.int32)
    tl, jl = both(jed.encdec_paged_verify, ted.encdec_paged_verify, window,
                  ctx, n_win)
    for b in range(2):
        _close(tl[b, :n_win[b]], jl[b, :n_win[b]], f"verify row {b}")


# -- the serving engine ------------------------------------------------------

def _prompts(vocab, lens=LENS, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, n).astype(np.int32) for n in lens]


def _frames_for(frames, n):
    """Request i's frames: rids 0 and 1 share input 0, the rest input 1."""
    return [frames[0] if i < 2 else frames[1] for i in range(n)]


def _jax_serve(params, cfg, prompts, frames, **knobs):
    eng = JServeEngine(params, cfg, JServeConfig(**{**KNOBS, **knobs}),
                       rt=JRT)
    for i, (p, f) in enumerate(zip(prompts, frames)):
        eng.submit(JRequest(rid=i, prompt=p, max_new_tokens=NEW, frames=f))
    eng.run()
    return {r.rid: list(r.output) for r in eng.finished}


def _serve(params, cfg, prompts, frames, *, preempt_after=None, **knobs):
    eng = ServeEngine(params, cfg, ServeConfig(**{**KNOBS, **knobs}),
                      rt=CPU)
    for i, (p, f) in enumerate(zip(prompts, frames)):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=NEW, frames=f))
    if preempt_after is not None:
        for _ in range(preempt_after):
            eng.step()
        eng.preempt(next(r.rid for r in eng.slot_req if r is not None))
    eng.run()
    return {r.rid: list(r.output) for r in eng.finished}, eng.metrics()


@pytest.fixture(scope="module")
def runs():
    """The reference's runs, shared by this module's tests."""
    return {}


def _case(runs, model, quantized, **knobs):
    """(port params, port cfg, prompts, frames, the reference engine's
    tokens under ``knobs``), each computed once per module."""
    jcfg, tcfg, jp, _, frames = model
    key = (quantized, tuple(sorted(knobs.items())))
    if key not in runs:
        if quantized:
            jp = jquantize(jp, "sp2_4")
        prompts = _prompts(jcfg.vocab_size)
        fr = _frames_for(frames, len(prompts))
        want = _jax_serve(jp, jcfg, prompts, fr, kv_layout="paged",
                          scheduler="cb", **knobs)
        runs[key] = (params_from_reference(jp), tcfg, prompts, fr, want)
    return runs[key]


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "sp2_4"])
def test_paged_cb_matches_reference(runs, model, quantized):
    params, cfg, prompts, frames, want = _case(runs, model, quantized)
    got, m = _serve(params, cfg, prompts, frames, kv_layout="paged",
                    scheduler="cb")
    assert got == want
    assert m["requests_finished"] == len(prompts)
    assert m["n_cross"] == KNOBS["batch_slots"]


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "sp2_4"])
def test_dense_fifo_matches_reference(runs, model, quantized):
    params, cfg, prompts, frames, want = _case(runs, model, quantized)
    got, m = _serve(params, cfg, prompts, frames, kv_layout="dense",
                    scheduler="fifo")
    assert got == want
    assert m["kv_layout"] == "dense"


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_spec_decode_matches_reference(runs, model, fused):
    """Speculative decoding (prompt lookup, K = 3) on the fused and the
    unfused tick: the same tokens as the reference's speculative engine."""
    knobs = dict(spec_decode=True, spec_k=3, fused_decode=fused)
    params, cfg, prompts, frames, want = _case(runs, model, False, **knobs)
    got, m = _serve(params, cfg, prompts, frames, **knobs)
    assert got == want
    assert m["spec_decode"] and m["spec_k"] == 3


@pytest.mark.parametrize("knobs", [dict(), dict(spec_decode=True,
                                                 spec_k=3)],
                         ids=["fused", "spec"])
def test_f16_pages_match_reference(runs, model, knobs):
    """f16 pages and an f16 cross region (the fused tick, and speculative
    decoding) give the reference engine's tokens on the same dtype."""
    knobs = dict(knobs, kv_cache_dtype="float16")
    params, cfg, prompts, frames, want = _case(runs, model, False, **knobs)
    got, m = _serve(params, cfg, prompts, frames, **knobs)
    assert got == want
    assert m["kv_cache_dtype"] == "float16"


def test_preempt_resume_keeps_tokens(runs, model):
    """Two slots, three requests, one resident preempted after five ticks:
    its written pages go to the host and back, its cross entry stays
    referenced while it is parked, and every token equals the
    reference's."""
    params, cfg, prompts, frames, want = _case(runs, model, False)
    got, m = _serve(params, cfg, prompts, frames, preempt_after=5,
                    batch_slots=2)
    assert got == want
    assert m["preemptions"] >= 1 and m["resumes"] >= 1
    assert m["offload_bytes"] > 0 and m["onload_bytes"] > 0
    assert m["cross_in_use"] == 0


def test_encoder_output_shared_across_requests(model):
    """As tests/test_state_cache.py: two requests with identical frames
    share one cross entry, the encoder runs once for them, and the peak
    cross occupancy counts distinct inputs, not requests."""
    _, cfg, _, params, frames = model
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, cfg.vocab_size, 6).astype(np.int32)
               for _ in range(3)]
    out, m = _serve(params, cfg, prompts, _frames_for(frames, 3),
                    kv_layout="paged")
    assert len(out) == 3
    assert m["cross_lookups"] == 3
    assert m["cross_hits"] == 1                 # rid 1 reused rid 0's pass
    assert m["peak_cross"] == 2                 # two distinct inputs
    per_entry = 2 * cfg.n_layers * cfg.n_kv_heads * cfg.enc_seq_len \
        * cfg.dh * 4
    assert m["cross_bytes_per_entry"] == per_entry
    # two encoder passes, the rest prefill chunks and decode ticks
    assert m["peak_state_bytes"] >= 2 * per_entry


def test_frames_are_required_and_refused(model):
    jcfg, cfg, _, params, frames = model
    eng = ServeEngine(params, cfg, ServeConfig(**KNOBS), rt=CPU)
    with pytest.raises(ValueError, match="frames"):
        eng.submit(Request(rid=0, prompt=np.asarray([1, 2], np.int32),
                           max_new_tokens=2))
    with pytest.raises(ValueError, match="enc_dec"):
        ServeConfig(kv_layout="paged", prefix_cache=True).resolve(cfg)
    lm_cfg = treduced(tget_config("gemma-2b"))
    lm_eng = ServeEngine(tlm.lm_init(torch.Generator(), lm_cfg,
                                     device="cpu"), lm_cfg,
                         ServeConfig(**KNOBS), rt=CPU)
    with pytest.raises(ValueError, match="no encoder"):
        lm_eng.submit(Request(rid=0, prompt=np.asarray([1, 2], np.int32),
                              max_new_tokens=2, frames=frames[0]))


def test_frames_key_hashes_as_the_reference(model):
    """The cross-region key: blake2b-16 of the f32 bytes and the shape,
    byte for byte the reference's, so one input is one key in both."""
    jcfg, cfg, jp, params, frames = model
    eng = ServeEngine(params, cfg, ServeConfig(**KNOBS), rt=CPU)
    jeng = JServeEngine(jp, jcfg, JServeConfig(**KNOBS), rt=JRT)
    for i, f in enumerate((frames[0], frames[1].astype(np.float64))):
        req, jreq = (Request(rid=i, prompt=np.asarray([1], np.int32),
                             frames=f),
                     JRequest(rid=i, prompt=np.asarray([1], np.int32),
                              frames=f))
        assert eng._frames_key(req) == jeng._frames_key(jreq)
