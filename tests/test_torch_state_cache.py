"""The port's serving engine on the recurrent, hybrid, MoE, M-RoPE and
encoder-decoder families against ``repro.serving.ServeEngine`` at reduced
size: xlstm-350m (4 layers: mLSTM and sLSTM slabs, pageless), jamba (one
period of 8: attention pages, mamba slabs, MoE), olmoe-1b-7b and kimi-k2
(MoE, kimi's shared expert), qwen2-vl-2b (M-RoPE) and whisper-small
(pages and the cross region; two requests share one encoder input), 2
layers each. The greedy tokens
of the port's paged engine (cb) and of its dense layout (fifo) equal the
reference's paged engine's, with unquantized weights and with sp2_4
weights that JAX quantized and the port carried over; a preempted
sequence's slab goes to the host and back without changing a token; the
paged state cache bills less than the dense layout; the prefix cache and
speculative decoding refuse recurrent patterns with the reference's
reasons; whisper-small's knobs this port still lacks raise, naming
ROADMAP.md.

Tokens are compared exactly. The page size is pinned in both engines
(the port plans its own, ROADMAP.md Queue 3)."""
import dataclasses

import jax
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
from repro_torch.runtime import Runtime
from repro_torch.serving import Request, ServeConfig, ServeEngine

CPU = Runtime(device="cpu")
JRT = JRuntime(impl="ref", q_chunk=16)
KNOBS = dict(batch_slots=4, max_seq=64, page_size=8, quantize=None)
NEW = 8
LENS = (7, 33, 12)                  # 33 ends in a one-token chunk
#: arch -> layers at reduced size
ARCHS = {"xlstm-350m": 4, "jamba-1.5-large-398b": 8, "olmoe-1b-7b": 2,
         "kimi-k2-1t-a32b": 2, "qwen2-vl-2b": 2, "whisper-small": 2}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU tests run small shapes, where torch's intra-op
    threads mostly spin: one thread for this file's tests (the suite's
    workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _fresh_jax_caches():
    """Drop this module's compiled JAX steps when it ends (a later module
    on the same worker counts the reference's compiles)."""
    yield
    jax.clear_caches()


def _cfgs(arch, **kw):
    j = dataclasses.replace(reduced(get_config(arch), n_layers=ARCHS[arch]),
                            **kw)
    t = dataclasses.replace(treduced(tget_config(arch),
                                     n_layers=ARCHS[arch]), **kw)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    return j, t


def _prompts(vocab, lens=LENS, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, n).astype(np.int32) for n in lens]


def _frames(cfg, n):
    """Encoder inputs of an enc-dec config (None elsewhere): rids 0 and 1
    share one input, the rest another."""
    if not cfg.enc_dec:
        return [None] * n
    fr = np.random.default_rng(3).standard_normal(
        (2, cfg.enc_seq_len, cfg.d_model)).astype(np.float32)
    return [fr[min(i // 2, 1)] for i in range(n)]


def _jax_serve(params, cfg, prompts, **knobs):
    eng = JServeEngine(params, cfg, JServeConfig(**{**KNOBS, **knobs}),
                       rt=JRT)
    for i, (p, f) in enumerate(zip(prompts, _frames(cfg, len(prompts)))):
        eng.submit(JRequest(rid=i, prompt=p, max_new_tokens=NEW, frames=f))
    eng.run()
    return {r.rid: list(r.output) for r in eng.finished}


def _serve(params, cfg, prompts, *, preempt_after=None, **knobs):
    eng = ServeEngine(params, cfg, ServeConfig(**{**KNOBS, **knobs}),
                      rt=CPU)
    for i, (p, f) in enumerate(zip(prompts, _frames(cfg, len(prompts)))):
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


def _case(runs, arch, quantized):
    """(port params, port cfg, prompts, the reference paged engine's
    tokens), computed once per module."""
    key = (arch, quantized)
    if key not in runs:
        jcfg, tcfg = _cfgs(arch)
        init = jed.encdec_init if jcfg.enc_dec else jlm.lm_init
        jp = init(jax.random.PRNGKey(1), jcfg)
        if quantized:
            jp = jquantize(jp, "sp2_4")
        prompts = _prompts(jcfg.vocab_size)
        want = _jax_serve(jp, jcfg, prompts, kv_layout="paged",
                          scheduler="cb")
        runs[key] = (params_from_reference(jp), tcfg, prompts, want)
    return runs[key]


CASES = [pytest.param(a, q, id=f"{a}-{'sp2_4' if q else 'f32'}")
         for a in ARCHS for q in (False, True)]


@pytest.mark.parametrize("arch,quantized", CASES)
def test_paged_cb_matches_reference(runs, arch, quantized):
    params, cfg, prompts, want = _case(runs, arch, quantized)
    got, m = _serve(params, cfg, prompts, kv_layout="paged", scheduler="cb")
    assert got == want
    assert m["requests_finished"] == len(prompts)


@pytest.mark.parametrize("arch,quantized", CASES)
def test_dense_fifo_matches_reference(runs, arch, quantized):
    params, cfg, prompts, want = _case(runs, arch, quantized)
    got, m = _serve(params, cfg, prompts, kv_layout="dense",
                    scheduler="fifo")
    assert got == want
    assert m["kv_layout"] == "dense"


@pytest.mark.parametrize("arch", ["xlstm-350m", "jamba-1.5-large-398b",
                                  "whisper-small"])
def test_preempt_resume_keeps_tokens(runs, arch):
    """Two slots, three requests, one resident preempted after five ticks:
    its slab (and jamba's and whisper's written pages) go to the host and
    come back, possibly into another slab, whisper's cross entry stays
    referenced while it is parked, and every token equals the
    reference's."""
    params, cfg, prompts, want = _case(runs, arch, False)
    got, m = _serve(params, cfg, prompts, preempt_after=5, batch_slots=2)
    assert got == want
    assert m["preemptions"] >= 1 and m["resumes"] >= 1
    assert m["offload_bytes"] > 0 and m["onload_bytes"] > 0
    assert m["peak_slabs"] <= 2 and m["slabs_in_use"] == 0
    assert m["cross_in_use"] == 0


@pytest.mark.parametrize("arch", ["xlstm-350m", "jamba-1.5-large-398b"])
def test_paged_state_bills_less_than_dense(runs, arch):
    """Three requests in four slots: the dense layout bills every slot's
    worst case, the state cache only what was live."""
    params, cfg, prompts, _ = _case(runs, arch, False)
    _, mp = _serve(params, cfg, prompts, kv_layout="paged")
    _, md = _serve(params, cfg, prompts, kv_layout="dense")
    assert 0 < mp["peak_state_bytes"] < md["peak_state_bytes"]
    assert mp["peak_slabs"] == 3 and mp["n_slabs"] == 4
    assert mp["slab_bytes_per_seq"] > 0
    if arch == "xlstm-350m":                 # pageless: slabs only
        assert mp["n_pages"] == 0 and mp["peak_kv_bytes"] == 0


def test_moe_at_published_capacity_matches_reference():
    """olmoe at its published capacity factor 1.25: experts drop
    assignments, and which depends on the batch's shape (a paged chunk
    routes B x C rows, padding included; a dense prefill one prompt), so
    the two layouts may emit different tokens. Each layout of the port
    equals the same layout of the reference."""
    jcfg, tcfg = _cfgs("olmoe-1b-7b", capacity_factor=1.25)
    jp = jlm.lm_init(jax.random.PRNGKey(1), jcfg)
    params = params_from_reference(jp)
    prompts = _prompts(jcfg.vocab_size, lens=(7, 19, 12, 33, 9))
    for layout, sched in (("paged", "cb"), ("dense", "fifo")):
        want = _jax_serve(jp, jcfg, prompts, kv_layout=layout,
                          scheduler=sched)
        got, _ = _serve(params, tcfg, prompts, kv_layout=layout,
                        scheduler=sched)
        assert got == want, layout


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_serve_config_resolves(arch):
    _, cfg = _cfgs(arch)
    for layout in ("paged", "dense"):
        sc = ServeConfig(kv_layout=layout).resolve(cfg)
        assert sc.resolved and sc.kv_layout == layout


@pytest.mark.parametrize("arch", ["xlstm-350m", "jamba-1.5-large-398b"])
def test_recurrent_patterns_refuse_prefix_cache_and_spec(arch):
    """The reference's predicates and wording (tests/test_state_cache.py):
    slab state is per sequence, and a slab update cannot roll back."""
    _, cfg = _cfgs(arch)
    with pytest.raises(ValueError, match=r"recurrent mixer\(s\)"):
        ServeConfig(kv_layout="paged", prefix_cache=True).resolve(cfg)
    with pytest.raises(ValueError, match="roll back"):
        ServeConfig(kv_layout="paged", spec_decode=True).resolve(cfg)
    # env defaults degrade silently
    sc = ServeConfig(kv_layout="paged").resolve(cfg)
    assert not sc.prefix_cache and not sc.spec_decode


def test_paged_state_bills_less_than_dense_whisper(runs):
    """whisper-small: three requests over two distinct inputs. The state
    cache bills the pages that were live and one cross entry per distinct
    input; the dense layout every slot's worst case and a private cross
    block each."""
    params, cfg, prompts, _ = _case(runs, "whisper-small", False)
    _, mp = _serve(params, cfg, prompts, kv_layout="paged")
    _, md = _serve(params, cfg, prompts, kv_layout="dense")
    per_entry = 2 * cfg.n_layers * cfg.n_kv_heads * cfg.enc_seq_len \
        * cfg.dh * 4
    assert mp["peak_cross"] == 2 and mp["cross_hits"] == 1
    assert mp["cross_bytes_per_entry"] == per_entry
    assert 2 * per_entry < mp["peak_state_bytes"] < md["peak_state_bytes"]
    assert md["peak_state_bytes"] > KNOBS["batch_slots"] * per_entry


def test_whisper_raises_naming_the_roadmap():
    """whisper-small serves (ServeConfig resolves on both layouts, with
    replicas for the router, with shards and on f16 pages); a cache dtype
    this port still lacks raises, naming its ROADMAP.md item."""
    cfg = treduced(tget_config("whisper-small"))
    for layout in ("paged", "dense"):
        assert ServeConfig(kv_layout=layout).resolve(cfg).resolved
    assert ServeConfig(replicas=2).resolve(cfg).replicas == 2
    assert ServeConfig(shards=2).resolve(cfg).shards == 2
    assert ServeConfig(kv_cache_dtype="float16").resolve(
        cfg).kv_cache_dtype == torch.float16
    with pytest.raises(NotImplementedError,
                       match="ROADMAP.md: the other KV cache dtypes"):
        ServeConfig(kv_cache_dtype="float64").resolve(cfg)
