"""The port's dense KV layout against the JAX reference on the CPU.

* the plain ``flash_attention`` matches ``flash_attention_pallas`` run in
  interpret mode, causal and not, over GQA groupings, and the reference's
  plain attention at a ragged length (``atol = rtol = 1e-5``);
* ``lm_logits``, ``lm_prefill`` and ``lm_decode_step`` give the
  reference's logits (within 1e-4 of the largest |logit|) and caches, with
  f32 and ``sp2_4`` weights and with a quantized dense cache;
* the dense engine gives the JAX engine's greedy tokens with an f32 cache
  and with an ``spx_8_x3`` cache, every prefill through the flash op;
* ``ServeConfig(kv_layout="dense").resolve`` gives the reference's
  defaults and raises its ``ValueError``s;
* the plain flash version with a causal query offset matches the
  reference's chunked attention with its ``q_offset``;
* ``launch.steps.build_serve_step`` over a (data=2, model=4) mesh of
  eight CPU devices gives the reference's one-device prefill and decode
  step (the reference's own mesh cells: decode on granite-3-8b,
  olmoe-1b-7b and xlstm-350m, prefill on granite-3-8b with and without
  the context-parallel prefill and on whisper-small, with and without
  it): logits within SHARD_LOGIT_TOL of their largest magnitude, the
  caches reassembled from their blocks within 1e-5, a rerun
  bit-identical, and a decode write landing in one sequence block only;
* whisper-small's context-parallel prefill follows the reference's
  per-attention rule: a sequence whose length does not divide the model
  axis runs whole (the encoder at 18 frames, or the decoder at 62
  tokens, over 4 shards), on meshes (2, 4), (2, 2) and (pod 2, data 1,
  model 2), each against the reference's one-device prefill.

The CUDA kernels are held against these plain versions on the card by
the ``gpu`` tests of ``tests/test_torch_kernels.py``."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import get_config, reduced
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_pallas
from repro.models import encdec as jed
from repro.models import lm as jlm
from repro.nn.attention import _chunked_attention
from repro.nn.layers import quantize_params as jquantize
from repro.runtime import Runtime as JRuntime
from repro.serving.config import ServeConfig as JServeConfig
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import reduced as treduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.interop import params_from_reference
from repro_torch.kernels import ops, ref
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import build_serve_step, make_runtime
from repro_torch.models import lm as tlm
from repro_torch.sharding import shard_dense_caches
from repro_torch.runtime import Runtime
from repro_torch.serving import Request, ServeConfig, ServeEngine

TOL = dict(rtol=1e-5, atol=1e-5)
KNOBS = dict(batch_slots=2, max_seq=64)
NEW = 8
LENS = (33, 1, 12, 20, 5)


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
    """Drop this module's compiled JAX steps when it ends: a later module
    on the same worker (tests/test_fused_decode.py) counts the compiles
    of the reference's fused step."""
    yield
    jax.clear_caches()


def _cfg(pkg_get, pkg_reduced, **kw):
    return dataclasses.replace(pkg_reduced(pkg_get("gemma-2b"), vocab=32,
                                           **kw), head_dim=128)


def _logits_close(got, want):
    """Within 1e-4 of the largest |logit|."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


# ---------------------------------------------------------------------------
# flash attention's plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("rep", [1, 2, 8])
def test_flash_attention_matches_interpret_kernel(causal, rep):
    rng = np.random.default_rng(rep + 10 * causal)
    b, hkv, s, dh = 2, 2 if rep < 8 else 1, 64, 32
    hq = hkv * rep
    q = rng.standard_normal((b, hq, s, dh)).astype(np.float32)
    k = rng.standard_normal((b, hkv, s, dh)).astype(np.float32)
    v = rng.standard_normal((b, hkv, s, dh)).astype(np.float32)
    # the TPU kernel takes flattened heads with GQA expanded by its caller
    flat = [jnp.asarray(np.repeat(a, hq // a.shape[1], axis=1)
                        .reshape(b * hq, s, dh)) for a in (q, k, v)]
    want = np.asarray(flash_attention_pallas(
        *flat, causal=causal, bq=16, bkv=16, interpret=True)) \
        .reshape(b, hq, s, dh)
    ops.reset_op_calls()
    got = ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              causal=causal, q_chunk=16).numpy()
    assert ops.ref_calls() == {"flash_attention": 1}
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("s", [1, 33])
def test_flash_attention_ragged_length_matches_reference_plain_path(s):
    """At a length no blocking divides the reference drops to its plain
    attention; the port's plain version (and its kernel) takes it as is."""
    rng = np.random.default_rng(s)
    b, hq, hkv, dh = 1, 8, 1, 128
    q = rng.standard_normal((b, hq, s, dh)).astype(np.float32)
    k = rng.standard_normal((b, hkv, s, dh)).astype(np.float32)
    v = rng.standard_normal((b, hkv, s, dh)).astype(np.float32)
    flat = [jnp.asarray(np.repeat(a, hq // a.shape[1], axis=1)
                        .reshape(b * hq, s, dh)) for a in (q, k, v)]
    want = np.asarray(jref.attention_ref(*flat, causal=True)) \
        .reshape(b, hq, s, dh)
    got = ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              causal=True, q_chunk=16).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("q_offset", [0, 16, 48])
def test_flash_attention_query_offset_matches_reference(q_offset):
    """The plain version's causal offset (a context-parallel shard's rows
    [q_offset, q_offset + 16) over 64 keys) against the reference's
    ``_chunked_attention(q_offset=...)``, GQA 2 to 1."""
    rng = np.random.default_rng(q_offset)
    b, hkv, rep, sq, skv, dh = 2, 2, 2, 16, 64, 32
    q = rng.standard_normal((b, hkv * rep, sq, dh)).astype(np.float32)
    k = rng.standard_normal((b, hkv, skv, dh)).astype(np.float32)
    v = rng.standard_normal((b, hkv, skv, dh)).astype(np.float32)
    want = np.asarray(_chunked_attention(
        jnp.asarray(q), *(jnp.asarray(np.repeat(a, rep, axis=1))
                          for a in (k, v)),
        causal=True, q_chunk=8, q_offset=q_offset))
    got = ref.flash_attention_ref(*(torch.from_numpy(a) for a in (q, k, v)),
                                  causal=True, q_chunk=8, q_offset=q_offset)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_flash_cuda_wrapper_refuses_cpu_tensors():
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    x = torch.zeros((1, 2, 4, 32))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(x, x[:, :1], x[:, :1], causal=True)


# ---------------------------------------------------------------------------
# the model's dense forward, prefill and decode
# ---------------------------------------------------------------------------

def _models(weights):
    jcfg = _cfg(get_config, reduced, n_layers=2)
    tcfg = _cfg(tget_config, treduced, n_layers=2)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jp = jlm.lm_init(jax.random.PRNGKey(3), jcfg)
    if weights == "sp2_4":
        jp = jquantize(jp, "sp2_4")
    return jcfg, tcfg, jp, params_from_reference(jp)


@pytest.mark.parametrize("weights", ["f32", "sp2_4"])
def test_lm_logits_matches_reference(weights):
    jcfg, tcfg, jp, tp = _models(weights)
    tokens = np.random.default_rng(1).integers(0, 32, (2, 33)).astype(np.int32)
    want = jlm.lm_logits(jp, jnp.asarray(tokens), jcfg,
                         JRuntime(impl="ref", q_chunk=16))
    ops.reset_op_calls()
    got = tlm.lm_logits(tp, torch.from_numpy(tokens), tcfg,
                        Runtime(device="cpu", q_chunk=16))
    assert tuple(got.shape) == (2, 33, 32)
    _logits_close(got.numpy(), want)
    assert ops.ref_calls()["flash_attention"] == tcfg.n_layers


def _assert_caches_close(tc, jc, scheme):
    """f32 caches within TOL; quantized caches: identical codes and
    scales within TOL (the K/V that were quantized agree within f32
    rounding, far from any decision midpoint at these sizes)."""
    for ts, js in zip(tc, jc):
        for side in ("k", "v"):
            if scheme is None:
                np.testing.assert_allclose(ts[side].numpy(),
                                           np.asarray(js[side]), **TOL)
            else:
                np.testing.assert_array_equal(
                    ts[side]["codes"].numpy(), np.asarray(js[side]["codes"]))
                np.testing.assert_allclose(ts[side]["scale"].numpy(),
                                           np.asarray(js[side]["scale"]),
                                           **TOL)


@pytest.mark.parametrize("weights,scheme", [("f32", None), ("sp2_4", None),
                                            ("f32", "spx_8_x3"),
                                            ("sp2_4", "uniform8")])
def test_prefill_and_decode_match_reference(weights, scheme):
    jcfg, tcfg, jp, tp = _models(weights)
    quant = scheme is not None
    jrt = JRuntime(impl="ref", q_chunk=16, kv_quant=quant,
                   kv_scheme=scheme or "uniform8")
    trt = Runtime(device="cpu", q_chunk=16, kv_quant=quant,
                  kv_scheme=scheme or "uniform8")
    b, max_seq, s = 2, 24, 9
    jc = jlm.init_caches(jcfg, b, max_seq, dtype=jnp.float32, kv_quant=quant)
    tc = tlm.init_caches(tcfg, b, max_seq, dtype=torch.float32,
                         kv_quant=quant, device="cpu")
    rng = np.random.default_rng(4)
    prompt = rng.integers(0, 32, (b, s)).astype(np.int32)
    jl, jc = jlm.lm_prefill(jp, jnp.asarray(prompt), jc, jcfg, jrt)
    tl, tc = tlm.lm_prefill(tp, torch.from_numpy(prompt), tc, tcfg, trt)
    _logits_close(tl.numpy(), jl)
    _assert_caches_close(tc, jc, scheme)
    # three decode steps; the second at per-row positions
    for step, pos in enumerate((s, np.array([s + 1, s + 1], np.int32),
                                s + 2)):
        tok = rng.integers(0, 32, (b,)).astype(np.int32)
        jl, jc = jlm.lm_decode_step(jp, jnp.asarray(tok), jnp.asarray(pos),
                                    jc, jcfg, jrt)
        tl, tc = tlm.lm_decode_step(tp, torch.from_numpy(tok),
                                    torch.as_tensor(pos), tc, tcfg, trt)
        _logits_close(tl.numpy(), jl)
        _assert_caches_close(tc, jc, scheme)


# ---------------------------------------------------------------------------
# the dense serving engine
# ---------------------------------------------------------------------------

#: the half-width cache dtypes, each its own case beside f32 and codes
HALF = ("bfloat16", "float16")


@pytest.fixture(scope="module")
def workload():
    cfg = _cfg(get_config, reduced)
    params = jlm.lm_init(jax.random.PRNGKey(3), cfg)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in LENS]
    want, metrics = {}, {}
    for scheme in (None, "spx_8_x3") + HALF:
        quant = scheme not in (None,) + HALF
        rt = JRuntime(impl="ref", q_chunk=16, kv_quant=quant,
                      kv_scheme=scheme if quant else "uniform8")
        dtype = scheme if scheme in HALF else "float32"
        eng = JServeEngine(params, cfg, JServeConfig(
            kv_layout="dense", kv_cache_dtype=dtype, **KNOBS), rt=rt)
        for i, p in enumerate(prompts):
            eng.submit(JRequest(rid=i, prompt=p, max_new_tokens=NEW))
        want[scheme] = {r.rid: list(r.output) for r in eng.run()}
        metrics[scheme] = eng.metrics()
    return dict(cfg=_cfg(tget_config, treduced),
                params=params_from_reference(params), prompts=prompts,
                want=want, metrics=metrics)


@pytest.mark.parametrize("scheme", [None, "spx_8_x3", "bfloat16",
                                    "float16"])
def test_dense_engine_greedy_matches_reference(workload, scheme):
    """Greedy tokens and metrics of the dense engine against the JAX
    engine's: f32 caches, SPx-coded caches, and bf16 and f16 caches (read
    through f32 math, as the reference reads them)."""
    quant = scheme not in (None,) + HALF
    rt = Runtime(device="cpu", q_chunk=16, kv_quant=quant,
                 kv_scheme=scheme if quant else "uniform8")
    dtype = scheme if scheme in HALF else "float32"
    eng = ServeEngine(workload["params"], workload["cfg"],
                      ServeConfig(kv_layout="dense", kv_cache_dtype=dtype,
                                  **KNOBS), rt=rt)
    ops.reset_op_calls()
    for i, p in enumerate(workload["prompts"]):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=NEW))
    out = {r.rid: list(r.output) for r in eng.run()}
    assert out == workload["want"][scheme]
    calls = ops.ref_calls()
    # one flash attention per layer per admitted request, nothing paged
    assert calls["flash_attention"] == len(LENS) * workload["cfg"].n_layers
    assert set(calls) == {"spx_matmul", "flash_attention"}
    assert ops.op_calls() == {}
    got, want = eng.metrics(), workload["metrics"][scheme]
    for key in ("kv_layout", "scheduler", "kv_scheme", "kv_cache_dtype",
                "peak_kv_bytes", "tokens_generated", "requests_finished",
                "model_calls"):
        assert got[key] == want[key], key


def test_dense_engine_cancel_and_stream(workload):
    eng = ServeEngine(workload["params"], workload["cfg"],
                      ServeConfig(kv_layout="dense", **KNOBS),
                      rt=Runtime(device="cpu", q_chunk=16))
    for i in range(3):
        eng.submit(Request(rid=i, prompt=workload["prompts"][i],
                           max_new_tokens=NEW))
    eng.step()                                  # rids 0 and 1 resident
    assert eng.cancel(1) is True and eng.cancel(2) is True
    assert list(eng.stream(0)) == workload["want"][None][0]
    eng.run()
    assert [r.rid for r in eng.finished] == [0]
    with pytest.raises(ValueError, match="paged"):
        eng.preempt(0)


def test_dense_resolve_defaults():
    cfg = _cfg(tget_config, treduced)
    sc = ServeConfig(kv_layout="dense", **KNOBS).resolve(cfg)
    jsc = JServeConfig(kv_layout="dense", **KNOBS).resolve(
        _cfg(get_config, reduced))
    assert (sc.kv_layout, sc.scheduler, sc.fused_decode, sc.host_pages,
            sc.prefill_chunk, sc.shards) == \
        (jsc.kv_layout, jsc.scheduler, jsc.fused_decode, jsc.host_pages,
         jsc.prefill_chunk, jsc.shards) == ("dense", "fifo", False, None,
                                            None, 1)


def test_dense_env_defaults_degrade_silently(monkeypatch):
    for var, val in (("REPRO_SCHEDULER", "cb"), ("REPRO_FUSED_DECODE", "1"),
                     ("REPRO_HOST_PAGES", "8"), ("REPRO_PREFIX_CACHE", "1"),
                     ("REPRO_SPEC_K", "3"), ("REPRO_SHARDS", "2"),
                     ("REPRO_PREFILL_CHUNK", "8")):
        monkeypatch.setenv(var, val)
    sc = ServeConfig(kv_layout="dense", **KNOBS).resolve(
        _cfg(tget_config, treduced))
    assert (sc.scheduler, sc.fused_decode, sc.host_pages, sc.prefix_cache,
            sc.spec_k, sc.shards, sc.prefill_chunk) == \
        ("fifo", False, None, False, 0, 1, None)


@pytest.mark.parametrize("knob", [
    dict(scheduler="cb"), dict(fused_decode=True), dict(host_pages=8),
    dict(prefix_cache=True), dict(spec_decode=True), dict(spec_k=3),
    dict(shards=2),
])
def test_dense_explicit_paged_knobs_raise_like_reference(knob):
    for conf, c in ((ServeConfig, _cfg(tget_config, treduced)),
                    (JServeConfig, _cfg(get_config, reduced))):
        with pytest.raises(ValueError, match="dense|paged"):
            conf(kv_layout="dense", **knob, **KNOBS).resolve(c)


# ---------------------------------------------------------------------------
# the serve steps under a (data, model) mesh
# ---------------------------------------------------------------------------

#: |logits(mesh) - logits(one device)| <= SHARD_LOGIT_TOL * max|logits|:
#: the row-parallel products add their shards' partials in another order
SHARD_LOGIT_TOL = 1e-5
#: the reference's mesh cells (tests/test_sharding.py): its reduced
#: configs at d_model 64, vocabulary 512, 8 rows of a 64-token cache
MESH = (2, 4)
MESH_B, MESH_S = 8, 64
#: decode: the token after a PROMPT-token prefill (its write lands in the
#: third of the four sequence blocks)
PROMPT = 40
MESH_CELLS = [("granite-3-8b", "decode", None),
              ("olmoe-1b-7b", "decode", None),
              ("xlstm-350m", "decode", None),
              ("granite-3-8b", "prefill", False),
              ("granite-3-8b", "prefill", True),
              ("whisper-small", "prefill", None),
              ("whisper-small", "prefill", True)]


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


@pytest.mark.parametrize("arch,kind,cp", MESH_CELLS,
                         ids=[f"{a}-{k}" + ("" if c is None else
                                            f"-cp{int(c)}")
                              for a, k, c in MESH_CELLS])
def test_serve_step_on_mesh_matches_reference(arch, kind, cp):
    jcfg = reduced(get_config(arch), d_model=64, vocab=512)
    tcfg = treduced(tget_config(arch), d_model=64, vocab=512)
    jp = (jed.encdec_init if jcfg.enc_dec else jlm.lm_init)(
        jax.random.PRNGKey(0), jcfg)
    jinit = jed.encdec_init_caches if jcfg.enc_dec else jlm.init_caches
    jrt = JRuntime(impl="ref", q_chunk=1024)
    rng = np.random.default_rng(5)
    tokens = rng.integers(1, 512, (MESH_B, MESH_S)).astype(np.int32)
    frames = (rng.standard_normal((MESH_B, jcfg.enc_seq_len, 64))
              .astype(np.float32) if jcfg.enc_dec else None)
    mesh = make_host_mesh(*MESH, ["cpu"] * 8)
    bundle = build_serve_step(tcfg, ShapeConfig("t", MESH_S, MESH_B, kind),
                              mesh, quantized=False, prefill_cp=cp,
                              dtype=torch.float32)
    assert bundle.meta["context_parallel"] is bool(cp)
    # the forward reads the caches' cut from their specs, and nothing else
    assert bundle.rt.decode_seq_axis == (
        "model" if any(k in ("k", "v") for _, k, *_ in bundle.specs)
        else None)
    assert make_runtime(tcfg, mesh, None).decode_seq_axis is None
    jc = jinit(jcfg, MESH_B, MESH_S, dtype=jnp.float32)
    ops.reset_op_calls()
    if kind == "prefill":
        inputs = (tokens,) if frames is None else (frames, tokens)
        if jcfg.enc_dec:
            want, jc = jed.encdec_prefill(jp, jnp.asarray(frames),
                                          jnp.asarray(tokens), jc, jcfg, jrt)
        else:
            want, jc = jlm.lm_prefill(jp, jnp.asarray(tokens), jc, jcfg, jrt)
        args = bundle.place(params_from_reference(jp), *inputs)

        def run():
            return bundle.fn(*args, bundle.init_caches())
    else:
        _, jc0 = jlm.lm_prefill(jp, jnp.asarray(tokens[:, :PROMPT]), jc,
                                jcfg, jrt)
        want, jc = jlm.lm_decode_step(jp, jnp.asarray(tokens[:, PROMPT]),
                                      jnp.asarray(PROMPT), jc0, jcfg, jrt)
        before = params_from_reference(jc0)
        args = bundle.place(params_from_reference(jp), tokens[:, PROMPT],
                            PROMPT)

        def run():
            grid = shard_dense_caches(before, bundle.specs, mesh)
            return bundle.fn(*args, grid)
    got, grid = run()
    again, _ = run()
    assert torch.equal(got, again)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got.numpy() - want).max() <= \
        SHARD_LOGIT_TOL * np.abs(want).max()
    for (path, g), (_, w) in zip(_leaves(bundle.gather(grid)),
                                 _leaves(params_from_reference(jc))):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-5,
                                   err_msg=str(path))
    # every step on the CPU: the plain versions, no kernel
    assert ops.op_calls() == {}
    if kind == "decode" and "attn" in tcfg.pattern[0]:
        # the token's K lands in the one sequence block holding PROMPT
        s_blk = MESH_S // MESH[1]
        specs = bundle.specs
        start = shard_dense_caches(before, specs, mesh)
        for d in range(MESH[0]):
            for m in range(MESH[1]):
                changed = not torch.equal(grid[d][m][0]["k"],
                                          start[d][m][0]["k"])
                assert changed is (m == PROMPT // s_blk), (d, m)


#: (kind, quantized): the serve step's FSDP storage against the reference
FSDP_CELLS = [("prefill", False), ("prefill", True), ("decode", False),
              ("decode", True)]


@pytest.mark.parametrize("kind,quantized", FSDP_CELLS,
                         ids=[f"{k}-{'q' if q else 'f32'}"
                              for k, q in FSDP_CELLS])
def test_fsdp_serve_step_matches_reference(monkeypatch, kind, quantized):
    """The serve step's storage above ``FSDP_ABOVE`` params (patched to 0:
    reduced granite-3-8b, two layers) at mesh (2, 4): every stored leaf
    the reference's policy cuts over ``data`` is stored so and read
    through a gather per period; with sp2_4 weights the codes are cut on
    whole packed bytes (``wo``'s and ``down``'s over ``data`` on their
    packed last dim). The tensor-parallel prefill, and the decode after a
    PROMPT-token prefill, give the reference's one-device logits (on the
    reference's quantized weights where ``quantized``) within
    SHARD_LOGIT_TOL of their peak, and its caches."""
    from repro_torch import sharding as tsh
    monkeypatch.setattr(tsh, "FSDP_ABOVE", 0)
    jcfg = reduced(get_config("granite-3-8b"), d_model=64, vocab=512,
                   n_layers=2)
    tcfg = treduced(tget_config("granite-3-8b"), d_model=64, vocab=512,
                    n_layers=2)
    jp = jlm.lm_init(jax.random.PRNGKey(0), jcfg)
    jw = jquantize(jp, "sp2_4") if quantized else jp
    jrt = JRuntime(impl="ref", q_chunk=1024)
    tokens = np.random.default_rng(5).integers(
        1, 512, (MESH_B, MESH_S)).astype(np.int32)
    mesh = make_host_mesh(*MESH, ["cpu"] * 8)
    bundle = build_serve_step(tcfg, ShapeConfig("t", MESH_S, MESH_B, kind),
                              mesh, quantized=quantized, prefill_cp=False,
                              dtype=torch.float32)
    assert bundle.meta["fsdp"] is True
    assert bundle.meta["context_parallel"] is False
    jc = jlm.init_caches(jcfg, MESH_B, MESH_S, dtype=jnp.float32)
    if kind == "prefill":
        want, jc = jlm.lm_prefill(jw, jnp.asarray(tokens), jc, jcfg, jrt)
        args = bundle.place(params_from_reference(jp), tokens)
        got, grid = bundle.fn(*args, bundle.init_caches())
    else:
        _, jc0 = jlm.lm_prefill(jw, jnp.asarray(tokens[:, :PROMPT]), jc,
                                jcfg, jrt)
        want, jc = jlm.lm_decode_step(jw, jnp.asarray(tokens[:, PROMPT]),
                                      jnp.asarray(PROMPT), jc0, jcfg, jrt)
        args = bundle.place(params_from_reference(jp), tokens[:, PROMPT],
                            PROMPT)
        got, grid = bundle.fn(*args, shard_dense_caches(
            params_from_reference(jc0), bundle.specs, mesh))
    data_cut = {path for path, lay in bundle.layouts.items()
                if any(e is not None and "data" in
                       (e if isinstance(e, tuple) else (e,))
                       for e in lay.spec)}
    assert any("attn" in path and "wq" in path for path in data_cut)
    if quantized:
        packed = {path[-3] for path in data_cut if path[-1] == "codes"
                  and bundle.layouts[path].spec[-1] == "data"}
        assert packed == {"wo", "down"}
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got.numpy() - want).max() <= \
        SHARD_LOGIT_TOL * np.abs(want).max()
    for (path, g), (_, w) in zip(_leaves(bundle.gather(grid)),
                                 _leaves(params_from_reference(jc))):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-5,
                                   err_msg=str(path))


#: (encoder frames, prompt tokens, (pod, data, model)) of whisper-small's
#: context-parallel prefill: one sequence whole and the other cut
#: (the reference's per-attention rule), then both cut on two more meshes
CP_WHISPER_CELLS = [(18, 64, (None, 2, 4)), (16, 62, (None, 2, 4)),
                    (16, 64, (None, 2, 2)), (16, 64, (2, 1, 2))]


@pytest.mark.parametrize("s_enc,s,axes", CP_WHISPER_CELLS,
                         ids=[f"enc{e}-p{p}-" + "x".join(
                             str(n) for n in a if n)
                             for e, p, a in CP_WHISPER_CELLS])
def test_whisper_cp_prefill_per_call_rule(s_enc, s, axes):
    """``build_serve_step(whisper-small, prefill, prefill_cp=True)`` with
    the encoder's length and the prompt's set apart (``enc_seq_len``
    replaced in both packages' reduced configs): each sequence runs
    context-parallel where its length divides the model axis, else whole
    on each data group's first shard (``meta["cp_sequences"]``; the
    plain flash calls count it: one per attention, row block and data
    group), the weights are stored whole on every device, and the step
    gives the reference's one-device ``encdec_prefill``: logits within
    SHARD_LOGIT_TOL of their peak, self and cross caches within 1e-5, a
    rerun bit-identical, no kernel on the CPU."""
    pod, data, model = axes
    jcfg = dataclasses.replace(
        reduced(get_config("whisper-small"), d_model=64, vocab=512),
        enc_seq_len=s_enc)
    tcfg = dataclasses.replace(
        treduced(tget_config("whisper-small"), d_model=64, vocab=512),
        enc_seq_len=s_enc)
    jp = jed.encdec_init(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(5)
    tokens = rng.integers(1, 512, (MESH_B, s)).astype(np.int32)
    frames = rng.standard_normal((MESH_B, s_enc, 64)).astype(np.float32)
    want, jc = jed.encdec_prefill(
        jp, jnp.asarray(frames), jnp.asarray(tokens),
        jed.encdec_init_caches(jcfg, MESH_B, s, dtype=jnp.float32), jcfg,
        JRuntime(impl="ref", q_chunk=1024))
    n_dev = (pod or 1) * data * model
    mesh = make_host_mesh(data, model, ["cpu"] * n_dev, pod=pod)
    bundle = build_serve_step(tcfg, ShapeConfig("t", s, MESH_B, "prefill"),
                              mesh, quantized=False, prefill_cp=True,
                              dtype=torch.float32)
    cut = {"encoder": s_enc % model == 0, "decoder": s % model == 0}
    assert bundle.meta["cp_sequences"] == cut
    assert bundle.meta["context_parallel"] is (cut["encoder"]
                                               or cut["decoder"])
    assert bundle.meta["parallelism"] == "replicated"
    args = bundle.place(params_from_reference(jp), frames, tokens)
    assert all(all(e is None for e in lay.spec)
               for lay in bundle.layouts.values())

    def run():
        return bundle.fn(*args, bundle.init_caches())
    ops.reset_op_calls()
    got, grid = run()
    blocks = {k: model if c else 1 for k, c in cut.items()}
    assert ops.ref_calls()["flash_attention"] == (pod or 1) * data * (
        blocks["encoder"] + 2 * blocks["decoder"]) * tcfg.n_layers
    again, _ = run()
    assert torch.equal(got, again)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got.numpy() - want).max() <= \
        SHARD_LOGIT_TOL * np.abs(want).max()
    for (path, g), (_, w) in zip(_leaves(bundle.gather(grid)),
                                 _leaves(params_from_reference(jc))):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-5,
                                   err_msg=str(path))
    assert ops.op_calls() == {}


@pytest.mark.parametrize("arch", ["granite-3-8b", "olmoe-1b-7b"])
def test_lm_cp_prefill_runs_whole_where_length_does_not_divide(arch):
    """An LM's prefill under ``prefill_cp=True`` at a prompt length the
    model axis does not divide (62 tokens over 4 shards): the weights are
    stored whole and the caches cut on their sequence all the same,
    unevenly (16, 16, 15, 15 positions), as the reference's
    ``replicated`` policy stores them; the prompt runs whole on each data
    group's first shard (no collective, one plain flash call a layer and
    data group), and the step gives the reference's one-device
    ``lm_prefill``: logits within SHARD_LOGIT_TOL of their peak, caches
    within 1e-5."""
    from repro_torch import collectives
    s = 62
    jcfg = reduced(get_config(arch), d_model=64, vocab=512)
    tcfg = treduced(tget_config(arch), d_model=64, vocab=512)
    jp = jlm.lm_init(jax.random.PRNGKey(0), jcfg)
    tokens = np.random.default_rng(5).integers(
        1, 512, (MESH_B, s)).astype(np.int32)
    want, jc = jlm.lm_prefill(
        jp, jnp.asarray(tokens),
        jlm.init_caches(jcfg, MESH_B, s, dtype=jnp.float32), jcfg,
        JRuntime(impl="ref", q_chunk=1024))
    mesh = make_host_mesh(*MESH, ["cpu"] * 8)
    bundle = build_serve_step(tcfg, ShapeConfig("t", s, MESH_B, "prefill"),
                              mesh, quantized=False, prefill_cp=True,
                              dtype=torch.float32)
    assert bundle.meta["cp_sequences"] == {"decoder": False}
    assert bundle.meta["context_parallel"] is False
    assert bundle.meta["parallelism"] == "replicated"
    args = bundle.place(params_from_reference(jp), tokens)
    ops.reset_op_calls()
    collectives.reset_counts()
    got, grid = bundle.fn(*args, bundle.init_caches())
    assert [grid[0][m][0]["k"].shape[3] for m in range(MESH[1])] == \
        [16, 16, 15, 15]
    assert collectives.counts() == {}
    n_attn = sum(slot.startswith("attn") for slot in tcfg.pattern) \
        * tcfg.n_periods
    assert ops.ref_calls()["flash_attention"] == MESH[0] * n_attn
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= \
        SHARD_LOGIT_TOL * np.abs(want).max()
    for (path, g), (_, w) in zip(_leaves(bundle.gather(grid)),
                                 _leaves(params_from_reference(jc))):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-5,
                                   err_msg=str(path))
    assert ops.op_calls() == {}
