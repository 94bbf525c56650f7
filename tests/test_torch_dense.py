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
  defaults and raises its ``ValueError``s.

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
from repro.models import lm as jlm
from repro.nn.layers import quantize_params as jquantize
from repro.runtime import Runtime as JRuntime
from repro.serving.config import ServeConfig as JServeConfig
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import reduced as treduced
from repro_torch.interop import params_from_reference
from repro_torch.kernels import ops, ref
from repro_torch.models import lm as tlm
from repro_torch.runtime import Runtime
from repro_torch.serving import Request, ServeConfig, ServeEngine

TOL = dict(rtol=1e-5, atol=1e-5)
KNOBS = dict(batch_slots=2, max_seq=64)
NEW = 8
LENS = (33, 1, 12, 20, 5)


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

@pytest.fixture(scope="module")
def workload():
    cfg = _cfg(get_config, reduced)
    params = jlm.lm_init(jax.random.PRNGKey(3), cfg)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in LENS]
    want, metrics = {}, {}
    for scheme in (None, "spx_8_x3", "bfloat16"):
        quant = scheme not in (None, "bfloat16")
        rt = JRuntime(impl="ref", q_chunk=16, kv_quant=quant,
                      kv_scheme=scheme if quant else "uniform8")
        dtype = "bfloat16" if scheme == "bfloat16" else "float32"
        eng = JServeEngine(params, cfg, JServeConfig(
            kv_layout="dense", kv_cache_dtype=dtype, **KNOBS), rt=rt)
        for i, p in enumerate(prompts):
            eng.submit(JRequest(rid=i, prompt=p, max_new_tokens=NEW))
        want[scheme] = {r.rid: list(r.output) for r in eng.run()}
        metrics[scheme] = eng.metrics()
    return dict(cfg=_cfg(tget_config, treduced),
                params=params_from_reference(params), prompts=prompts,
                want=want, metrics=metrics)


@pytest.mark.parametrize("scheme", [None, "spx_8_x3", "bfloat16"])
def test_dense_engine_greedy_matches_reference(workload, scheme):
    """Greedy tokens and metrics of the dense engine against the JAX
    engine's: f32 caches, SPx-coded caches, and bf16 caches (read through
    f32 math, as the reference reads them)."""
    quant = scheme not in (None, "bfloat16")
    rt = Runtime(device="cpu", q_chunk=16, kv_quant=quant,
                 kv_scheme=scheme if quant else "uniform8")
    dtype = "bfloat16" if scheme == "bfloat16" else "float32"
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
