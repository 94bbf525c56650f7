"""The port's SPx-quantized KV cache against the JAX reference on the CPU.

* ``quantize_kv`` / ``dequantize_kv`` and ``paged_kv_write`` into code +
  scale pools give the reference's codes bit for bit and its scales;
* the plain ``paged_decode_ragged`` (quantized pools) and
  ``paged_attention_quant`` match the reference's Pallas kernels run in
  interpret mode (``atol = rtol = 1e-5``), ragged windows and empty slots
  included;
* the paged engine with ``Runtime(kv_quant=True)`` gives the JAX engine's
  greedy tokens for ``uniform8``, ``sp2_8`` and ``spx_8_x3`` under both
  schedulers, and with preemption and host offload; ``metrics()`` reports
  the reference's scheme and KV byte counts.

The CUDA kernels are held against these plain versions on the card by
the ``gpu`` tests of ``tests/test_torch_kernels.py``."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import get_config, reduced
from repro.kernels import ops as jops
from repro.models import lm as jlm
from repro.nn import attention as jattn
from repro.runtime import Runtime as JRuntime
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServeConfig as JServeConfig
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import reduced as treduced
from repro_torch.interop import params_from_reference
from repro_torch.kernels import ops, ref
from repro_torch.nn import attention as tattn
from repro_torch.runtime import Runtime, planner
from repro_torch.serving import Request, ServeConfig, ServeEngine

SCHEMES = ("uniform8", "sp2_8", "spx_8_x3")
KNOBS = dict(batch_slots=2, max_seq=64, page_size=8)
NEW = 8
LENS = (33, 1, 12, 20, 5)           # 33 and 1 end in a one-token chunk
TOL = dict(rtol=1e-5, atol=1e-5)


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


def _cfg(pkg_get, pkg_reduced):
    return dataclasses.replace(pkg_reduced(pkg_get("gemma-2b"), vocab=32),
                               head_dim=128)


# ---------------------------------------------------------------------------
# quantize / dequantize / page write
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scheme", SCHEMES)
def test_quantize_kv_matches_reference(scheme):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 5, 2, 64)).astype(np.float32)
    x[0, 0, 0] = 0.0                           # an all-zero row: scale floor
    jc, js = jattn.quantize_kv(jnp.asarray(x), scheme)
    tc, ts = tattn.quantize_kv(torch.from_numpy(x), scheme)
    assert tc.dtype == torch.uint8 and tuple(ts.shape) == (3, 5, 2, 1)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)
    np.testing.assert_allclose(
        tattn.dequantize_kv(tc, ts, scheme).numpy(),
        np.asarray(jattn.dequantize_kv(jc, js, scheme)), **TOL)
    np.testing.assert_array_equal(tattn.kv_lut(scheme).numpy(),
                                  np.asarray(jattn.kv_lut(scheme)))


def _quant_pools(n_pages, hkv, ps, dh):
    z = np.zeros((n_pages, hkv, ps, dh), np.uint8)
    s = np.ones((n_pages, hkv, ps, 1), np.float32)
    return {"codes": z, "scale": s}


@pytest.mark.parametrize("scheme", ["uniform8", "spx_8_x3"])
def test_paged_kv_write_quantized_matches_reference(scheme):
    rng = np.random.default_rng(2)
    b, c, hkv, dh, ps, n_pages = 2, 5, 2, 32, 4, 6
    k_new = rng.standard_normal((b, c, hkv, dh)).astype(np.float32)
    v_new = rng.standard_normal((b, c, hkv, dh)).astype(np.float32)
    bt = np.array([[3, 1, 0], [5, 2, 4]], np.int32)
    pos = np.array([[2, 3, 4, 5, 6], [0, 1, 2, 3, 4]], np.int32)
    valid = np.array([[1, 1, 1, 1, 0], [1, 1, 1, 0, 0]], bool)
    jk, jv = jattn.paged_kv_write(
        *({k: jnp.asarray(a) for k, a in _quant_pools(n_pages, hkv, ps,
                                                       dh).items()}
          for _ in range(2)),
        jnp.asarray(k_new), jnp.asarray(v_new), jnp.asarray(bt),
        jnp.asarray(pos), jnp.asarray(valid), kv_scheme=scheme)
    tk, tv = tattn.paged_kv_write(
        *({k: torch.from_numpy(a) for k, a in _quant_pools(n_pages, hkv, ps,
                                                            dh).items()}
          for _ in range(2)),
        torch.from_numpy(k_new), torch.from_numpy(v_new),
        torch.from_numpy(bt), torch.from_numpy(pos), torch.from_numpy(valid),
        kv_scheme=scheme)
    for j, t in ((jk, tk), (jv, tv)):
        np.testing.assert_array_equal(t["codes"].numpy(),
                                      np.asarray(j["codes"]))
        np.testing.assert_allclose(t["scale"].numpy(),
                                   np.asarray(j["scale"]), **TOL)


# ---------------------------------------------------------------------------
# the two quantized attention kernels' plain versions
# ---------------------------------------------------------------------------

def _random_quant_pools(rng, scheme, b, hkv, ps, max_pages, dh):
    n_pages = 1 + b * max_pages
    pools = []
    for _ in range(2):
        x = rng.standard_normal((n_pages, hkv, ps, dh)).astype(np.float32)
        codes, scale = tattn.quantize_kv(torch.from_numpy(x), scheme)
        pools.append({"codes": codes.numpy(), "scale": scale.numpy()})
    bt = rng.integers(0, n_pages, (b, max_pages)).astype(np.int32)
    return pools[0], pools[1], bt


def _jax(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _torch(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


@pytest.mark.parametrize("scheme", ["uniform8", "spx_8_x3"])
@pytest.mark.parametrize("w,ctx,qlen", [
    (4, [0, 7, 8, 9], [0, 1, 3, 4]),          # q_len 0..w, page straddles
    (1, [0, 7, 8, 25], [0, 1, 1, 1]),         # plain decode window
])
def test_paged_decode_ragged_quant_matches_interpret_kernel(scheme, w, ctx,
                                                            qlen):
    rng = np.random.default_rng(13 + w)
    b, hq, hkv, dh, ps, mp = 4, 4, 2, 32, 8, 4
    kd, vd, bt = _random_quant_pools(rng, scheme, b, hkv, ps, mp, dh)
    q = rng.standard_normal((b, w, hq, dh)).astype(np.float32)
    tabs = (bt, np.asarray(ctx, np.int32), np.asarray(qlen, np.int32))
    want = np.asarray(jops.paged_decode_ragged(
        jnp.asarray(q), _jax(kd), _jax(vd),
        *(jnp.asarray(a) for a in tabs), kv_scheme=scheme,
        impl="interpret"))
    ops.reset_op_calls()
    got = ops.paged_decode_ragged(
        torch.from_numpy(q), _torch(kd), _torch(vd),
        *(torch.from_numpy(a) for a in tabs), kv_scheme=scheme).numpy()
    assert ops.ref_calls() == {"paged_decode_ragged_quant": 1}
    assert got.shape == (b, w, hq, dh)
    np.testing.assert_allclose(got, want, **TOL)
    for row, n in enumerate(qlen):
        assert (got[row, n:] == 0).all()       # exact zeros past q_len
        if n:
            assert (got[row, :n] != 0).any()


def test_paged_decode_ragged_quant_needs_scheme():
    rng = np.random.default_rng(0)
    kd, vd, bt = _random_quant_pools(rng, "uniform8", 1, 1, 8, 1, 32)
    one = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="kv_scheme"):
        ops.paged_decode_ragged(torch.zeros((1, 1, 1, 32)), _torch(kd),
                                _torch(vd), torch.from_numpy(bt), one, one)


@pytest.mark.parametrize("scheme", ["uniform8", "sp2_8"])
def test_paged_attention_quant_matches_interpret_kernel(scheme):
    rng = np.random.default_rng(5)
    b, hq, hkv, dh, ps, mp = 4, 4, 2, 32, 8, 3
    kd, vd, bt = _random_quant_pools(rng, scheme, b, hkv, ps, mp, dh)
    q = rng.standard_normal((b, hq, dh)).astype(np.float32)
    ctx = np.asarray([0, 1, ps, 2 * ps + 3], np.int32)
    want = np.asarray(jops.paged_attention_quant(
        jnp.asarray(q), _jax(kd), _jax(vd), jnp.asarray(bt),
        jnp.asarray(ctx), kv_scheme=scheme, impl="interpret"))
    ops.reset_op_calls()
    got = ops.paged_attention_quant(
        torch.from_numpy(q), _torch(kd), _torch(vd), torch.from_numpy(bt),
        torch.from_numpy(ctx), kv_scheme=scheme).numpy()
    assert ops.ref_calls() == {"paged_attention_quant": 1}
    np.testing.assert_allclose(got, want, **TOL)
    assert (got[0] == 0).all()                 # ctx_len == 0 -> zeros


def test_quant_cuda_wrappers_refuse_cpu_tensors():
    from repro_torch.kernels.paged_attention import (
        paged_attention_quant_cuda, paged_decode_ragged_quant_cuda)
    q = torch.zeros((1, 1, 2, 32))
    codes = torch.zeros((2, 1, 8, 32), dtype=torch.uint8)
    scale = torch.ones((2, 1, 8, 1))
    bt = torch.zeros((1, 2), dtype=torch.int32)
    one = torch.ones(1, dtype=torch.int32)
    lut = tattn.kv_lut("uniform8")
    with pytest.raises(ValueError, match="CUDA"):
        paged_decode_ragged_quant_cuda(q, codes, scale, codes, scale, bt,
                                       one, one, lut, w=1)
    with pytest.raises(ValueError, match="CUDA"):
        paged_attention_quant_cuda(q, codes, scale, codes, scale, bt, one,
                                   lut)


def test_quant_page_size_rule(monkeypatch):
    """Code + scale pages fill the same shared-memory budget as f32 pages,
    so they hold more tokens."""
    monkeypatch.delenv("REPRO_PAGE_SIZE", raising=False)
    assert planner.plan_kv_pages(256, kv_scheme="spx_8_x3").page_size == 32
    assert planner.plan_kv_pages(128, kv_scheme="uniform8").page_size == 64
    for dh in (32, 64, 128, 256):
        plan = planner.plan_kv_pages(dh, kv_scheme="uniform8")
        assert plan.smem_bytes == 2 * plan.page_size * (dh + 4) \
            <= planner.PAGE_PAIR_SMEM_BYTES


# ---------------------------------------------------------------------------
# the serving engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def workload():
    """The reference engine's greedy outputs and metrics per scheme."""
    cfg = _cfg(get_config, reduced)
    params = jlm.lm_init(jax.random.PRNGKey(3), cfg)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in LENS]
    want, metrics = {}, {}
    for scheme in SCHEMES:
        eng = JServeEngine(params, cfg, JServeConfig(**KNOBS),
                           rt=JRuntime(impl="ref", q_chunk=16, kv_quant=True,
                                       kv_scheme=scheme))
        for i, p in enumerate(prompts):
            eng.submit(JRequest(rid=i, prompt=p, max_new_tokens=NEW))
        want[scheme] = {r.rid: list(r.output) for r in eng.run()}
        metrics[scheme] = eng.metrics()
    return dict(cfg=_cfg(tget_config, treduced),
                params=params_from_reference(params), prompts=prompts,
                want=want, metrics=metrics)


def _serve(workload, scheme, config, *, priority_at=None):
    eng = ServeEngine(workload["params"], workload["cfg"], config,
                      rt=Runtime(device="cpu", kv_quant=True,
                                 kv_scheme=scheme))
    prompts = workload["prompts"]
    for i, p in enumerate(prompts):
        if i != priority_at:
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=NEW))
    if priority_at is not None:
        for _ in range(3):
            eng.step()
        eng.submit(Request(rid=priority_at, prompt=prompts[priority_at],
                           max_new_tokens=NEW, priority=1))
    return {r.rid: list(r.output) for r in eng.run()}, eng


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("scheduler", ["cb", "fifo"])
def test_quant_engine_greedy_matches_reference(workload, scheme, scheduler):
    ops.reset_op_calls()
    out, eng = _serve(workload, scheme,
                      ServeConfig(scheduler=scheduler, **KNOBS))
    assert out == workload["want"][scheme]
    assert eng.kv_scheme == scheme
    # the one-token prefill chunks (prompts of 33 and 1) take
    # paged_attention_quant; every decode tick the quantized ragged kernel
    assert set(ops.ref_calls()) == {"spx_matmul", "paged_attention_quant",
                                    "paged_decode_ragged_quant"}
    assert ops.op_calls() == {}


@pytest.mark.parametrize("scheme", SCHEMES)
def test_quant_engine_metrics_match_reference(workload, scheme):
    _, eng = _serve(workload, scheme, ServeConfig(**KNOBS))
    got, want = eng.metrics(), workload["metrics"][scheme]
    assert got["kv_scheme"] == want["kv_scheme"] == scheme
    assert got["kv_cache_dtype"] == want["kv_cache_dtype"] == "uint8+f32scale"
    for key in ("peak_kv_bytes", "page_size", "n_pages", "peak_kv_pages",
                "tokens_generated", "requests_finished"):
        assert got[key] == want[key], key


# ---------------------------------------------------------------------------
# Cache bytes by dtype, and the default cache dtype
# ---------------------------------------------------------------------------

def _nbytes(tree) -> int:
    from repro_torch.nn.layers import tree_leaves
    return sum(leaf.nbytes for leaf in tree_leaves(tree))


def _jnbytes(tree) -> int:
    return sum(leaf.nbytes for leaf in jax.tree_util.tree_leaves(tree))


def _gqa_cfgs():
    """Reduced granite (4 query heads on 1 KV head), in both packages."""
    return (treduced(tget_config("granite-3-8b")),
            reduced(get_config("granite-3-8b")))


@pytest.mark.parametrize("dtype,kv_quant", [
    (torch.float32, False), (torch.bfloat16, False), (torch.float32, True)])
def test_pool_bytes_matches_allocated_nbytes(dtype, kv_quant):
    from repro_torch.models import lm as tlm
    from repro_torch.serving.kv_cache import pool_bytes
    cfg, _ = _gqa_cfgs()
    n_pages, ps = 6, 8
    caches = tlm.paged_init_caches(cfg, n_pages, ps, dtype=dtype,
                                   kv_quant=kv_quant, device="cpu")
    scheme = "spx_8_x3" if kv_quant else None
    assert _nbytes(caches) == pool_bytes(cfg, n_pages, ps, dtype,
                                         kv_scheme=scheme)


@pytest.mark.parametrize("dtype,kv_quant", [
    (torch.float32, False), (torch.bfloat16, False), (torch.float32, True)])
def test_dense_cache_bytes_match_kv_bytes_per_token(dtype, kv_quant):
    from repro_torch.models import lm as tlm
    from repro_torch.serving.kv_cache import kv_bytes_per_token
    cfg, _ = _gqa_cfgs()
    b, s = 3, 16
    caches = tlm.init_caches(cfg, b, s, dtype=dtype, kv_quant=kv_quant,
                             device="cpu")
    scheme = "uniform8" if kv_quant else None
    assert _nbytes(caches) == b * s * kv_bytes_per_token(
        cfg, dtype, kv_scheme=scheme)


def test_default_cache_dtype_is_the_references():
    """With ``dtype`` omitted both allocators give bf16, as the
    reference's do, with the reference's bytes."""
    from repro_torch.models import lm as tlm
    cfg, jcfg = _gqa_cfgs()
    paged = tlm.paged_init_caches(cfg, 6, 8, device="cpu")
    dense = tlm.init_caches(cfg, 3, 16, device="cpu")
    jpaged = jlm.paged_init_caches(jcfg, 6, 8)
    jdense = jlm.init_caches(jcfg, 3, 16)
    from repro_torch.nn.layers import tree_leaves
    for tree, jtree in ((paged, jpaged), (dense, jdense)):
        dtypes = {str(leaf.dtype) for leaf in tree_leaves(tree)}
        jdtypes = {str(leaf.dtype) for leaf in
                   jax.tree_util.tree_leaves(jtree)}
        assert dtypes == {"torch.bfloat16"} and jdtypes == {"bfloat16"}
        assert _nbytes(tree) == _jnbytes(jtree)


def test_quant_engine_preemption_offloads_codes_and_scales(workload):
    scheme = "spx_8_x3"
    out, eng = _serve(workload, scheme, ServeConfig(pool_pages=13, **KNOBS),
                      priority_at=3)
    m = eng.metrics()
    assert out == workload["want"][scheme]
    assert m["preemptions"] >= 1 and m["resumes"] == m["preemptions"]
    assert m["offload_bytes"] > 0 and m["onload_bytes"] == m["offload_bytes"]
    # every offloaded page carries 1-byte codes and one f32 scale per
    # (token, KV head) side: a whole number of pages at that size
    cfg = workload["cfg"]
    page_bytes = eng.page_size * 2 * cfg.n_layers * cfg.n_kv_heads \
        * (cfg.dh + 4)
    assert m["offload_bytes"] % page_bytes == 0
