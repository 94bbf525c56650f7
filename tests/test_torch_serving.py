"""The port's serving engine against ``repro.serving.ServeEngine`` on the
pinned workload (reduced gemma-2b, vocab 32, head_dim 128, seed 3; page
size pinned in both engines): greedy outputs are identical under the cb
and fifo schedulers, with preemption and host offload, with weights the
port quantizes itself or that JAX quantized and the port carried over, and
with the prefix cache, speculative decoding and the unfused tick, and on
bf16 and f16 pages (fused and unfused ticks, and with preemption). Also: knobs
this port lacks raise (and shards beyond the devices, replicas on a bare
engine), env knobs resolve as in the reference,
entry points never fall back quietly to the CPU, and importing the port
loads neither JAX nor ``repro``."""
import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config, reduced
from repro.models import lm as jlm
from repro.nn.layers import quantize_params as jquantize
from repro.runtime import Runtime as JRuntime
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServeConfig as JServeConfig
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import reduced as treduced
from repro_torch.interop import params_from_reference
from repro_torch.kernels import ops
from repro_torch.models.lm import lm_init
from repro_torch.runtime import Runtime
from repro_torch.serving import Request, ServeConfig, ServeEngine

CPU = Runtime(device="cpu")
KNOBS = dict(batch_slots=2, max_seq=64, page_size=8)
NEW = 8
LENS = (33, 1, 12, 20, 5)           # 33 and 1 end in a one-token chunk


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


@pytest.fixture(scope="module")
def workload():
    """The reference's greedy outputs, computed once."""
    cfg = _cfg(get_config, reduced)
    params = jlm.lm_init(jax.random.PRNGKey(3), cfg)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in LENS]
    eng = JServeEngine(params, cfg, JServeConfig(**KNOBS),
                       rt=JRuntime(impl="ref", q_chunk=16))
    for i, p in enumerate(prompts):
        eng.submit(JRequest(rid=i, prompt=p, max_new_tokens=NEW))
    want = {r.rid: list(r.output) for r in eng.run()}
    return dict(cfg=_cfg(tget_config, treduced), params=params,
                prompts=prompts, want=want)


def _serve(params, cfg, prompts, config, *, priority_at=None):
    eng = ServeEngine(params, cfg, config, rt=CPU)
    for i, p in enumerate(prompts):
        if i != priority_at:
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=NEW))
    if priority_at is not None:
        for _ in range(3):
            eng.step()
        eng.submit(Request(rid=priority_at, prompt=prompts[priority_at],
                           max_new_tokens=NEW, priority=1))
    out = {r.rid: list(r.output) for r in eng.run()}
    return out, eng.metrics()


@pytest.mark.parametrize("scheduler", ["cb", "fifo"])
def test_greedy_matches_reference(workload, scheduler):
    ops.reset_op_calls()
    out, m = _serve(params_from_reference(workload["params"]),
                    workload["cfg"], workload["prompts"],
                    ServeConfig(scheduler=scheduler, **KNOBS))
    assert out == workload["want"]
    assert m["scheduler"] == scheduler and m["fused_decode"]
    # CPU tensors: every op took its plain version, one-token chunks too
    assert set(ops.ref_calls()) == {"spx_matmul", "paged_attention",
                                    "paged_decode_ragged"}
    assert ops.op_calls() == {}


def test_greedy_matches_reference_with_jax_quantized_weights(workload):
    qparams = params_from_reference(jquantize(workload["params"], "sp2_4"))
    out, _ = _serve(qparams, workload["cfg"], workload["prompts"],
                    ServeConfig(quantize=None, **KNOBS))
    assert out == workload["want"]


def test_preemption_with_host_offload_keeps_greedy(workload):
    # a pool of 13 pages holds two residents at most; a late priority-1
    # request must preempt one (its written pages go to the host tier)
    out, m = _serve(params_from_reference(workload["params"]),
                    workload["cfg"], workload["prompts"],
                    ServeConfig(pool_pages=13, **KNOBS), priority_at=3)
    assert m["preemptions"] >= 1 and m["resumes"] == m["preemptions"]
    assert m["offload_bytes"] > 0 and m["onload_bytes"] == m["offload_bytes"]
    assert out == workload["want"]


def test_sampling_is_per_request(workload):
    """Sampled outputs depend on the request alone (its seed), not on
    submit order or batch-mates."""
    params = params_from_reference(workload["params"])
    prompts = workload["prompts"][:3]

    def run(order):
        eng = ServeEngine(params, workload["cfg"], ServeConfig(**KNOBS),
                          rt=CPU)
        for i in order:
            eng.submit(Request(rid=i, prompt=prompts[i], max_new_tokens=6,
                               temperature=0.9))
        return {r.rid: list(r.output) for r in eng.run()}

    assert run([0, 1, 2]) == run([2, 0, 1])


def test_stream_and_cancel(workload):
    params = params_from_reference(workload["params"])
    eng = ServeEngine(params, workload["cfg"], ServeConfig(**KNOBS), rt=CPU)
    for i in range(3):
        eng.submit(Request(rid=i, prompt=workload["prompts"][i],
                           max_new_tokens=NEW))
    eng.step()                                  # rids 0 and 1 resident
    assert eng.cancel(1) is True and eng.cancel(2) is True
    assert list(eng.stream(0)) == workload["want"][0]
    eng.run()
    assert eng.cancel(1) is False
    assert [r.rid for r in eng.finished] == [0]
    assert eng.pool.stats.pages_in_use == 0


@pytest.mark.parametrize("knobs", [
    dict(prefix_cache=True),
    dict(spec_decode=True),
    dict(spec_k=3),
    dict(fused_decode=False),
], ids=["prefix_cache", "spec_decode", "spec_k=3", "unfused"])
def test_serving_modes_match_reference(workload, knobs):
    """The knobs earlier slices refused now serve, with the JAX engine's
    greedy tokens under the same knobs (which equal its default's)."""
    jeng = JServeEngine(workload["params"], _cfg(get_config, reduced),
                        JServeConfig(**KNOBS, **knobs),
                        rt=JRuntime(impl="ref", q_chunk=16))
    for i, p in enumerate(workload["prompts"]):
        jeng.submit(JRequest(rid=i, prompt=p, max_new_tokens=NEW))
    want = {r.rid: list(r.output) for r in jeng.run()}
    out, m = _serve(params_from_reference(workload["params"]),
                    workload["cfg"], workload["prompts"],
                    ServeConfig(**KNOBS, **knobs))
    assert out == want == workload["want"]
    jm = jeng.metrics()
    for key in ("prefix_cache", "spec_decode", "spec_k", "fused_decode",
                "model_calls", "prefix_hits", "draft_acceptance_rate"):
        assert m[key] == jm[key], key


def _half_want(workload, dtype):
    """The reference engine's greedy tokens and metrics on ``dtype`` pages
    (the oracle path: probabilities in f32 over the upcast pages)."""
    jeng = JServeEngine(workload["params"], _cfg(get_config, reduced),
                        JServeConfig(kv_cache_dtype=dtype, **KNOBS),
                        rt=JRuntime(impl="ref", q_chunk=16))
    for i, p in enumerate(workload["prompts"]):
        jeng.submit(JRequest(rid=i, prompt=p, max_new_tokens=NEW))
    return {r.rid: list(r.output) for r in jeng.run()}, jeng.metrics()


@pytest.fixture(scope="module")
def bf16_want(workload):
    return _half_want(workload, "bfloat16")


@pytest.fixture(scope="module")
def f16_want(workload):
    return _half_want(workload, "float16")


def _check_half_pages(workload, reference, knobs, dtype):
    """Paged engines on ``dtype`` pages give the JAX engine's greedy
    tokens on the same pages: the fused tick (kernel 2), the unfused tick
    (kernel 5), and a pool of 13 pages where a late priority-1 request
    preempts a resident (its pages go to the host tier and come back)."""
    want, jm = reference
    ops.reset_op_calls()
    out, m = _serve(params_from_reference(workload["params"]),
                    workload["cfg"], workload["prompts"],
                    ServeConfig(kv_cache_dtype=dtype, **KNOBS, **knobs),
                    priority_at=3 if "pool_pages" in knobs else None)
    assert out == want
    assert m["kv_cache_dtype"] == jm["kv_cache_dtype"] == dtype
    for key in ("page_size", "tokens_generated"):
        assert m[key] == jm[key], key
    if not knobs:
        assert (m["n_pages"], m["peak_kv_bytes"]) == (jm["n_pages"],
                                                      jm["peak_kv_bytes"])
        assert set(ops.ref_calls()) == {"spx_matmul", "paged_attention",
                                        "paged_decode_ragged"}
    if "fused_decode" in knobs:
        assert "paged_decode_ragged" not in ops.ref_calls()
    if "pool_pages" in knobs:
        assert m["preemptions"] >= 1 and m["resumes"] == m["preemptions"]
        assert m["offload_bytes"] > 0 \
            and m["onload_bytes"] == m["offload_bytes"]
    assert ops.op_calls() == {}


HALF_KNOBS = pytest.mark.parametrize("knobs", [
    dict(),
    dict(fused_decode=False),
    dict(pool_pages=13),
], ids=["fused", "unfused", "preempted"])


@HALF_KNOBS
def test_bf16_pages_match_reference(workload, bf16_want, knobs):
    """``_check_half_pages`` on bf16 pages."""
    _check_half_pages(workload, bf16_want, knobs, "bfloat16")


@HALF_KNOBS
def test_f16_pages_match_reference(workload, f16_want, knobs):
    """``_check_half_pages`` on f16 pages: the port's plain versions round
    each probability to f16 before P @ V (as the CUDA and TPU kernels do),
    the reference's oracle keeps it in f32; the tokens agree."""
    _check_half_pages(workload, f16_want, knobs, "float16")


@pytest.mark.parametrize("dtype", ["bfloat16", torch.bfloat16, "float32",
                                   "float16", torch.float16])
def test_cache_dtypes_resolve(workload, dtype):
    sc = ServeConfig(kv_cache_dtype=dtype, **KNOBS).resolve(workload["cfg"])
    assert sc.kv_cache_dtype == getattr(torch, str(dtype).replace(
        "torch.", ""))
    dense = ServeConfig(kv_layout="dense", kv_cache_dtype=dtype).resolve(
        workload["cfg"])
    assert dense.kv_cache_dtype == sc.kv_cache_dtype


@pytest.mark.parametrize("config", [
    ServeConfig(shards=2),
    ServeConfig(replicas=2),
    ServeConfig(kv_cache_dtype="float64"),
    ServeConfig(kv_layout="dense", kv_cache_dtype="float64"),
    ServeConfig(kv_layout="dense", replicas=2),
])
def test_knobs_this_port_lacks_raise(workload, config):
    """Cache dtypes other than f32, bf16 and f16 (float64 here) raise
    naming their ROADMAP.md item. shards and
    replicas are ported: a bare engine refuses replicas (the router's
    knob), and shards beyond the one CPU device ask for
    REPRO_FORCE_DEVICE_COUNT."""
    if config.shards or config.replicas:
        exc, match = ValueError, "REPRO_FORCE_DEVICE_COUNT|ReplicaRouter"
    else:
        exc, match = NotImplementedError, "ROADMAP.md"
    with pytest.raises(exc, match=match):
        ServeEngine(params_from_reference(workload["params"]),
                    workload["cfg"], config, rt=CPU)


def test_other_patterns_raise():
    """Every pattern of the reference resolves, the encoder-decoder's
    included, with shards and f16 pages; a cache dtype this port lacks
    raises on it too, naming its ROADMAP.md item."""
    cfg = treduced(tget_config("whisper-small"))
    sc = ServeConfig().resolve(cfg)
    assert sc.kv_layout == "paged" and sc.fused_decode
    assert ServeConfig(shards=2).resolve(cfg).shards == 2
    assert ServeConfig(kv_cache_dtype="float16").resolve(
        cfg).kv_cache_dtype == torch.float16
    with pytest.raises(NotImplementedError,
                       match="ROADMAP.md: the other KV cache dtypes"):
        ServeConfig(kv_cache_dtype="float64").resolve(cfg)


def test_env_defaults_degrade_silently(workload, monkeypatch):
    """As in the reference: the prefix-cache, speculation and fused-tick
    env knobs take effect on the paged layout and degrade silently on the
    dense one; shards and replicas resolve from the env."""
    for var, val in (("REPRO_PREFIX_CACHE", "1"), ("REPRO_SPEC_K", "3"),
                     ("REPRO_FUSED_DECODE", "0"), ("REPRO_SHARDS", "2"),
                     ("REPRO_REPLICAS", "2"),
                     ("REPRO_PREFIX_CACHE_PAGES", "5")):
        monkeypatch.setenv(var, val)
    sc = ServeConfig(**KNOBS).resolve(workload["cfg"])
    assert (sc.prefix_cache, sc.spec_decode, sc.spec_k) == (True, True, 3)
    assert sc.fused_decode is False and sc.prefix_cache_pages == 5
    assert (sc.shards, sc.replicas) == (2, 2)
    want = JServeConfig(**KNOBS).resolve(_cfg(get_config, reduced))
    for knob in ("prefix_cache", "spec_decode", "spec_k", "fused_decode",
                 "prefix_cache_pages", "shards", "replicas"):
        assert getattr(sc, knob) == getattr(want, knob), knob
    dense = ServeConfig(kv_layout="dense").resolve(workload["cfg"])
    assert (dense.prefix_cache, dense.spec_decode, dense.spec_k,
            dense.fused_decode) == (False, False, 0, False)


@pytest.mark.parametrize("knobs,match", [
    (dict(prefix_cache=True), "prefix_cache"),
    (dict(spec_decode=True), "spec_decode"),
    (dict(spec_k=2), "spec_decode"),
    (dict(fused_decode=True), "fused_decode"),
])
def test_dense_layout_refuses_paged_modes(workload, knobs, match):
    with pytest.raises(ValueError, match=match):
        ServeConfig(kv_layout="dense", **knobs).resolve(workload["cfg"])


@pytest.mark.parametrize("knobs", [dict(spec_k=0), dict(spec_k=-1),
                                   dict(spec_decode=False, spec_k=2)])
def test_bad_spec_windows_raise(workload, knobs):
    with pytest.raises(ValueError, match="spec_k"):
        ServeConfig(**knobs).resolve(workload["cfg"])


def test_default_device_without_card_raises(workload):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default device works")
    params = params_from_reference(workload["params"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(params, workload["cfg"], ServeConfig(**KNOBS))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm_init(torch.Generator(), workload["cfg"])


def test_import_loads_neither_jax_nor_repro():
    code = (
        "import sys, pkgutil, importlib, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print('ok', len([m for m in sys.modules if m.startswith('repro_torch')]))\n")
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(src))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")
