"""The port's replica router, the ``shards``/``replicas`` knobs of
``ServeConfig`` and the serving CLI, against the reference's
(``tests/test_sharded_serving.py:202-300``, ``repro.launch.serve``).

* ``ReplicaRouter``: a wave of 8 requests over 2 replicas lands
  ``[0, 1, 0, 1, ...]``, with the reference router's placements, tokens
  and merged counters; the tokens equal one engine's; duplicate rids,
  never-routed rids and cancels behave as the reference's; a bare engine
  refuses ``replicas > 1``.
* ``ServeConfig``: ``shards`` and ``replicas`` resolve as the reference's,
  env fallbacks (``REPRO_SHARDS``, ``REPRO_REPLICAS``) included.
* ``python -m repro_torch.launch.serve --device cpu --reduced`` runs with
  ``--stream``, ``--replicas 2``, ``--shards 2`` (under
  ``REPRO_FORCE_DEVICE_COUNT=2``), ``--kv-quant``, ``--spec-decode`` and
  ``--prefix-cache``, and its ``[serve] metrics:`` line parses; its
  options are the reference's plus ``--device``.
"""
import contextlib
import dataclasses
import io
import json
import re

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.launch import serve as jserve
from repro.models import lm as jlm
from repro.runtime import Runtime as JRuntime
from repro.serving import ReplicaRouter as JReplicaRouter
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServeConfig as JServeConfig
from repro_torch.configs import get_config, reduced
from repro_torch.interop import params_from_reference
from repro_torch.launch import hostdev
from repro_torch.launch import serve as tserve
from repro_torch.runtime import Runtime
from repro_torch.serving import (ReplicaRouter, Request, ServeConfig,
                                 ServeEngine)

RT = Runtime(device="cpu", q_chunk=16)
KNOBS = dict(batch_slots=2, max_seq=64, quantize=None, kv_layout="paged",
             page_size=8)
CLI = ["--device", "cpu", "--arch", "gemma-2b", "--reduced", "--requests",
       "3", "--slots", "2", "--max-seq", "32", "--new-tokens", "4"]


@pytest.fixture(scope="module", autouse=True)
def _fresh_jax_caches():
    yield
    jax.clear_caches()


def _cfg(get, red):
    return dataclasses.replace(red(get("gemma-2b"), vocab=32), head_dim=128)


CFG = _cfg(get_config, reduced)


def _reqs(req, n=8, seed=3, new_tokens=4):
    rng = np.random.default_rng(seed)
    return [req(rid=i, prompt=rng.integers(1, CFG.vocab_size,
                                           int(rng.integers(3, 12)))
                .astype(np.int32), max_new_tokens=new_tokens)
            for i in range(n)]


@pytest.fixture(scope="module")
def reference():
    """The reference router on the wave: placements, tokens, metrics."""
    jcfg = _cfg(jget_config, jreduced)
    jparams = jlm.lm_init(jax.random.PRNGKey(3), jcfg)
    router = JReplicaRouter(jparams, jcfg,
                            JServeConfig(**KNOBS, replicas=2),
                            rt=JRuntime(impl="ref", q_chunk=16))
    placements = [router.submit(r) for r in _reqs(JRequest)]
    done = router.run()
    return dict(params=params_from_reference(jparams), placements=placements,
                tokens={r.rid: list(r.output) for r in done},
                metrics=router.metrics())


def test_router_distributes_wave_and_merges_metrics(reference):
    router = ReplicaRouter(reference["params"], CFG,
                           ServeConfig(**KNOBS, replicas=2), rt=RT)
    placements = [router.submit(r) for r in _reqs(Request)]
    assert placements == reference["placements"] == [0, 1] * 4
    done = router.run()
    tokens = {r.rid: list(r.output) for r in done}
    assert sorted(tokens) == list(range(8))
    assert tokens == reference["tokens"]

    solo = ServeEngine(reference["params"], CFG, ServeConfig(**KNOBS), rt=RT)
    for r in _reqs(Request):
        solo.submit(r)
    assert {r.rid: list(r.output) for r in solo.run()} == tokens

    m, jm = router.metrics(), reference["metrics"]
    assert set(m) == set(jm)
    for key in ("replicas", "shards", "requests_per_replica",
                "requests_finished", "requests_cancelled", "tokens_generated",
                "engine_steps", "model_calls", "undrained_runs",
                "peak_kv_bytes", "peak_state_bytes"):
        assert m[key] == jm[key], key
    assert m["requests_per_replica"] == [4, 4]
    per = m["per_replica"]
    assert len(per) == 2 and all(p["device"] == "cpu" for p in per)
    assert m["engine_steps"] == sum(p["engine_steps"] for p in per)
    assert m["peak_kv_bytes"] == sum(p["peak_kv_bytes"] for p in per)
    # percentiles over the union of finished requests, not averaged
    fin = [r for e in router.engines for r in e.finished]
    assert m["ttft_p50_ms"] == pytest.approx(1e3 * float(np.median(
        [r.t_first_token - r.t_enqueue for r in fin])))
    assert m["latency_p95_ms"] > 0


def test_router_routes_streams_and_rejects_duplicate_rids(reference):
    router = ReplicaRouter(reference["params"], CFG,
                           ServeConfig(**KNOBS, replicas=2), rt=RT)
    reqs = _reqs(Request, 4)
    for r in reqs:
        router.submit(r)
    with pytest.raises(ValueError, match="already routed"):
        router.submit(Request(rid=0, prompt=reqs[0].prompt,
                              max_new_tokens=2))
    with pytest.raises(KeyError, match="never routed"):
        router.stream(99)
    assert router.cancel(1) is True
    assert list(router.stream(2)) == reference["tokens"][2]
    done = router.run()
    assert sorted(r.rid for r in done) == [0, 2, 3]
    assert router.metrics()["requests_cancelled"] == 1
    router.reset_metrics()
    assert router.metrics()["requests_finished"] == 0


def test_router_splits_explicit_budgets_and_needs_devices(reference,
                                                          monkeypatch):
    router = ReplicaRouter(reference["params"], CFG,
                           ServeConfig(**KNOBS, replicas=2, pool_pages=20,
                                       host_pages=7), rt=RT)
    assert [e.pool.n_pages for e in router.engines] == [10, 10]
    assert [e.pool.host_pages for e in router.engines] == [3, 3]
    monkeypatch.setenv(hostdev.FORCE_ENV, "2")
    with pytest.raises(ValueError, match=hostdev.FORCE_ENV):
        ReplicaRouter(reference["params"], CFG,
                      ServeConfig(**KNOBS, replicas=2, shards=2), rt=RT)
    monkeypatch.setenv(hostdev.FORCE_ENV, "4")
    router = ReplicaRouter(reference["params"], CFG,
                           ServeConfig(**KNOBS, replicas=2, shards=2), rt=RT)
    assert [e.rt.mesh.size for e in router.engines] == [2, 2]
    assert router.metrics()["shards"] == 2


def test_engine_rejects_router_knob(reference):
    with pytest.raises(ValueError, match="ReplicaRouter"):
        ServeEngine(reference["params"], CFG,
                    ServeConfig(**KNOBS, replicas=2), rt=RT)


# -- ServeConfig: shards and replicas -------------------------------------------

def test_resolve_fills_every_knob_and_is_idempotent():
    sc = ServeConfig(quantize=None).resolve(CFG)
    jsc = JServeConfig(quantize=None).resolve(_cfg(jget_config, jreduced))
    assert (sc.shards, sc.replicas) == (jsc.shards, jsc.replicas) == (1, 1)
    assert sc.resolve(CFG) is sc
    assert sc.replace(shards=2).resolve(CFG).shards == 2


def test_resolve_owns_env_fallbacks(monkeypatch):
    """REPRO_SHARDS / REPRO_REPLICAS are read in resolve() as the
    reference reads them; a resolved config is immune to env changes."""
    jcfg = _cfg(jget_config, jreduced)
    monkeypatch.setenv("REPRO_SHARDS", "4")
    monkeypatch.setenv("REPRO_REPLICAS", "3")
    sc = ServeConfig(quantize=None).resolve(CFG)
    jsc = JServeConfig(quantize=None).resolve(jcfg)
    assert (sc.shards, sc.replicas) == (jsc.shards, jsc.replicas) == (4, 3)
    monkeypatch.setenv("REPRO_SHARDS", "2")
    assert sc.resolve(CFG).shards == 4
    # dense degrades the env shards silently; explicit shards= raises
    dense = ServeConfig(quantize=None, kv_layout="dense").resolve(CFG)
    assert dense.shards == 1 and dense.replicas == 3
    with pytest.raises(ValueError, match="paged"):
        ServeConfig(quantize=None, kv_layout="dense", shards=2).resolve(CFG)
    # every pattern takes the env default and an explicit shards=, as the
    # reference's resolve does
    moe = reduced(get_config("olmoe-1b-7b"))
    jmoe = jreduced(jget_config("olmoe-1b-7b"))
    assert ServeConfig().resolve(moe).shards == \
        JServeConfig().resolve(jmoe).shards == 2
    assert ServeConfig(shards=4).resolve(moe).shards == 4


def test_resolve_validates_new_knobs():
    with pytest.raises(ValueError, match="shards"):
        ServeConfig(quantize=None, shards=0).resolve(CFG)
    with pytest.raises(ValueError, match="replicas"):
        ServeConfig(quantize=None, replicas=0).resolve(CFG)


# -- the serving CLI --------------------------------------------------------------

def _main(argv) -> list[str]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tserve.main(argv)
    return out.getvalue().splitlines()


@pytest.mark.parametrize("flags", [[], ["--stream"], ["--replicas", "2"],
                                   ["--shards", "2"], ["--kv-quant"],
                                   ["--spec-decode"], ["--prefix-cache"]],
                         ids=["default", "stream", "replicas", "shards",
                              "kv-quant", "spec", "prefix"])
def test_cli_runs_and_prints_the_metrics(flags, monkeypatch):
    if "--shards" in flags:
        monkeypatch.setenv(hostdev.FORCE_ENV, "2")
    lines = _main(CLI + flags)
    assert lines[0].startswith("[serve] 3 requests, 12 tokens in ")
    assert lines[-1].startswith("[serve] metrics: {")
    m = json.loads(lines[-1].removeprefix("[serve] metrics: "))
    assert m["requests_finished"] == 3 and m["tokens_generated"] == 12
    if "--replicas" in flags:
        assert m["replicas"] == 2 and len(m["per_replica"]) == 2
        assert lines[1].startswith("[serve] router: 2 replicas x 1 shard")
        return
    assert m["kv_layout"] == "paged" and m["device"] == "cpu"
    if "--shards" in flags:
        assert m["shards"] == 2
        assert any(line.startswith("[serve] sharded: 2 shards")
                   for line in lines)
    if "--stream" in flags:
        assert lines[1].startswith("[serve] streaming: delivered TTFT")
    if "--kv-quant" in flags:
        assert m["kv_scheme"] == "spx_8_x3"
    if "--spec-decode" in flags:
        assert m["spec_decode"] and m["spec_k"] == 4
    if "--prefix-cache" in flags:
        assert m["prefix_cache"]


def _options(main) -> list[str]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(SystemExit):
        main(["--help"])
    usage = out.getvalue().split("\n\n")[0]      # the usage block
    return sorted(set(re.findall(r"--[a-z][a-z0-9-]*", usage)))


def test_cli_options_are_the_references_plus_device():
    want = _options(jserve.main)
    assert "--shards" in want and "--kv-dtype" in want
    assert _options(tserve.main) == sorted(want + ["--device"])


def test_cli_without_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _main(CLI[2:])
