"""Tensor-parallel serving in the port against the reference
(``tests/test_sharded_serving.py``'s counterparts).

* ``shards=2`` over ``["cpu", "cpu"]`` (``REPRO_FORCE_DEVICE_COUNT=2``) on
  the reference's identity workload (reduced gemma-2b, vocab 32,
  head_dim 128, sp2_4, seed 3, prompts of 3/9/17/6 tokens, page 8) gives
  the JAX reference's single-device greedy tokens in every kvq x spec x
  fused case, with two KV heads (the pools head-shard, the per-shard KV
  bytes half the global ones) and with one (every shard computes it
  whole into a replicated pool, as gemma-2b at full width does); also on
  a reduced qwen2-vl-2b (M-RoPE) with one and two KV heads, and under
  preemption. The reference's own test shows its ``shards=2`` equals its
  ``shards=1``. Also reduced olmoe-1b-7b (expert-parallel, sp2_4),
  xlstm-350m (recurrent mixers whole on each shard), jamba's one period
  and whisper-small (an odd vocabulary cut on d) at ``shards=2``: the
  reference's one-device tokens, and its bills.
* The logits at ``shards=2`` are within SHARD_LOGIT_TOL of ``shards=1``
  (the row-parallel sums add in another order), each shard holds exactly
  the unsharded codes and scales of its slice, and the prefix cache keeps
  the one-shard tokens.
* The widths the port once refused (qwen2-vl-2b's 12 query heads over 2
  KV heads at 4 shards, whisper-small's 12 heads at 8, olmoe-1b-7b and a
  vocabulary of 515 at 3) serve the reference's one-device greedy tokens
  and bills, cut unevenly where a count does not divide.
* ``ShardingPolicy.serving_cut`` cuts the dim the JAX tp policy shards,
  for every leaf of every bundled config (plain and sp2_4-quantized
  params) at model widths 2, 4 and 8, refusing none, except at the
  named departures; ``pool_spec`` is the reference's pool spec for
  every config; ``plan_shard_budget`` gives the reference's numbers.
* ``ServeEngine.metrics()`` has the reference's keys plus ``device``, and
  the same per-shard values, on both layouts and in every page dtype.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import assigned_archs
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.launch.steps import _params_sds
from repro.models import encdec as jed
from repro.models import lm as jlm
from repro.runtime import Runtime as JRuntime
from repro.runtime import planner as jplanner
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServeConfig as JServeConfig
from repro.serving.engine import ServeEngine as JServeEngine
from repro.sharding import ShardingPolicy as JShardingPolicy
from repro import training as jtr
from repro_torch import training as ttr
from repro_torch.configs import get_config, reduced
from repro_torch.core.quantized import QuantizedTensor
from repro_torch.interop import params_from_reference
from repro_torch.kernels import ops
from repro_torch.launch import hostdev
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.models import lm as lm_mod
from repro_torch.nn.layers import tree_leaves, tree_map
from repro_torch.runtime import Runtime, planner
from repro_torch.serving import Request, ServeConfig, ServeEngine
from repro_torch.serving.kv_cache import kv_bytes_per_token
from repro_torch.sharding import ShardingPolicy, shard_paged_state

KNOBS = dict(batch_slots=2, max_seq=64, quantize="sp2_4", kv_layout="paged",
             page_size=8)
LENS = (3, 9, 17, 6)
NEW = 6
#: |logits(shards=2) - logits(shards=1)| <= SHARD_LOGIT_TOL * max|logits|:
#: the row-parallel wo/down products and the embedding sum add their
#: halves in another order than one device's f32 matmul
SHARD_LOGIT_TOL = 1e-5


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
    yield
    jax.clear_caches()


#: the reduced configs of the sharded cases: the identity workload's
#: gemma-2b, and qwen2-vl-2b for M-RoPE
ARCH_KW = {"gemma-2b": dict(head_dim=128), "qwen2-vl-2b": {}}


def _cfg(get, red, arch="gemma-2b", hkv=2):
    return dataclasses.replace(red(get(arch), vocab=32), n_kv_heads=hkv,
                               **ARCH_KW[arch])


def _rt(kvq: bool) -> Runtime:
    return Runtime(device="cpu", q_chunk=16, kv_quant=kvq,
                   kv_scheme="spx_8_x3")


@pytest.fixture(scope="module")
def workloads():
    """``get(arch, hkv)``: the config, the reference's weights (seed 3)
    and prompts, and ``want(kvq)``, the reference's single-device greedy
    tokens for the pages' KV layout (its spec and fused modes give the
    same tokens); each built once."""
    built = {}

    def get(arch="gemma-2b", hkv=2):
        if (arch, hkv) in built:
            return built[arch, hkv]
        cfg = _cfg(jget_config, jreduced, arch, hkv)
        jparams = jlm.lm_init(jax.random.PRNGKey(3), cfg)
        rng = np.random.default_rng(3)
        prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
                   for n in LENS]
        tokens = {}

        def want(kvq):
            if kvq not in tokens:
                eng = JServeEngine(
                    jparams, cfg, JServeConfig(**KNOBS),
                    rt=JRuntime(impl="ref", q_chunk=16, kv_quant=kvq,
                                kv_scheme="spx_8_x3" if kvq else "none"))
                for i, p in enumerate(prompts):
                    eng.submit(JRequest(rid=i, prompt=p, max_new_tokens=NEW))
                tokens[kvq] = {r.rid: list(r.output) for r in eng.run()}
            return tokens[kvq]
        built[arch, hkv] = dict(cfg=_cfg(get_config, reduced, arch, hkv),
                                jparams=jparams,
                                params=params_from_reference(jparams),
                                prompts=prompts, want=want)
        return built[arch, hkv]
    return get


@pytest.fixture(scope="module")
def workload(workloads):
    return workloads()


def _serve(workload, config, kvq=False, *, prompts=None, priority_at=None):
    eng = ServeEngine(workload["params"], workload["cfg"], config,
                      rt=_rt(kvq))
    prompts = workload["prompts"] if prompts is None else prompts
    for i, p in enumerate(prompts):
        if i != priority_at:
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=NEW))
    if priority_at is not None:
        for _ in range(3):
            eng.step()
        eng.submit(Request(rid=priority_at, prompt=prompts[priority_at],
                           max_new_tokens=NEW, priority=1))
    return {r.rid: list(r.output) for r in eng.run()}, eng.metrics()


def _check_shard_bills(workload, m, kvq, hkv):
    """Two KV heads head-shard (one per shard, half the bytes); one is
    held whole by both shards, whose pools bill globally."""
    split = hkv == 2
    assert m["shards"] == 2 and m["kv_sharded"] is split
    assert m["kv_heads_per_shard"] == 1 and m["device"] == "cpu"
    per = 2 if split else 1
    assert m["peak_kv_bytes_per_shard"] * per == m["peak_kv_bytes"]
    per_tok = kv_bytes_per_token(workload["cfg"], dtype_bytes=4,
                                 kv_scheme="spx_8_x3" if kvq else None)
    assert m["pool_bytes_per_shard"] * per == \
        m["n_pages"] * m["page_size"] * per_tok


@pytest.fixture
def two_devices(monkeypatch):
    monkeypatch.setenv(hostdev.FORCE_ENV, "2")


@pytest.mark.parametrize("hkv", [1, 2], ids=["kv1", "kv2"])
@pytest.mark.parametrize("kvq", [False, True], ids=["plain", "spx-kv"])
@pytest.mark.parametrize("spec", [False, True], ids=["nospec", "spec"])
@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_sharded_greedy_matches_reference(workloads, two_devices, kvq, spec,
                                          fused, hkv):
    work = workloads("gemma-2b", hkv)
    ops.reset_op_calls()
    out, m = _serve(work, ServeConfig(
        **KNOBS, spec_decode=spec, spec_k=2 if spec else None,
        fused_decode=fused, shards=2), kvq)
    assert out == work["want"](kvq)
    _check_shard_bills(work, m, kvq, hkv)
    # CPU tensors: every shard took the plain versions; no kernel ran
    assert ops.op_calls() == {}
    if fused:
        decode = ("paged_decode_ragged_quant" if kvq
                  else "paged_decode_ragged")
        assert ops.ref_calls().get(decode, 0) > 0


@pytest.mark.parametrize("hkv", [1, 2], ids=["kv1", "kv2"])
@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_sharded_mrope_matches_reference(workloads, two_devices, fused, hkv):
    """qwen2-vl-2b (M-RoPE, reduced: 4 query heads) at shards=2: each
    shard rotates its own heads' text positions."""
    work = workloads("qwen2-vl-2b", hkv)
    assert work["cfg"].mrope_sections is not None
    out, m = _serve(work, ServeConfig(**KNOBS, fused_decode=fused, shards=2))
    assert out == work["want"](False)
    _check_shard_bills(work, m, False, hkv)


#: the families served sharded beside gemma-2b and qwen2-vl-2b: arch ->
#: (layers, vocab, weights) at reduced size. jamba is one period of its 8
#: slots; whisper-small's vocabulary of 513 does not split, so its table
#: and head are cut on d; olmoe's sp2_4 experts are cut with their scales
FAMILIES = {"olmoe-1b-7b": (2, 512, "sp2_4"), "xlstm-350m": (4, 512, None),
            "jamba-1.5-large-398b": (8, 512, None),
            "whisper-small": (2, 513, None)}
FAMILY_KNOBS = dict(batch_slots=4, max_seq=64, page_size=8)
FAMILY_LENS = (5, 12, 9)
FAMILY_NEW = 6
#: the bills a shard count does not change, held to the reference's
SHARED_BILLS = ("n_pages", "peak_kv_bytes", "n_slabs", "peak_slabs",
                "slab_bytes_per_seq", "peak_state_bytes", "n_cross",
                "peak_cross", "cross_bytes_per_entry", "cross_hits",
                "tokens_generated")


def _family_frames(cfg, n):
    """Encoder inputs of an enc-dec config (None elsewhere): rids 0 and 1
    share one, the rest another."""
    if not cfg.enc_dec:
        return [None] * n
    fr = np.random.default_rng(3).standard_normal(
        (2, cfg.enc_seq_len, cfg.d_model)).astype(np.float32)
    return [fr[min(i // 2, 1)] for i in range(n)]


@pytest.fixture(scope="module")
def families():
    """``get(arch)``: the reduced config, the reference's weights (seed 1)
    and prompts, its one-device paged engine's greedy tokens and metrics,
    and the reference's per-shard budget at shards=2 (its planner on the
    arguments its engine bills with); each built once."""
    built = {}

    def get(arch):
        if arch in built:
            return built[arch]
        layers, vocab, weights = FAMILIES[arch]
        jcfg = jreduced(jget_config(arch), n_layers=layers, vocab=vocab)
        jp = (jed.encdec_init if jcfg.enc_dec else jlm.lm_init)(
            jax.random.PRNGKey(1), jcfg)
        rng = np.random.default_rng(0)
        prompts = [rng.integers(1, vocab, n).astype(np.int32)
                   for n in FAMILY_LENS]
        frames = _family_frames(jcfg, len(prompts))
        eng = JServeEngine(jp, jcfg, JServeConfig(**FAMILY_KNOBS,
                                                  quantize=weights),
                           rt=JRuntime(impl="ref", q_chunk=16))
        for i, (p, f) in enumerate(zip(prompts, frames)):
            eng.submit(JRequest(rid=i, prompt=p, max_new_tokens=FAMILY_NEW,
                                frames=f))
        want = {r.rid: list(r.output) for r in eng.run()}
        jm = eng.metrics()
        budget = None
        if "page_size" in jm and jm["n_pages"]:
            dcfg = eng._decode_cfg
            budget = jplanner.plan_shard_budget(
                dcfg.n_kv_heads, dcfg.dh, shards=2,
                page_size=jm["page_size"], n_pages=jm["n_pages"],
                n_layers=eng._paged_layers(),
                slab_bytes=jm["slab_bytes_per_seq"],
                act_bytes=eng.kv_cache_dtype.itemsize, kv_scheme=None)
        built[arch] = dict(
            cfg=reduced(get_config(arch), n_layers=layers, vocab=vocab),
            weights=weights,
            params=params_from_reference(jp), prompts=prompts,
            frames=frames, want=want, metrics=jm, budget=budget)
        return built[arch]
    return get


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_sharded_families_match_reference(families, two_devices, arch):
    """olmoe-1b-7b (expert-parallel MoE), xlstm-350m (mLSTM and sLSTM
    whole on each shard, pageless), jamba (one period: attention pages,
    mamba slabs and the MoE) and whisper-small (the encoder and the cross
    region head-sharded; an odd vocabulary cut on d) at shards=2 (olmoe
    with sp2_4 weights each engine quantizes itself): the reference's
    one-device greedy tokens, the bills a shard count does not change
    equal to the reference's, one shard's bills equal to the reference's
    planner at shards=2, and no kernel launched (CPU tensors)."""
    work = families(arch)
    cfg = work["cfg"]
    ops.reset_op_calls()
    eng = ServeEngine(work["params"], cfg,
                      ServeConfig(**FAMILY_KNOBS, quantize=work["weights"],
                                  shards=2), rt=_rt(False))
    for i, (p, f) in enumerate(zip(work["prompts"], work["frames"])):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=FAMILY_NEW,
                           frames=f))
    assert {r.rid: list(r.output) for r in eng.run()} == work["want"]
    assert ops.op_calls() == {}
    m, jm, budget = eng.metrics(), work["metrics"], work["budget"]
    assert m["shards"] == 2
    for key in SHARED_BILLS:
        assert m.get(key) == jm.get(key), key
    if budget is not None:
        assert (m["kv_sharded"], m["kv_heads_per_shard"],
                m["pool_bytes_per_shard"]) == (
            budget.kv_sharded, budget.kv_heads_per_shard, budget.pool_bytes)
        assert m["peak_kv_bytes_per_shard"] == \
            m["peak_kv_pages"] * budget.page_bytes
    else:
        assert "kv_sharded" not in m and m["n_pages"] == 0
    d, v = cfg.d_model, cfg.vocab_size
    for s, p in enumerate(eng.params):
        table = p["embed"]["table"]
        if v % 2:
            # a vocabulary that does not split: table columns, head rows
            assert tuple(table.shape) == (v, d // 2)
            assert tuple(p["head"]["w"].shape) == (d // 2, v)
        else:
            assert tuple(table.shape) == (v // 2, d)
        if cfg.is_moe:
            slot = next(sp for sp in p["stack"]["slots"] if "moe" in sp)
            assert slot["moe"]["gate"].shape[1] == cfg.n_experts // 2
            assert tuple(slot["moe"]["router"]["w"].shape[-1:]) == \
                (cfg.n_experts,)


def test_one_shard_bills_globally(workload):
    out, m = _serve(workload, ServeConfig(**KNOBS))
    assert out == workload["want"](False)
    assert m["shards"] == 1 and m["kv_sharded"] is False
    assert m["kv_heads_per_shard"] == 2
    assert m["peak_kv_bytes_per_shard"] == m["peak_kv_bytes"]


def test_sharded_logits_within_tolerance(workload, two_devices):
    """A prefill chunk and then a fused tick through both engines: the
    logits agree within SHARD_LOGIT_TOL of their largest magnitude."""
    cfg = workload["cfg"]
    engines = [ServeEngine(workload["params"], cfg,
                           ServeConfig(**KNOBS, shards=n), rt=_rt(False))
               for n in (1, 2)]
    rng = np.random.default_rng(5)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 8)),
                             dtype=torch.int32)
    bt = torch.as_tensor([[1, 2], [3, 4]], dtype=torch.int32)
    idx = torch.full((2, 2), 0, dtype=torch.int32)
    for step, toks, ctx, n in (
            (lm_mod.lm_paged_step, tokens, [0, 0], [8, 5]),
            (lm_mod.lm_paged_fused_step, tokens[:, :1], [8, 5], [1, 1])):
        got = [step(e.params, toks, torch.tensor(ctx), bt, torch.tensor(n),
                    idx, e.caches, cfg, e.rt)[0] for e in engines]
        peak = got[0].abs().max()
        assert got[1].shape == got[0].shape
        assert (got[1] - got[0]).abs().max() <= SHARD_LOGIT_TOL * peak


def test_shards_hold_exact_codes_and_their_pools(workload, two_devices):
    eng = ServeEngine(workload["params"], workload["cfg"],
                      ServeConfig(**KNOBS, shards=2), rt=_rt(True))
    full = ServeEngine(workload["params"], workload["cfg"],
                       ServeConfig(**KNOBS), rt=_rt(True)).params
    slot = [p["stack"]["slots"][0] for p in eng.params]
    whole = full["stack"]["slots"][0]
    for s, sp in enumerate(slot):
        for name, dim in (("wq", -1), ("wk", -1), ("wo", -2)):
            got, want = sp["attn"][name]["w"], whole["attn"][name]["w"]
            assert isinstance(got, QuantizedTensor) and got.packed
            if dim == -1:
                n = want.logical_shape[-1] // 2
                assert torch.equal(got.codes, want.codes[..., s * n // 2:
                                                         (s + 1) * n // 2])
                assert torch.equal(got.scale,
                                   want.scale[..., s * n:(s + 1) * n])
            else:
                k = want.logical_shape[-2] // 2
                assert torch.equal(got.codes,
                                   want.codes[..., s * k:(s + 1) * k, :])
                assert torch.equal(got.scale, want.scale)
        table = eng.params[s]["embed"]["table"]
        assert torch.equal(table, full["embed"]["table"][s * 16:(s + 1) * 16])
        pool = eng.caches[s][0]["kp"]
        assert pool["codes"].shape[2] == 1 and pool["scale"].shape[2] == 1


@pytest.mark.parametrize("hkv", [1, 2], ids=["kv1", "kv2"])
def test_preemption_and_prefix_cache_keep_reference_tokens(workloads,
                                                           two_devices, hkv):
    """The cb scheduler's preemption (each shard's pages to the host tier
    and back: one payload per shard of head-sharded pools, one payload
    restored to every shard of replicated ones) keeps the reference's
    single-device tokens; the prefix cache's shared pages and
    copy-on-write run on every shard's pool and keep the one-shard
    tokens."""
    work = workloads("gemma-2b", hkv)
    sc = dict(KNOBS, pool_pages=9)
    two, m = _serve(work, ServeConfig(**sc, shards=2), priority_at=3)
    assert two == work["want"](False)
    assert m["preemptions"] >= 1 and m["resumes"] == m["preemptions"]
    assert m["offload_bytes"] > 0 and m["onload_bytes"] == m["offload_bytes"]
    system = work["prompts"][2][:16]
    prompts = [np.concatenate([system, p[:4]]) for p in work["prompts"]]
    prompts.append(system)
    one, _ = _serve(work, ServeConfig(**KNOBS, prefix_cache=True),
                    prompts=prompts)
    two, m = _serve(work, ServeConfig(**KNOBS, prefix_cache=True,
                                      shards=2), prompts=prompts)
    assert two == one
    assert m["prefix_hits"] >= 1 and m["cow_copies"] >= 1


def test_devices_and_mesh(monkeypatch, workload):
    monkeypatch.delenv(hostdev.FORCE_ENV, raising=False)
    assert hostdev.device_list("cpu") == [torch.device("cpu")]
    monkeypatch.setenv(hostdev.FORCE_ENV, "3")
    assert hostdev.device_list("cpu") == [torch.device("cpu")] * 3
    mesh = make_serving_mesh(2, ["cpu", "cpu"])
    assert mesh.shape == {"data": 1, "model": 2}
    with pytest.raises(ValueError, match="exactly 2"):
        make_serving_mesh(2, ["cpu"])
    monkeypatch.delenv(hostdev.FORCE_ENV)
    with pytest.raises(ValueError, match=hostdev.FORCE_ENV):
        ServeEngine(workload["params"], workload["cfg"],
                    ServeConfig(**KNOBS, shards=2), rt=_rt(False))
    # explicit devices need no env
    eng = ServeEngine(workload["params"], workload["cfg"],
                      ServeConfig(**KNOBS, shards=2), rt=_rt(False),
                      devices=["cpu", "cpu"])
    assert eng.rt.mesh.size == 2 and len(eng.caches) == 2


def test_other_patterns_raise_naming_the_roadmap():
    """Every pattern resolves at shards=2, and the cuts the port refused
    before resolve at the reference's widths (qwen2-vl-2b's 2 KV heads at
    4 shards computed whole on each, olmoe's 64 experts and a vocabulary
    and d_model that do not split at 3, unevenly). What raised before and
    runs now: a training loss under a serving mesh runs tensor-parallel
    over its shards and equals the one-device loss, and a train shape
    handed to ``build_serve_step`` points to ``build_train_step``, which
    takes it."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import build_serve_step, build_step
    for arch in ("olmoe-1b-7b", "xlstm-350m", "jamba-1.5-large-398b",
                 "whisper-small"):
        assert ServeConfig(shards=2).resolve(
            reduced(get_config(arch))).shards == 2
    qwen = get_config("qwen2-vl-2b")
    assert ShardingPolicy(qwen, make_serving_mesh(4, ["meta"] * 4)) \
        .serving_cut(["stack", "slots", "0", "attn", "wk", "w"],
                     (qwen.n_periods, qwen.d_model,
                      qwen.n_kv_heads * qwen.dh)) is None
    olmoe = get_config("olmoe-1b-7b")
    three = ShardingPolicy(olmoe, make_serving_mesh(3, ["meta"] * 3))
    assert three.serving_cut(
        ["stack", "slots", "0", "moe", "gate"],
        (olmoe.n_periods, 64, olmoe.d_model, olmoe.d_ff)) == \
        (1, ((0, 22), (22, 21), (43, 21)))
    assert three.serving_cut(["embed", "table"], (50305, 2050)) == \
        (0, ((0, 16769), (16769, 16768), (33537, 16768)))
    cfg = dataclasses.replace(reduced(get_config("gemma-2b")), vocab_size=32)
    params = lm_mod.lm_init(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    batch = {"tokens": torch.arange(8, dtype=torch.int32).reshape(2, 4),
             "labels": torch.arange(8, dtype=torch.int32).reshape(2, 4)}
    mesh = make_serving_mesh(2, ["cpu", "cpu"])
    pol = ShardingPolicy(cfg, mesh)
    from repro_torch.sharding import shard_params
    got, gm = lm_mod.lm_loss(shard_params(params, pol, mesh), batch, cfg,
                             Runtime(device="cpu", mesh=mesh))
    want, wm = lm_mod.lm_loss(params, batch, cfg, Runtime(device="cpu"))
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))
    assert set(gm) == set(wm)
    with pytest.raises(ValueError, match="build_train_step"):
        build_serve_step(cfg, ShapeConfig("t", 8, 2, "train"),
                         make_host_mesh(1, 2, ["cpu", "cpu"]))
    assert build_step(cfg, ShapeConfig("t", 8, 2, "train"),
                      make_host_mesh(1, 2, ["cpu", "cpu"]),
                      dtype=torch.float32).meta["kind"] == "train"


#: the widths the port once refused, each at a reduced config that keeps
#: the reason: qwen2-vl-2b's 12 query heads over 2 KV heads (4 shards: 3
#: heads each, both KV heads computed whole and the pools replicated),
#: whisper-small's 12 heads at 8 shards (groups of 2, 2, 2, 2, 1, 1, 1,
#: 1), olmoe-1b-7b at 3 (8 experts as 3, 3, 2; 4 heads as 2, 1, 1; a
#: vocabulary of 512 and d_model 64, neither divisible by 3: the table
#: and head cut unevenly) and gemma-2b with a vocabulary of 515 at 3 (sp2_4
#: FFN columns cut on even boundaries as 44, 42, 42). arch -> (shards,
#: layers, vocab, weights, replaced fields)
WIDTHS = {
    "qwen2-vl-2b": (4, 2, 512, "sp2_4",
                    dict(n_heads=12, n_kv_heads=2, head_dim=32)),
    "whisper-small": (8, 2, 513, None,
                      dict(n_heads=12, n_kv_heads=12, head_dim=16)),
    "olmoe-1b-7b": (3, 2, 512, "sp2_4", {}),
    "gemma-2b": (3, 1, 515, "sp2_4", {}),
}


@pytest.mark.parametrize("arch", list(WIDTHS))
def test_uneven_widths_match_reference(monkeypatch, arch):
    """Each of WIDTHS served by the port's paged engine at its width
    (``REPRO_FORCE_DEVICE_COUNT``): the reference's one-device greedy
    tokens, the bills a shard count does not change equal to the
    reference's, one shard's bills equal to the reference's planner at
    that width, the shards' head groups as ``planner.shard_heads`` cuts
    them, and no kernel launched (CPU tensors)."""
    shards, layers, vocab, weights, fields = WIDTHS[arch]
    monkeypatch.setenv(hostdev.FORCE_ENV, str(shards))
    jcfg = dataclasses.replace(jreduced(jget_config(arch), n_layers=layers,
                                        vocab=vocab), **fields)
    cfg = dataclasses.replace(reduced(get_config(arch), n_layers=layers,
                                      vocab=vocab), **fields)
    jp = (jed.encdec_init if jcfg.enc_dec else jlm.lm_init)(
        jax.random.PRNGKey(1), jcfg)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, vocab, n).astype(np.int32)
               for n in FAMILY_LENS]
    frames = _family_frames(jcfg, len(prompts))
    jeng = JServeEngine(jp, jcfg, JServeConfig(**FAMILY_KNOBS,
                                               quantize=weights),
                        rt=JRuntime(impl="ref", q_chunk=16))
    ops.reset_op_calls()
    eng = ServeEngine(params_from_reference(jp), cfg,
                      ServeConfig(**FAMILY_KNOBS, quantize=weights,
                                  shards=shards), rt=_rt(False))
    for e, req in ((jeng, JRequest), (eng, Request)):
        for i, (p, f) in enumerate(zip(prompts, frames)):
            e.submit(req(rid=i, prompt=p, max_new_tokens=FAMILY_NEW,
                         frames=f))
    want = {r.rid: list(r.output) for r in jeng.run()}
    assert {r.rid: list(r.output) for r in eng.run()} == want
    assert ops.op_calls() == {}
    m, jm = eng.metrics(), jeng.metrics()
    assert m["shards"] == shards
    for key in SHARED_BILLS:
        assert m.get(key) == jm.get(key), key
    dcfg = jeng._decode_cfg
    budget = jplanner.plan_shard_budget(
        dcfg.n_kv_heads, dcfg.dh, shards=shards, page_size=jm["page_size"],
        n_pages=jm["n_pages"], n_layers=jeng._paged_layers(),
        slab_bytes=jm["slab_bytes_per_seq"],
        act_bytes=jeng.kv_cache_dtype.itemsize, kv_scheme=None)
    assert (m["kv_sharded"], m["kv_heads_per_shard"],
            m["pool_bytes_per_shard"]) == (
        budget.kv_sharded, budget.kv_heads_per_shard, budget.pool_bytes)
    groups = planner.shard_heads(cfg.n_heads, cfg.n_kv_heads, shards)
    stack = "dec_stack" if cfg.enc_dec else "stack"
    for g, p in zip(groups, eng.params):
        attn = p[stack]["slots"][0]["attn"]
        assert attn["wq"]["w"].shape[-1] == g.nq * cfg.dh
        assert attn["wo"]["w"].shape[-2] == g.nq * cfg.dh
        assert attn["wk"]["w"].shape[-1] == cfg.dh * (
            g.nkv if m["kv_sharded"] else cfg.n_kv_heads)
    assert sum(p["embed"]["table"].numel() for p in eng.params) == \
        cfg.vocab_size * cfg.d_model


# -- the policy against the reference's ----------------------------------------

def _port_tree(sds):
    """A reference ShapeDtypeStruct pytree as the port's params: meta
    tensors, QuantizedTensors of meta codes and scales."""
    if isinstance(sds, dict):
        return {k: _port_tree(v) for k, v in sds.items()}
    if isinstance(sds, (list, tuple)):
        return [_port_tree(v) for v in sds]
    if hasattr(sds, "codes"):
        return QuantizedTensor(_port_tree(sds.codes), _port_tree(sds.scale),
                               sds.scheme, sds.packed)
    return torch.empty(tuple(sds.shape), device="meta")


def _key(k) -> str:
    if type(k).__name__ == "FlattenedIndexKey":
        # a reference QuantizedTensor's children: codes, then scale
        return ("codes", "scale")[k.key]
    for attr in ("key", "name", "idx"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    raise TypeError(k)


def _jax_flat(specs) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {tuple(_key(k) for k in path): tuple(spec)
            for path, spec in leaves}


def _port_flat(specs, path=()) -> dict:
    if isinstance(specs, dict):
        return {k: v for key, sub in specs.items()
                for k, v in _port_flat(sub, path + (str(key),)).items()}
    if isinstance(specs, list):
        return {k: v for i, sub in enumerate(specs)
                for k, v in _port_flat(sub, path + (str(i),)).items()}
    return {path: specs}


class _Leaf:
    def __init__(self, shape):
        self.shape = shape


def _pools(hkv, dh, leaf):
    return [{"kp": leaf((2, 8, hkv, 8, dh)), "vp": leaf((2, 8, hkv, 8, dh)),
             "slab": leaf((2, 4, dh))},
            {"kp": {"codes": leaf((2, 8, hkv, 8, dh)),
                    "scale": leaf((2, 8, hkv, 8, 1))},
             "vp": {"codes": leaf((2, 8, hkv, 8, dh)),
                    "scale": leaf((2, 8, hkv, 8, 1))},
             "xk": leaf((2, 2, hkv, 16, dh))}]


@pytest.fixture(scope="module")
def param_shapes():
    """Every bundled config's params, plain and sp2_4-quantized, as the
    reference's shapes and as the port's meta tensors."""
    out = {}
    for arch in assigned_archs():
        for quantized in (False, True):
            sds = _params_sds(jget_config(arch), jnp.float32,
                              quantized=quantized)
            out[arch, quantized] = (sds, _port_tree(sds))
    return out


def _port_leaves(tree, path=()):
    """(path, leaf) of a port param tree, a QuantizedTensor one leaf."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _port_leaves(v, path + (str(k),))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _port_leaves(v, path + (str(i),))
    else:
        yield path, tree


#: the recurrent mixers, whose leaves the port keeps whole on every shard
RECURRENT = {"mamba", "mlstm", "slstm"}


@pytest.mark.parametrize("width", [2, 4, 8])
def test_serving_cut_is_the_reference_tp_spec(param_shapes, width):
    """``serving_cut``'s dim against the JAX tp policy (fsdp off, as the
    reference's serving engine builds it), leaf for leaf of every bundled
    config, plain and sp2_4 (a QuantizedTensor: the dim of its logical
    shape against the spec of its codes, and a column or expert cut of its
    scales against theirs). The two rules differ only where the port's
    forward forces it, each departure named: K/V projections whose KV
    heads do not split are computed whole on every shard (the reference
    may cut gemma-2b's one KV head, qwen2-vl-2b's two at 4 and 8 shards,
    whisper-small's twelve at 8), the bias of a column-parallel
    projection is cut with its heads (the reference replicates it: any
    placement is correct under GSPMD), a recurrent mixer's projections
    stay whole (the mixer runs whole on every shard against replicated
    slabs, where GSPMD cuts them by columns and rows). Where the heads do
    not divide the port cuts the same dim in head groups (GSPMD pads);
    no leaf is refused at any width. The MoE's experts, its router, the
    d-cut table and head of a vocabulary that does not split (whisper-small,
    granite-3-8b) and the encoder's leaves agree with the reference. Then
    ``pool_spec`` against the reference's ``paged_state_specs`` for every
    config, and the engine's per-shard pools follow it."""
    mesh = types.SimpleNamespace(shape={"data": 1, "model": width})
    agree, whole_kv, bias_cut, whole_recurrent, refused = 0, [], [], [], []
    cut = set()
    for (arch, quantized), (sds, tree) in param_shapes.items():
        jcfg, cfg = jget_config(arch), get_config(arch)
        pol = ShardingPolicy(cfg, mesh)
        want = _jax_flat(JShardingPolicy(jcfg, mesh, fsdp=False,
                                         parallelism="tp").param_specs(sds))
        for path, leaf in _port_leaves(tree):
            qt = isinstance(leaf, QuantizedTensor)
            shape = leaf.logical_shape if qt else tuple(leaf.shape)
            try:
                leaf_cut = pol.serving_cut(list(path), shape)
                dim = None if leaf_cut is None else leaf_cut[0]
            except NotImplementedError:
                refused.append((arch, path))
                continue
            got = tuple("model" if d == dim else None
                        for d in range(len(shape)))
            ref = want[path + ("codes",) if qt else path]
            if got != ref and path[-1] == "b" and not RECURRENT & set(path):
                assert dim == len(shape) - 1 and not any(ref), \
                    (arch, quantized, path, got, ref)
                bias_cut.append((arch, path))
                continue
            if got != ref and RECURRENT & set(path):
                assert dim is None, (arch, quantized, path, got, ref)
                whole_recurrent.append((arch, path))
                continue
            if got != ref:
                assert path[-2] in ("wk", "wv") and dim is None \
                    and not pol.kv_sharded, \
                    (arch, quantized, path, got, ref)
                whole_kv.append((arch, path))
                continue
            agree += 1
            if dim is not None:
                cut.add((arch, path[-2] if path[-1] in ("w", "b")
                         else path[-1]))
            if qt and dim is not None and dim != len(shape) - 2:
                assert want[path + ("scale",)] == got, (arch, path)
        hkv, dh = cfg.n_kv_heads, cfg.dh
        jpol = JShardingPolicy(jcfg, mesh, fsdp=False, parallelism="tp")
        want = _jax_flat(jpol.paged_state_specs(_pools(hkv, dh, _Leaf)))
        assert {path: pol.pool_spec(list(path), shape) for path, shape in (
            (p, leaf.shape) for p, leaf in _port_leaves(
                _pools(hkv, dh, _Leaf)))} == want, (arch, width, "pools")
        spec = want[("0", "kp")]
        assert (spec[2] == "model") is pol.kv_sharded
        # the engine's per-shard pools follow the spec
        pools = shard_paged_state(
            [{"kp": torch.zeros((1, 2, hkv, 1, 1))}], pol,
            make_serving_mesh(width, ["cpu"] * width))
        assert pools[0][0]["kp"].shape[2] == (hkv // width if spec[2]
                                              else hkv)
    # every config has leaves the rules cut alike; gemma-2b's one KV head,
    # qwen2-vl-2b's q/k/v biases and the recurrent projections are where
    # they part
    assert agree > 300
    assert ("gemma-2b", ("stack", "slots", "0", "attn", "wk", "w")) \
        in whole_kv
    assert ("qwen2-vl-2b", ("stack", "slots", "0", "attn", "wq", "b")) \
        in bias_cut
    for arch, mixer, proj in (("xlstm-350m", "mlstm", "in_proj"),
                              ("xlstm-350m", "slstm", "w_in"),
                              ("jamba-1.5-large-398b", "mamba", "in_proj")):
        assert any(a == arch and mixer in p and proj in p
                   for a, p in whole_recurrent), (arch, mixer, proj)
    # the experts, the shared expert and the odd vocabularies' d cut are
    # the reference's
    for arch, leaf in (("olmoe-1b-7b", "gate"), ("kimi-k2-1t-a32b", "up"),
                       ("whisper-small", "table"), ("whisper-small", "head"),
                       ("granite-3-8b", "table"), ("granite-3-8b", "head")):
        assert (arch, leaf) in cut, (arch, leaf)
    # every bundled config cuts whole at every width
    assert not refused, refused[:5]


def test_shard_budget_equals_reference():
    fields = ("shards", "kv_sharded", "kv_heads_per_shard", "page_bytes",
              "pool_bytes", "slab_bytes")
    for arch in assigned_archs():
        cfg = get_config(arch)
        for shards in (1, 2, 4, 8):
            for kv_scheme in (None, "spx_8_x3", "uniform8"):
                for act_bytes in (2, 4):
                    kw = dict(shards=shards, page_size=16, n_pages=37,
                              n_layers=cfg.n_periods, slab_bytes=4096,
                              act_bytes=act_bytes, kv_scheme=kv_scheme)
                    got = planner.plan_shard_budget(cfg.n_kv_heads, cfg.dh,
                                                    **kw)
                    want = jplanner.plan_shard_budget(cfg.n_kv_heads,
                                                      cfg.dh, **kw)
                    assert [getattr(got, f) for f in fields] == \
                        [getattr(want, f) for f in fields], (arch, kw)
    with pytest.raises(ValueError, match="shards"):
        planner.plan_shard_budget(1, 128, shards=0, page_size=8, n_pages=1)


# -- metrics: the reference's keys and per-shard values -------------------------

@pytest.mark.parametrize("layout,pages", [("paged", "float32"),
                                          ("paged", "bfloat16"),
                                          ("paged", "spx_8_x3"),
                                          ("dense", "float32")])
def test_metric_keys_and_shard_values_are_the_references(workload, layout,
                                                         pages):
    kvq = pages == "spx_8_x3"
    dtype = "float32" if kvq else pages
    knobs = dict(batch_slots=2, max_seq=64, quantize=None, kv_layout=layout)
    if layout == "paged":
        knobs["page_size"] = 8
    jeng = JServeEngine(
        workload["jparams"], _cfg(jget_config, jreduced),
        JServeConfig(**knobs, kv_cache_dtype=getattr(jnp, dtype)),
        rt=JRuntime(impl="ref", q_chunk=16, kv_quant=kvq,
                    kv_scheme="spx_8_x3"))
    eng = ServeEngine(workload["params"], workload["cfg"],
                      ServeConfig(**knobs, kv_cache_dtype=dtype), rt=_rt(kvq))
    for e, req in ((jeng, JRequest), (eng, Request)):
        e.submit(req(rid=0, prompt=workload["prompts"][2], max_new_tokens=2))
        e.run()
    jm, m = jeng.metrics(), eng.metrics()
    assert set(m) == set(jm) | {"device"}
    for key in ("shards", "kv_sharded", "kv_heads_per_shard",
                "pool_bytes_per_shard", "peak_kv_bytes_per_shard",
                "peak_kv_bytes", "kv_cache_dtype"):
        assert m.get(key) == jm.get(key), key


# -- the train step's storage: the reference's param and optimizer specs -------

def _drop_model(spec) -> tuple:
    return tuple(None if e == "model" else e for e in spec)


@pytest.mark.parametrize("parallelism", ["fsdp", "tp"])
def test_train_specs_are_the_references(param_shapes, parallelism):
    """``param_specs`` and ``opt_specs`` (AdamW's moments, AdamW-Q8's codes
    and per-row scales) against the reference's at mesh (2, 4), leaf for
    leaf of every bundled config, under ``fsdp`` and under ``tp`` with
    FSDP over data. Under fsdp they are equal everywhere. Under tp the
    FSDP axis is the reference's on every leaf, and the model axis departs
    only where the port's forward cuts otherwise
    (``test_serving_cut_is_the_reference_tp_spec``), each departure named:
    K/V projections whose KV heads do not split stay whole over model
    (gemma-2b, qwen2-vl-2b), q/k/v biases are cut with their heads
    (qwen2-vl-2b, qwen2.5-14b), recurrent mixers stay whole (xlstm-350m,
    jamba)."""
    mesh = types.SimpleNamespace(shape={"data": 2, "model": 4})
    agree, whole_kv, bias_cut, whole_recurrent = 0, set(), set(), set()
    for (arch, quantized), (sds, tree) in param_shapes.items():
        if quantized:
            continue
        kw = dict(parallelism=parallelism, fsdp=True)
        jpol = JShardingPolicy(jget_config(arch), mesh, **kw)
        pol = ShardingPolicy(get_config(arch), mesh, **kw)
        pairs = [(_jax_flat(jpol.param_specs(sds)), pol.param_specs(tree))]
        for name in ("adamw", "adamw_q8"):
            jst = jax.eval_shape(jtr.make_optimizer(name, lr=1e-4).init, sds)
            pairs.append((_jax_flat(jpol.opt_specs(sds, jst)),
                          pol.opt_specs(ttr.make_optimizer(
                              name, lr=1e-4).init(tree))))
        for want, got in pairs:
            got = {tuple(map(str, k)): v for k, v in got.items()}
            assert set(got) == set(want), arch
            for path, ref in want.items():
                spec = got[path]
                if spec == ref:
                    agree += 1
                    continue
                assert parallelism == "tp", (arch, path, spec, ref)
                names = set(path)
                leaf = path[-3] if path[-1] == "codes" else path[-2]
                if "b" in (path[-1], path[-2]) and not any(ref):
                    assert _drop_model(spec) == ref, (arch, path)
                    bias_cut.add((arch, leaf))
                elif names & RECURRENT:
                    assert spec == _drop_model(ref), (arch, path)
                    whole_recurrent.add((arch, leaf))
                else:
                    assert leaf in ("wk", "wv") and spec == _drop_model(ref) \
                        and not pol.kv_sharded, (arch, path, spec, ref)
                    whole_kv.add((arch, leaf))
    assert agree > 1000
    if parallelism == "tp":
        assert whole_kv == {(a, p) for a in ("gemma-2b", "qwen2-vl-2b")
                            for p in ("wk", "wv")}
        assert {a for a, _ in bias_cut} == {"qwen2-vl-2b", "qwen2.5-14b"}
        assert {a for a, _ in whole_recurrent} == {"xlstm-350m",
                                                   "jamba-1.5-large-398b"}


def test_policy_specs_divisible():
    """The reference's ``test_policy_specs_divisible`` on the port's
    ``make_policy`` (tp, FSDP by size) at mesh (2, 4): every block of
    every leaf of granite-3-8b, kimi-k2-1t-a32b and jamba-1.5-large-398b
    (on ``meta``) is the same size, each cut dividing its dim."""
    from repro_torch.sharding import make_policy
    mesh = types.SimpleNamespace(shape={"data": 2, "model": 4})
    for arch in ("granite-3-8b", "kimi-k2-1t-a32b", "jamba-1.5-large-398b"):
        cfg = get_config(arch)
        params = lm_mod.lm_init(torch.Generator(), cfg, device="meta")
        pol = make_policy(cfg, mesh)
        assert pol.fsdp
        for path, lay in pol.param_layouts(params).items():
            for dim, (entry, ranges) in enumerate(zip(lay.spec, lay.ranges)):
                if entry is None:
                    continue
                n = 1
                for a in (entry if isinstance(entry, tuple) else (entry,)):
                    n *= mesh.shape[a]
                assert lay.shape[dim] % n == 0, (arch, path, lay)
                assert {size for _, size in ranges} == \
                    {lay.shape[dim] // n}, (arch, path)


@pytest.mark.parametrize("name,parallelism,sliced", [
    ("adamw", "fsdp", False), ("adamw_q8", "fsdp", False),
    ("adamw_q8", "fsdp", True), ("adamw_q8", "tp", False)],
    ids=["adamw-fsdp", "q8-fsdp", "q8-fsdp-sliced", "q8-tp"])
def test_sharded_optimizers_match_one_device(monkeypatch, name, parallelism,
                                             sliced):
    """The same gradients, cut into the train step's blocks at mesh (2, 4)
    by ``param_specs``/``opt_specs``, through ``update_blocks`` over three
    steps against ``update`` on the whole trees (reduced gemma-2b): params
    within UPDATE_RTOL of each leaf's largest update (they are equal), and
    AdamW-Q8's codes and scales bit-equal: each block's rows take the max
    over the whole last dim, which FSDP cuts (the FFN's 128 columns over 8
    devices), so every block quantizes the one-device values. ``sliced``:
    the per-slice update of large stacked leaves, threshold lowered."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding import (gather_blocks, make_policy,
                                      place_blocks)
    from repro_torch.training import optimizer as topt
    if sliced:
        monkeypatch.setattr(topt, "_SLICE_ABOVE", 0)
    cfg = reduced(get_config("gemma-2b"), d_model=64, vocab=512, n_layers=2)
    mesh = make_host_mesh(2, 4, ["cpu"] * 8)
    pol = make_policy(cfg, mesh, parallelism=parallelism, fsdp=True)
    params = lm_mod.lm_init(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    opt = ttr.make_optimizer(name, lr=1e-2, weight_decay=0.01)
    p_lay = pol.param_layouts(params)
    state = opt.init(params)
    o_lay = pol.opt_layouts(state)
    assert any(lay.spec[-1] is not None for lay in p_lay.values())
    grid = [t for row in place_blocks(params, p_lay, mesh) for t in row]
    ostate = [t for row in place_blocks(state, o_lay, mesh) for t in row]
    whole = tree_map(lambda _, x: x.clone(), params)
    gen = torch.Generator().manual_seed(1)

    def where(path, k):
        lay = o_lay[path]
        return lay.index(k // 4, k % 4, mesh.shape), lay.shape
    for _ in range(3):
        grads = tree_map(
            lambda _, p: torch.randn(p.shape, generator=gen) * 1e-2, params)
        before = tree_map(lambda _, x: x.clone(), whole)
        whole, state = opt.update(whole, grads, state)
        gblocks = [t for row in place_blocks(grads, p_lay, mesh)
                   for t in row]
        grid, ostate = opt.update_blocks(grid, gblocks, ostate, where)
    got = gather_blocks([grid[:4], grid[4:]], p_lay, mesh)
    for g, w, b in zip(tree_leaves(got), tree_leaves(whole),
                       tree_leaves(before)):
        tol = 1e-5 * (w - b).abs().max() + torch.finfo(torch.float32).eps
        assert (g - w).abs().max() <= tol
    got_state = gather_blocks([ostate[:4], ostate[4:]], o_lay, mesh)
    assert got_state["step"] == state["step"] == 3
    for g, w in zip(tree_leaves(got_state), tree_leaves(state)):
        if isinstance(w, torch.Tensor):
            assert torch.equal(g, w) if name == "adamw_q8" else \
                (g - w).abs().max() <= 1e-6 * max(w.abs().max(), 1e-30)


# -- the train step's tensor-parallel paths against the reference -------------

def _one_by_one():
    return jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))


def _train_batch(cfg, b, s=32, seed=0):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
            for k in ("tokens", "labels")}


def test_giant_path_matches_reference(monkeypatch):
    """``GIANT_PARAMS`` patched to 0 in both packages, reduced granite-3-8b
    at batch 16: the reference's meta (``tp``, ``adamw_q8``) and the port's
    8 microbatches of 2 rows (one per data group) with bf16 gradient
    accumulators; the loss, ce and z within LOSS_RTOL of the reference's
    step on a 1x1 mesh."""
    from repro.configs.base import ShapeConfig as JShapeConfig
    from repro.launch import steps as jsteps
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import steps as tsteps
    from repro_torch.launch.mesh import make_host_mesh
    monkeypatch.setattr(jsteps, "GIANT_PARAMS", 0)
    monkeypatch.setattr(tsteps, "GIANT_PARAMS", 0)
    jcfg = jreduced(jget_config("granite-3-8b"), d_model=64, vocab=512)
    cfg = reduced(get_config("granite-3-8b"), d_model=64, vocab=512)
    jp = jlm.lm_init(jax.random.PRNGKey(0), jcfg)
    batch = _train_batch(cfg, 16)
    mesh = _one_by_one()
    jb = jsteps.build_train_step(jcfg, JShapeConfig("t", 32, 16, "train"),
                                 mesh, dtype=jnp.float32)
    with mesh:
        _, _, jm = jax.jit(jb.fn)(
            jp, jtr.make_optimizer("adamw_q8", lr=1e-4).init(jp),
            {k: jnp.asarray(v) for k, v in batch.items()})
    b = tsteps.build_train_step(cfg, ShapeConfig("t", 32, 16, "train"),
                                make_host_mesh(2, 4, ["cpu"] * 8),
                                dtype=torch.float32)
    assert {k: b.meta[k] for k in jb.meta} == jb.meta
    assert (b.meta["parallelism"], b.meta["optimizer"],
            b.meta["accum_steps"], b.meta["accum_dtype"]) == \
        ("tp", "adamw_q8", 8, "bfloat16")
    seen = []
    clip = tsteps._clip_blocks

    def spy(grads, *a):
        seen.extend({g.dtype for g in tree_leaves(grads)})
        return clip(grads, *a)
    monkeypatch.setattr(tsteps, "_clip_blocks", spy)
    grid, opt = b.place(params_from_reference(jp))
    _, _, m = b.fn(grid, opt, {k: torch.as_tensor(v)
                               for k, v in batch.items()})
    assert set(seen) == {torch.bfloat16}
    for k in ("loss", "ce", "z"):
        assert abs(float(m[k]) - float(jm[k])) <= 1e-5 * abs(float(jm[k])), k


def test_moe_aux_under_tp_is_the_references():
    """olmoe-1b-7b (reduced) under ``tp`` at mesh (2, 4), batch 4 (rows do
    not cover 8 devices): each data group routes its own 2 rows over its 4
    shards' experts. The reference (measured on an 8-device host mesh:
    ``repro.nn.moe``'s ``shard_map`` with ``out_specs=P()`` and
    ``check_vma=False``) reports group 0's aux loss, and its gradient is
    the mean of the two groups' (the router's gradient within 7e-7 of
    it). Pinned here against the reference's one-device functions: aux
    and the loss as group 0's, ce and z over the whole batch (LOSS_RTOL),
    and the SGD update of the router as the one from ce + z + the mean aux
    (GRAD_RTOL of its largest), which the global aux's gradient misses."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import build_train_step
    jcfg = jreduced(jget_config("olmoe-1b-7b"), d_model=64, vocab=512)
    cfg = reduced(get_config("olmoe-1b-7b"), d_model=64, vocab=512)
    jp = jlm.lm_init(jax.random.PRNGKey(0), jcfg)
    batch = _train_batch(cfg, 4, seed=2)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jrt = JRuntime(impl="ref")
    halves = [{k: v[sl] for k, v in jb.items()}
              for sl in (slice(0, 2), slice(2, 4))]

    def parts(p):
        """ce + z over the batch (one term: the loss head rounds its
        cotangents to bf16), the whole batch's aux, each half's."""
        _, m = jlm.lm_loss(p, jb, jcfg, jrt)
        return jnp.stack([m["ce"] + jlm.Z_WEIGHT * m["z"], m["aux"]]
                         + [jlm.lm_loss(p, h, jcfg, jrt)[1]["aux"]
                            for h in halves]), m
    (values, whole), jac = jax.jit(lambda p: (
        parts(p), jax.jacrev(lambda q: parts(q)[0])(p)))(jp)

    def objective(weights):
        """The SGD update of the router from the gradient of ``weights``
        . parts, clipped over every leaf."""
        g = jax.tree_util.tree_map(
            lambda j: jnp.tensordot(jnp.asarray(weights, jnp.float32), j,
                                    axes=1), jac)
        g, _ = jtr.clip_by_global_norm(g, 1.0)
        return -1e-4 * np.asarray(
            g["stack"]["slots"][0]["moe"]["router"]["w"])
    ce, z, aux0 = float(whole["ce"]), float(whole["z"]), float(values[2])
    b = build_train_step(cfg, ShapeConfig("t", 32, 4, "train"),
                         make_host_mesh(2, 4, ["cpu"] * 8), optimizer="sgd",
                         dtype=torch.float32)
    assert b.meta["parallelism"] == "tp"
    grid, opt = b.place(params_from_reference(jp))
    grid, _, m = b.fn(grid, opt, {k: torch.as_tensor(v)
                                  for k, v in batch.items()})
    want_loss = ce + jlm.Z_WEIGHT * z + jlm.AUX_WEIGHT * aux0
    for got, want in ((m["aux"], aux0), (m["ce"], ce), (m["z"], z),
                      (m["loss"], want_loss)):
        assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))
    old = np.asarray(jp["stack"]["slots"][0]["moe"]["router"]["w"])
    new = b.gather(grid)["stack"]["slots"][0]["moe"]["router"]["w"].numpy()
    a = jlm.AUX_WEIGHT
    want = objective([1.0, 0.0, a / 2, a / 2])
    tol = GRAD_RTOL_MESH * np.abs(want).max() + np.spacing(np.abs(new))
    assert (np.abs((new - old) - want) <= tol).all()
    assert (np.abs(objective([1.0, a, 0.0, 0.0]) - want) > tol).any()


#: an update's gradient against one device's (f32 sums in other orders)
GRAD_RTOL_MESH = 1e-4
