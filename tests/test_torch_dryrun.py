"""The dry run (``repro_torch.launch.dryrun``) and what it reads, against
the reference.

* The serve step stores its weights as the reference's ``make_policy``
  cuts its quantized params (FSDP over data above 2e9 params), at mesh
  (2, 4) and on both production meshes, for every assigned arch; the
  train step's ``param_specs``/``opt_specs`` under fsdp and tp and the
  caches' ``cache_specs`` on the production meshes (the pod axis, the
  100e9 pod FSDP rule), and ``make_runtime``'s data axes for every
  ``LM_SHAPES`` entry. The departures allowed are the ones ROADMAP Queue
  3 names.
* More model shards than query heads: the shared-head cut serves the
  reference's greedy tokens (paged engine) and logits (the serve step).
* The dry report: its per-device params, optimizer-state and cache bytes
  against XLA's ``memory_analysis`` of the reference's compiled steps
  (an 8-device subprocess), its flops against the reference's matmuls
  (``jax.make_jaxpr``), a meta run against the same run on the CPU, and
  the CLI's artifact.
"""
import dataclasses
import json
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import assigned_archs
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.configs.base import LM_SHAPES as JLM_SHAPES
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.launch import steps as jsteps
from repro.launch.steps import _caches_sds, _params_sds
from repro.models import lm as jlm
from repro.runtime import Runtime as JRuntime
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServeConfig as JServeConfig
from repro.serving.engine import ServeEngine as JServeEngine
from repro.sharding import make_policy as jmake_policy
from repro import training as jtr
from repro_torch import training as ttr
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import LM_SHAPES, ShapeConfig
from repro_torch.core.quantized import QuantizedTensor
from repro_torch.interop import params_from_reference
from repro_torch.launch import dryrun, hostdev, steps
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import encdec as ted
from repro_torch.models import lm as lm_mod
from repro_torch.nn.layers import tree_leaves
from repro_torch.runtime import Runtime, planner
from repro_torch.serving import Request, ServeConfig, ServeEngine
from repro_torch.sharding import make_policy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the meshes the spec tests hold: the serve steps' test mesh and the
#: reference's production meshes (repro/launch/mesh.py)
SMALL = {"data": 2, "model": 4}
SINGLE = {"data": 16, "model": 16}
MULTI = {"pod": 2, "data": 16, "model": 16}
#: the recurrent mixers, whose leaves the port keeps whole on every shard
RECURRENT = {"mamba", "mlstm", "slstm"}
#: the training tests' bounds (tests/test_torch_training.py)
GRAD_RTOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small shapes, where torch's intra-op threads mostly spin: one
    thread for this file's tests (the suite's workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _fresh_jax_caches():
    yield
    jax.clear_caches()


def _mesh(shape: dict):
    return types.SimpleNamespace(shape=dict(shape))


# -- the reference's pytrees as the port's --------------------------------------

def _port_tree(sds):
    """A reference ShapeDtypeStruct pytree as the port's: meta tensors,
    QuantizedTensors of meta codes and scales."""
    if isinstance(sds, dict):
        return {k: _port_tree(v) for k, v in sds.items()}
    if isinstance(sds, (list, tuple)):
        return [_port_tree(v) for v in sds]
    if hasattr(sds, "codes"):
        return QuantizedTensor(_port_tree(sds.codes), _port_tree(sds.scale),
                               sds.scheme, sds.packed)
    return torch.empty(tuple(sds.shape), device="meta",
                       dtype=getattr(torch, jnp.dtype(sds.dtype).name))


def _key(k) -> str:
    if type(k).__name__ == "FlattenedIndexKey":
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


def _str_keys(d: dict) -> dict:
    return {tuple(map(str, k)): v for k, v in d.items()}


def _drop_model(spec) -> tuple:
    """``spec`` without the model axis (a tuple entry keeps its others)."""
    out = []
    for e in spec:
        if isinstance(e, tuple):
            rest = tuple(a for a in e if a != "model")
            e = rest if len(rest) > 1 else (rest[0] if rest else None)
        out.append(None if e == "model" else e)
    return tuple(out)


def _departure(path: tuple, spec: tuple, ref: tuple, pol) -> str:
    """The named departure (ROADMAP Queue 3) a port spec differing from the
    reference's is, or fail: K/V whose heads do not split computed whole,
    q/k/v biases cut with their heads, recurrent mixers whole, a row cut
    keeping every scale."""
    names = set(path)
    if names & RECURRENT:
        assert spec == _drop_model(ref), (path, spec, ref)
        return "recurrent whole"
    if "b" in path[-2:] and not any(ref):
        assert _drop_model(spec) == ref, (path, spec, ref)
        return "bias cut"
    proj = next(k for k in reversed(path) if k not in ("w", "codes",
                                                       "scale", "0", "1"))
    if proj in ("wk", "wv") and not pol.kv_sharded:
        assert spec == _drop_model(ref), (path, spec, ref)
        return "kv whole"
    assert path[-1] == "scale" and proj in ("wo", "down") \
        and spec == _drop_model(ref), (path, spec, ref)
    return "row-cut scale"


# -- the serve step's storage ----------------------------------------------------

@pytest.fixture(scope="module")
def quantized_shapes():
    """Every assigned arch's sp2_4 params, as the reference's shapes and as
    the port's meta tensors."""
    out = {}
    for arch in assigned_archs():
        sds = _params_sds(jget_config(arch), jnp.bfloat16, quantized=True)
        out[arch] = (sds, _port_tree(sds))
    return out


@pytest.mark.parametrize("shape", [SMALL, SINGLE, MULTI],
                         ids=["2x4", "16x16", "2x16x16"])
def test_serve_step_specs_are_the_references(quantized_shapes, shape):
    """The serve step's stored layouts (``ShardingPolicy.stored_layouts``
    under ``make_policy``, as ``build_serve_step`` places them) against
    the reference's ``make_policy(cfg, mesh).param_specs`` of its sp2_4
    params, leaf for leaf (codes and scales apart), for every assigned
    arch: equal but at the named departures; gemma-2b's ``wq`` codes at
    (2, 4) are ``(None, "data", "model")``; no leaf raises at a model axis
    of 16, gemma-2b's 8, qwen2-vl-2b's and whisper-small's 12 query heads
    included."""
    mesh = _mesh(shape)
    agree, seen = 0, {}
    for arch, (sds, tree) in quantized_shapes.items():
        cfg, jcfg = get_config(arch), jget_config(arch)
        pol = make_policy(cfg, mesh)
        want = _jax_flat(jmake_policy(jcfg, mesh).param_specs(sds))
        got = {k: lay.spec for k, lay in
               _str_keys(pol.stored_layouts(tree)).items()}
        assert set(got) == set(want), arch
        assert pol.fsdp == (cfg.param_count_estimate() > 2e9)
        for path, ref in want.items():
            if got[path] == ref:
                agree += 1
                continue
            kind = _departure(path, got[path], ref, pol)
            seen.setdefault(kind, set()).add(arch)
    assert agree > 150
    if shape == SMALL:
        tree = quantized_shapes["gemma-2b"][1]
        lay = make_policy(get_config("gemma-2b"), mesh).stored_layouts(tree)
        assert lay["stack", "slots", 0, "attn", "wq", "w", "codes"].spec \
            == (None, "data", "model")
    assert {"gemma-2b", "qwen2-vl-2b"} <= seen["kv whole"]
    assert {"xlstm-350m", "jamba-1.5-large-398b"} <= seen["recurrent whole"]
    assert "row-cut scale" in seen


#: (arch, prompt tokens) of the context-parallel prefill's storage test:
#: whisper-small, and gemma-2b at a length the model axis does not divide
CP_STORAGE_CELLS = [("whisper-small", 64), ("gemma-2b", 62)]


@pytest.mark.parametrize("arch,s", CP_STORAGE_CELLS,
                         ids=[f"{a}-{s}" for a, s in CP_STORAGE_CELLS])
def test_cp_prefill_storage_is_the_references(quantized_shapes, arch, s):
    """``build_serve_step(..., prefill_cp=True)`` at mesh (2, 4) stores the
    weights by the reference's ``make_policy(cfg, mesh,
    parallelism="replicated").param_specs`` of its sp2_4 params, leaf for
    leaf (codes and scales apart), whatever the prompt's length: every
    leaf whole, no departure; and lays the caches out by that policy's
    ``cache_specs`` (each K/V cut on its sequence, gemma-2b's 62
    positions too); its meta names the sequences that run
    context-parallel (gemma-2b's 62 tokens do not)."""
    sds, tree = quantized_shapes[arch]
    cfg, jcfg = get_config(arch), jget_config(arch)
    bundle = steps.build_serve_step(
        cfg, ShapeConfig("t", s, 8, "prefill"),
        make_host_mesh(2, 4, ["meta"] * 8), prefill_cp=True)
    assert bundle.meta["parallelism"] == "replicated"
    want_cp = {"decoder": s % 4 == 0}
    if cfg.enc_dec:
        want_cp["encoder"] = cfg.enc_seq_len % 4 == 0
    assert bundle.meta["cp_sequences"] == want_cp
    assert bundle.rt.attn_cp is True
    want = _jax_flat(jmake_policy(jcfg, _mesh(SMALL),
                                  parallelism="replicated").param_specs(sds))
    got = {k: lay.spec for k, lay in
           _str_keys(bundle.policy.stored_layouts(tree)).items()}
    assert got == want
    assert all(e is None for spec in got.values() for e in spec)
    jpol = jmake_policy(jcfg, _mesh(SMALL), parallelism="replicated")
    want_c = _jax_flat(jpol.cache_specs(_caches_sds(jcfg, 8, s)))
    assert _str_keys(bundle.specs) == want_c
    assert all(spec[3] == "model" for path, spec in want_c.items()
               if path[-1] in ("k", "v", "xk", "xv"))


@pytest.mark.parametrize("shape", [SINGLE, MULTI], ids=["16x16", "2x16x16"])
def test_production_specs_are_the_references(shape):
    """The train step's ``param_specs`` and ``opt_specs`` (AdamW, AdamW-Q8)
    under fsdp and under tp, and the dense caches' ``cache_specs`` of
    every ``LM_SHAPES`` serving entry, against the reference's at the
    production meshes, leaf for leaf of every assigned arch: equal but at
    the named departures (tp's model axis only). On the 2 x 16 x 16 mesh,
    tp's FSDP spans ``("pod", "data")`` on jamba-1.5-large-398b and
    kimi-k2-1t-a32b only (above 100e9 params), fsdp's weights are cut over
    ``("data", "model")`` (each pod a copy) and its batch over every
    axis."""
    mesh = _mesh(shape)
    agree, giants = 0, set()
    for arch in assigned_archs():
        cfg, jcfg = get_config(arch), jget_config(arch)
        sds = _params_sds(jcfg, jnp.float32, quantized=False)
        tree = _port_tree(sds)
        for parallelism in ("fsdp", "tp"):
            jpol = jmake_policy(jcfg, mesh, parallelism=parallelism)
            pol = make_policy(cfg, mesh, parallelism=parallelism)
            assert (pol.data_axes, pol.fsdp_axes, pol.fsdp) == \
                (jpol.data_axes, jpol.fsdp_axes, jpol.fsdp), (arch,
                                                              parallelism)
            if "pod" in pol.fsdp_axes and parallelism == "tp":
                giants.add(arch)
            pairs = [(_jax_flat(jpol.param_specs(sds)),
                      _str_keys(pol.param_specs(tree)))]
            for name in ("adamw", "adamw_q8"):
                jst = jax.eval_shape(jtr.make_optimizer(name, lr=1e-4).init,
                                     sds)
                pairs.append((_jax_flat(jpol.opt_specs(sds, jst)),
                              _str_keys(pol.opt_specs(ttr.make_optimizer(
                                  name, lr=1e-4).init(tree)))))
            for want, got in pairs:
                assert set(got) == set(want), (arch, parallelism)
                for path, ref in want.items():
                    if got[path] == ref:
                        agree += 1
                        continue
                    assert parallelism == "tp", (arch, path, got[path], ref)
                    _departure(tuple(k for k in path if k not in
                                     ("mu", "nu", "codes")) or path,
                               got[path], ref, pol)
        pol, jpol = make_policy(cfg, mesh), jmake_policy(jcfg, mesh)
        init = ted.encdec_init_caches if cfg.enc_dec else lm_mod.init_caches
        for s in LM_SHAPES:
            if s.kind == "train":
                continue
            tc = init(cfg, s.global_batch, s.seq_len, device="meta")
            jc = _caches_sds(jcfg, s.global_batch, s.seq_len)
            assert _str_keys(pol.cache_specs(tc)) == \
                _jax_flat(jpol.cache_specs(jc)), (arch, s.name)
    assert agree > 2000
    if "pod" in shape:
        assert giants == {"jamba-1.5-large-398b", "kimi-k2-1t-a32b"}
    else:
        assert not giants


def test_runtime_data_axes_are_the_references():
    """``make_runtime``'s data axes for every ``LM_SHAPES`` entry at both
    production meshes: the reference's (``long_500k``'s one row
    replicates)."""
    cfg, jcfg = get_config("gemma-2b"), jget_config("gemma-2b")
    for multi in (False, True):
        mesh = make_production_mesh(multi_pod=multi)
        jmesh = _mesh(mesh.shape)
        for s, js in zip(LM_SHAPES, JLM_SHAPES):
            got = steps.make_runtime(cfg, mesh, s).data_axes
            want = jsteps.make_runtime(jcfg, jmesh, js).data_axes
            assert got == want, (multi, s.name, got, want)
            if s.name == "long_500k":
                assert got == ()


def test_build_step_unroll_is_the_references(monkeypatch):
    """``build_step(..., unroll=True)``'s meta against the reference's
    ``bundle.meta`` (the train step: one microbatch, remat none; the serve
    steps: nothing changes) for gemma-2b's train and serve cells and
    kimi-k2-1t-a32b's train, ``GIANT_PARAMS`` patched to 0 in both
    packages (8 microbatches, which ``unroll`` takes away)."""
    monkeypatch.setattr(jsteps, "GIANT_PARAMS", 0)
    monkeypatch.setattr(steps, "GIANT_PARAMS", 0)
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                              ("data", "model"))
    mesh = make_host_mesh(1, 1, ["meta"])
    for arch, kinds in (("gemma-2b", ("train", "prefill", "decode")),
                        ("kimi-k2-1t-a32b", ("train",))):
        jcfg = jreduced(jget_config(arch), d_model=64, vocab=512)
        cfg = reduced(get_config(arch), d_model=64, vocab=512)
        for kind in kinds:
            for unroll in (False, True):
                jb = jsteps.build_step(jcfg, JShapeConfig("t", 32, 16, kind),
                                       jmesh, unroll=unroll)
                b = steps.build_step(cfg, ShapeConfig("t", 32, 16, kind),
                                     mesh, unroll=unroll)
                assert {k: b.meta[k] for k in jb.meta} == jb.meta, \
                    (arch, kind, unroll)
                if kind == "train":
                    assert b.meta["accum_steps"] == (1 if unroll else 8)


# -- more model shards than query heads ----------------------------------------

#: the paged engine's knobs of the shared-head case (the sharded tests')
FEW_KNOBS = dict(batch_slots=2, max_seq=64, page_size=8, quantize="sp2_4")


def test_shared_heads_match_reference(monkeypatch):
    """reduced gemma-2b with 2 query heads over 1 KV head served at
    shards=4 (``REPRO_FORCE_DEVICE_COUNT``): each head shared by two
    shards (``planner.shard_heads``: parts of 2), each shard holding its
    head's q columns whole and half the head's ``wo`` rows; the
    reference's one-device greedy tokens, fused and unfused."""
    monkeypatch.setenv(hostdev.FORCE_ENV, "4")
    fields = dict(n_heads=2, n_kv_heads=1)
    jcfg = dataclasses.replace(jreduced(jget_config("gemma-2b")), **fields)
    cfg = dataclasses.replace(reduced(get_config("gemma-2b")), **fields)
    jp = jlm.lm_init(jax.random.PRNGKey(2), jcfg)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, 512, n).astype(np.int32) for n in (3, 9, 17)]
    jeng = JServeEngine(jp, jcfg, JServeConfig(**FEW_KNOBS),
                        rt=JRuntime(impl="ref", q_chunk=16))
    for i, p in enumerate(prompts):
        jeng.submit(JRequest(rid=i, prompt=p, max_new_tokens=5))
    want = {r.rid: list(r.output) for r in jeng.run()}
    groups = planner.shard_heads(2, 1, 4)
    assert [(g.q0, g.part, g.parts) for g in groups] == \
        [(0, 0, 2), (0, 1, 2), (1, 0, 2), (1, 1, 2)]
    for fused in (True, False):
        eng = ServeEngine(params_from_reference(jp), cfg,
                          ServeConfig(**FEW_KNOBS, shards=4,
                                      fused_decode=fused),
                          rt=Runtime(device="cpu", q_chunk=16))
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=5))
        assert {r.rid: list(r.output) for r in eng.run()} == want, fused
        for g, p in zip(groups, eng.params):
            attn = p["stack"]["slots"][0]["attn"]
            assert attn["wq"]["w"].shape[-1] == cfg.dh
            assert attn["wo"]["w"].shape[-2] == cfg.dh // 2


#: |logits(mesh) - logits(one device)| <= SHARD_LOGIT_TOL * max|logits|
#: (the serve-step test's, tests/test_torch_dense.py)
SHARD_LOGIT_TOL = 1e-5


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_serve_step_shared_heads_matches_reference(kind):
    """The serve step at mesh (1, 4) on reduced gemma-2b with 2 query
    heads: the reference's one-device logits within SHARD_LOGIT_TOL of
    their peak (prefill of 64 tokens; decode after a 40-token prefill)."""
    fields = dict(n_heads=2, n_kv_heads=1)
    jcfg = dataclasses.replace(jreduced(jget_config("gemma-2b")), **fields)
    cfg = dataclasses.replace(reduced(get_config("gemma-2b")), **fields)
    jp = jlm.lm_init(jax.random.PRNGKey(0), jcfg)
    jrt = JRuntime(impl="ref", q_chunk=1024)
    tokens = np.random.default_rng(5).integers(1, 512, (2, 64)).astype(
        np.int32)
    mesh = make_host_mesh(1, 4, ["cpu"] * 4)
    b = steps.build_serve_step(cfg, ShapeConfig("t", 64, 2, kind), mesh,
                               quantized=False, prefill_cp=False,
                               dtype=torch.float32)
    jc = jlm.init_caches(jcfg, 2, 64, dtype=jnp.float32)
    if kind == "prefill":
        want, _ = jlm.lm_prefill(jp, jnp.asarray(tokens), jc, jcfg, jrt)
        got, _ = b.fn(*b.place(params_from_reference(jp), tokens),
                      b.init_caches())
    else:
        _, jc = jlm.lm_prefill(jp, jnp.asarray(tokens[:, :40]), jc, jcfg,
                               jrt)
        want, _ = jlm.lm_decode_step(jp, jnp.asarray(tokens[:, 40]),
                                     jnp.asarray(40), jc, jcfg, jrt)
        from repro_torch.sharding import shard_dense_caches
        grid = shard_dense_caches(params_from_reference(jc), b.specs, mesh)
        got, _ = b.fn(*b.place(params_from_reference(jp), tokens[:, 40],
                               40), grid)
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= \
        SHARD_LOGIT_TOL * np.abs(want).max()


# -- the dry report against XLA and the reference's matmuls --------------------

#: the 8-device worker: the reference's steps lowered and compiled at mesh
#: (2, 4) (its own test_sharding.py's recipe), printing per cell XLA's
#: memory_analysis and each argument leaf's bytes on one device
_XLA_WORKER = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json, sys
import jax, numpy as np
sys.path.insert(0, "src")
from repro.configs import get_config, reduced
from repro.configs.base import ShapeConfig
from repro.launch.mesh import ambient_mesh, mesh_axis_kwargs
from repro.launch.steps import build_step

def key(k):
    if type(k).__name__ == "FlattenedIndexKey":
        return ("codes", "scale")[k.key]
    for attr in ("key", "name", "idx"):
        if hasattr(k, attr):
            return str(getattr(k, attr))

out = {}
for arch, kind, b, knobs in json.loads(sys.argv[1]):
    cfg = reduced(get_config(arch), d_model=64, vocab=512)
    mesh = jax.make_mesh((2, 4), ("data", "model"), **mesh_axis_kwargs(2))
    with ambient_mesh(mesh):
        bundle = build_step(cfg, ShapeConfig("t", 64, b, kind), mesh,
                            **knobs)
        # keep_unused: the encoder-decoder's prefill writes its cross
        # caches whole without reading them, and jit would drop them from
        # the arguments the caller still holds
        jfn = jax.jit(bundle.fn, in_shardings=bundle.in_shardings,
                      out_shardings=bundle.out_shardings,
                      donate_argnums=bundle.donate_argnums, keep_unused=True)
        mem = jfn.lower(*bundle.args).compile().memory_analysis()
    leaves = {}
    for i, arg in enumerate(bundle.args):
        for path, x in jax.tree_util.tree_flatten_with_path(arg)[0]:
            n = int(np.prod(x.sharding.shard_shape(x.shape))) \
                * x.dtype.itemsize
            leaves["/".join([str(i)] + [key(k) for k in path])] = n
    out[f"{arch}/{kind}/{b}/{json.dumps(knobs)}"] = {
        "argument": mem.argument_size_in_bytes, "leaves": leaves,
        "global": sum(int(np.prod(x.shape)) * x.dtype.itemsize
                      for x in jax.tree_util.tree_leaves(bundle.args)),
        "meta": bundle.meta}
print("RESULT " + json.dumps(out))
"""

#: (arch, kind, batch, build_step's knobs) of the XLA cells: gemma-2b's
#: fsdp train (8 rows over 8 devices), olmoe-1b-7b's train at 4 rows (tp),
#: gemma-2b's prefill and decode (8 rows of a 64-token cache) and
#: whisper-small's context-parallel prefill (replicated weights). A
#: context-parallel cell at a length the model axis does not divide has
#: no XLA figure: the reference's jit refuses its caches' uneven cut
XLA_CELLS = [("gemma-2b", "train", 8, {}), ("olmoe-1b-7b", "train", 4, {}),
             ("gemma-2b", "prefill", 8, {}), ("gemma-2b", "decode", 8, {}),
             ("whisper-small", "prefill", 8, {"prefill_cp": True})]
#: the index of the batch arguments of each kind (tokens / frames / pos;
#: an encoder-decoder's prefill takes frames, then tokens): the leaves
#: "less the batch"
_BATCH_ARGS = {"train": {"2"}, "prefill": {"1"}, "decode": {"1", "2"},
               "prefill-enc-dec": {"1", "2"}}


def _ref_leaf(name: str) -> tuple:
    """A worker leaf name ("<arg>/<path>") as (argument, the port's leaf
    name): the train step's state moments keep their "mu"/"nu" prefix."""
    arg, _, rest = name.partition("/")
    return arg, rest


def test_dryrun_argument_bytes_match_xla():
    """The dry report's per-device bytes of params, optimizer state and
    caches (from the port's layouts, on a meta (2, 4) mesh) against XLA's
    ``memory_analysis`` of the reference's compiled steps (an 8-device
    subprocess), for XLA_CELLS (whisper-small's context-parallel prefill
    among them: every weight whole on each device). First: XLA reports
    one device's bytes of a partitioned program (its argument bytes are
    each leaf's shard summed, below the arguments' global bytes). Then
    leaf for leaf: each of the
    port's leaves is the reference's shard, but at the named departures
    (K/V of one KV head whole on every shard, a row cut keeping every
    scale: ``wo``'s and ``down``'s), whose bytes the report's
    ``departures`` gives, and the
    reference's AdamW step count (a 4-byte device scalar, a host integer
    in the port). So the port's argument bytes less the batch equal XLA's
    less the batch, corrected by exactly the named departures."""
    r = subprocess.run([sys.executable, "-c", _XLA_WORKER,
                        json.dumps(XLA_CELLS)], capture_output=True,
                       text=True, timeout=600, cwd=REPO,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert r.returncode == 0, r.stderr[-3000:]
    xla = json.loads(r.stdout.split("RESULT ", 1)[1])
    first = xla["gemma-2b/train/8/{}"]
    assert first["argument"] == sum(first["leaves"].values())
    assert first["argument"] < first["global"] / 4
    mesh = make_host_mesh(2, 4, ["meta"] * 8)
    named = set()
    for arch, kind, b, knobs in XLA_CELLS:
        cell = xla[f"{arch}/{kind}/{b}/{json.dumps(knobs)}"]
        assert cell["argument"] == sum(cell["leaves"].values())
        cfg = reduced(get_config(arch), d_model=64, vocab=512)
        rep = dryrun.dry_report(cfg, ShapeConfig("t", 64, b, kind), mesh,
                                **knobs)
        assert {k: rep["meta"][k] for k in cell["meta"]} == cell["meta"]
        args = _BATCH_ARGS[kind + ("-enc-dec" if cfg.enc_dec and
                                   kind == "prefill" else "")]
        batch = sum(n for name, n in cell["leaves"].items()
                    if _ref_leaf(name)[0] in args)
        assert rep["memory"]["argument_parts"]["batch"] == batch
        ref = {_ref_leaf(name)[1]: n for name, n in cell["leaves"].items()
               if _ref_leaf(name)[0] not in args}
        got = rep["argument_leaves"]
        step = ref.pop("step", 0)
        assert step in (0, 4) and set(got) == set(ref), (arch, kind)
        departed = {d["leaf"]: d for d in rep["departures"]}
        for leaf, n in ref.items():
            if got[leaf] == n:
                continue
            assert departed[leaf]["reference_bytes"] == n, (arch, leaf)
            assert departed[leaf]["bytes"] == got[leaf]
            named.add((kind, leaf.split("/")[-3 if leaf.endswith(
                ("scale", "codes")) else -2]))
        assert set(departed) <= set(ref)
        held = sum(rep["memory"]["argument_parts"][k] for k in
                   ("params", "opt_state", "caches")
                   if k in rep["memory"]["argument_parts"])
        correction = sum(d["bytes"] - d["reference_bytes"]
                         for d in rep["departures"])
        assert held - correction == cell["argument"] - batch - step, \
            (arch, kind)
    assert named == {(kind, leaf) for kind in ("prefill", "decode")
                     for leaf in ("wk", "wv", "wo", "down")}


def _subjaxprs(eqn):
    for v in eqn.params.values():
        for x in (v if isinstance(v, (list, tuple)) else (v,)):
            if isinstance(x, jax.extend.core.ClosedJaxpr):
                yield x.jaxpr
            elif isinstance(x, jax.extend.core.Jaxpr):
                yield x


def _matmul_flops(jaxpr) -> int:
    """Twice the multiply-adds of every matmul ``dot_general`` in
    ``jaxpr`` (``scan`` bodies times their length): a dot_general with a
    contracting dim between two different arrays. The rest are the
    norms' statistics (``einsum("...d,...d->...", x, x)``) and their
    transposes without a contracting dim, elementwise work the port does
    with elementwise ops, which ``FlopCounterMode`` counts as none."""
    total = 0
    for eqn in jaxpr.eqns:
        name = eqn.primitive.name
        assert name not in ("while", "cond"), name
        if name == "dot_general":
            (lc, _), _ = eqn.params["dimension_numbers"]
            a = eqn.invars[0].aval.shape
            if lc and eqn.invars[0] is not eqn.invars[1]:
                total += 2 * int(np.prod(eqn.outvars[0].aval.shape)) \
                    * int(np.prod([a[i] for i in lc]))
        n = eqn.params["length"] if name == "scan" else 1
        total += n * sum(_matmul_flops(sub) for sub in _subjaxprs(eqn))
    return total


@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
def test_dryrun_flops_are_the_references(kind):
    """Reduced gemma-2b on one device: the dry report's
    ``FlopCounterMode`` total on meta equals the reference's matmul flops
    in ``jax.make_jaxpr`` of its same step (``_matmul_flops``), for the
    sp2_4 prefill and decode and the train step under ``unroll`` (remat
    none, one microbatch: the forward, the attention chunks' recompute of
    their scores, as the reference's ``jax.checkpoint`` chunk, the loss
    chunks' recompute and the backward)."""
    import jax.extend  # noqa: F401
    kw = {"unroll": True} if kind == "train" else {}
    jcfg = jreduced(jget_config("gemma-2b"), d_model=64, vocab=512)
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                              ("data", "model"))
    jb = jsteps.build_step(jcfg, JShapeConfig("t", 64, 2, kind), jmesh, **kw)
    with jmesh:
        want = _matmul_flops(jax.make_jaxpr(jb.fn)(*jb.args).jaxpr)
    rep = dryrun.dry_report(reduced(get_config("gemma-2b"), d_model=64,
                                    vocab=512),
                            ShapeConfig("t", 64, 2, kind),
                            make_host_mesh(1, 1, ["meta"]), **kw)
    assert want > 0
    assert rep["cost"]["flops_total"] == rep["cost"]["flops"] == want


def _real_run(cfg, shape, mesh, seed: int):
    """``dry_report`` of the step on real CPU inputs (weights and tokens
    from ``seed``), and the one-device loss of the same batch: under tp a
    MoE routes each data group's rows apart and reports group 0's aux
    loss (the reference's, ``test_moe_aux_under_tp_is_the_references``),
    so the one-device loss is ce and z over the groups' ``lm_loss`` and
    group 0's aux."""
    gen = torch.Generator().manual_seed(seed)
    params = lm_mod.lm_init(gen, cfg, dtype=torch.float32, device="cpu")
    batch = {k: torch.randint(0, cfg.vocab_size,
                              (shape.global_batch, shape.seq_len),
                              generator=gen, dtype=torch.int32)
             for k in ("tokens", "labels")}
    rep = dryrun.dry_report(cfg, shape, mesh, params=params, batch=batch,
                            dtype=torch.float32)
    groups = 1 if rep["meta"]["parallelism"] == "fsdp" else len(mesh.grid)
    per, rt = shape.global_batch // groups, Runtime(device="cpu")
    parts = [lm_mod.lm_loss(params, {k: v[g * per:(g + 1) * per]
                                     for k, v in batch.items()}, cfg, rt)[1]
             for g in range(groups)]
    one = sum(float(m["ce"]) + lm_mod.Z_WEIGHT * float(m["z"])
              for m in parts) / groups
    if "aux" in parts[0]:
        one += lm_mod.AUX_WEIGHT * float(parts[0]["aux"])
    return rep, one


#: (arch, mesh (pod, data, model), batch): fsdp over four devices,
#: olmoe-1b-7b's tp with expert-parallel MoE (all-to-all), and a pod axis
META_CELLS = [("gemma-2b", (None, 2, 2), 4), ("olmoe-1b-7b", (None, 2, 2), 2),
              ("gemma-2b", (2, 1, 2), 4), ("olmoe-1b-7b", (2, 1, 2), 2)]


@pytest.mark.parametrize("arch,axes,b", META_CELLS,
                         ids=[f"{a}-{'x'.join(str(n) for n in m if n)}-b{b}"
                              for a, m, b in META_CELLS])
def test_dryrun_meta_equals_a_real_run(arch, axes, b):
    """The train step's dry report on a meta mesh and on the same mesh of
    ``["cpu"] * 4`` with real weights and tokens: equal flops, collective
    counters (every device's, by kind) and argument bytes; the real run's
    loss within GRAD_RTOL of the one-device ``lm_loss`` of the same batch
    (``_real_run``)."""
    pod, data, model = axes
    cfg = reduced(get_config(arch), d_model=64, vocab=512)
    shape = ShapeConfig("t", 32, b, "train")
    meta = dryrun.dry_report(cfg, shape, make_host_mesh(
        data, model, ["meta"] * 4, pod=pod), dtype=torch.float32)
    real, want = _real_run(cfg, shape, make_host_mesh(
        data, model, ["cpu"] * 4, pod=pod), seed=3)
    assert meta["meta"] == real["meta"]
    if arch == "olmoe-1b-7b":
        assert meta["meta"]["parallelism"] == "tp"
        assert "all-to-all" in meta["collectives"]["busiest"]
    assert meta["cost"] == real["cost"]
    assert meta["collectives"] == real["collectives"]
    assert meta["argument_by_device"] == real["argument_by_device"]
    assert meta["memory"]["argument_bytes"] == \
        real["memory"]["argument_bytes"]
    loss = real["metrics"]["loss"]
    assert abs(loss - want) <= GRAD_RTOL * abs(want)


#: (encoder frames, all-gathers a layer on each device) of whisper-small's
#: context-parallel prefill at mesh (2, 4), 64 prompt tokens: both
#: sequences cut (the encoder's K and V, the decoder's, the cross K and
#: V), or the encoder whole (the decoder's K and V only)
CP_COUNT_CELLS = [(16, 6), (18, 2)]


@pytest.mark.parametrize("s_enc,gathers", CP_COUNT_CELLS,
                         ids=[f"enc{e}" for e, _ in CP_COUNT_CELLS])
def test_dryrun_cp_prefill_equals_a_real_run(s_enc, gathers):
    """Reduced whisper-small's context-parallel prefill at mesh (2, 4):
    the dry report on meta against the same step run on eight CPU
    devices with real weights, frames and tokens: every device's
    collective counters equal (the K/V gathers, by the reference's name
    ``all-gather``, ``gathers`` a layer on every device and nothing else)
    and every device's weights and cache blocks equal in bytes."""
    from repro_torch import collectives
    cfg = dataclasses.replace(reduced(get_config("whisper-small"),
                                      d_model=64, vocab=512),
                              enc_seq_len=s_enc)
    shape = ShapeConfig("t", 64, 8, "prefill")
    knobs = dict(prefill_cp=True, dtype=torch.float32)
    rep = dryrun.dry_report(cfg, shape, make_host_mesh(2, 4, ["meta"] * 8),
                            param_dtype=torch.float32, **knobs)
    bundle = steps.build_serve_step(cfg, shape, make_host_mesh(
        2, 4, ["cpu"] * 8), **knobs)
    gen = torch.Generator().manual_seed(3)
    params = ted.encdec_init(gen, cfg, device="cpu")
    frames = torch.randn((8, s_enc, 64), generator=gen)
    tokens = torch.randint(1, 512, (8, 64), generator=gen)
    placed, *inputs = bundle.place(params, frames, tokens)
    grid = bundle.init_caches()
    collectives.reset_counts()
    bundle.fn(placed, *inputs, grid)
    real = collectives.counts()
    assert rep["collectives"]["by_device"] == real
    assert set(real) == set(range(8))
    assert all(set(c) == {"all-gather"} and c["all-gather"]["ops"]
               == gathers * cfg.n_layers for c in real.values())

    def nbytes(tree):
        out = 0
        for t in tree_leaves(tree):
            for x in ((t.codes, t.scale) if hasattr(t, "codes") else (t,)):
                out += x.numel() * x.element_size()
        return out
    by_dev = rep["argument_by_device"]
    assert [[by_dev["params"][d][m] + by_dev["caches"][d][m]
             for m in range(4)] for d in range(2)] == \
        [[nbytes(placed[d][m]) + nbytes(grid[d][m]) for m in range(4)]
         for d in range(2)]


def test_dryrun_cli_writes_the_artifact(monkeypatch, tmp_path, capsys):
    """``main()`` with the production mesh patched to a (2, 2) meta mesh,
    the configs to reduced ones and the shapes to small ones of the same
    names: ``dryrun_gemma-2b_<shape>_single.json`` for each shape, with
    every field of the report, by the class path, and with
    ``--all-devices`` by the all-devices run (the same flops and
    collectives, and the mesh-wide peak); ``long_500k`` skipped on the
    full-attention arch with the reference's status; a cell that raises
    gives ``N FAILURES`` and exit 1."""
    monkeypatch.setattr(dryrun, "make_production_mesh",
                        lambda multi_pod=False: make_host_mesh(
                            2, 2, ["meta"] * 4))
    monkeypatch.setattr(dryrun, "get_config", lambda a: reduced(
        get_config(a), d_model=64, vocab=512))
    monkeypatch.setattr(dryrun, "LM_SHAPES", tuple(
        dataclasses.replace(s, seq_len=32, global_batch=4)
        for s in LM_SHAPES))
    dryrun.main(["--arch", "gemma-2b", "--artifact-dir", str(tmp_path)])
    printed = capsys.readouterr().out
    assert "skipped(full-attention)" in printed
    assert "all 4 cells ran OK" in printed
    names = sorted(os.listdir(tmp_path))
    assert names == [f"dryrun_gemma-2b_{s}_single.json"
                     for s in ("decode_32k", "prefill_32k", "train_4k")]
    rec = json.loads((tmp_path / names[-1]).read_text())
    assert rec["status"] == "ok" and rec["meta"]["kind"] == "train"
    # the CLI's default is the class path: no mesh-wide peak, the temp
    # bytes a representative's, every device in a class
    assert rec["memory"]["mesh_peak_bytes"] is None
    assert rec["memory"]["temp_over"] == "representative"
    assert sum(c["devices"] for c in rec["classes"]) == 4
    every = tmp_path / "every"
    dryrun.main(["--arch", "gemma-2b", "--shape", "train_4k",
                 "--all-devices", "--artifact-dir", str(every)])
    full = json.loads((every / names[-1]).read_text())
    assert full["memory"]["temp_over"] == "mesh" and full["classes"] is None
    assert full["cost"] == rec["cost"]
    assert full["collectives"] == rec["collectives"]
    for r in (rec, full):
        for key in ("argument_bytes", "output_bytes", "alias_bytes",
                    "temp_bytes", "peak_per_device_bytes"):
            assert r["memory"][key] > 0, key
        assert r["memory"]["temp_is_mean"] is True
    assert full["memory"]["mesh_peak_bytes"] > 0
    assert rec["cost"]["flops"] > 0 and rec["cost"]["bytes"] is None
    assert rec["collectives"]["busiest"] and rec["collectives"]["mean"]
    for key in ("model_flops_dense", "model_flops_active", "param_count",
                "active_param_count", "build_s", "run_s"):
        assert rec[key] > 0, key
    assert dryrun.run_cell("gemma-2b", "long_500k", multi_pod=False,
                           artifact_dir=str(tmp_path)) == {
        "arch": "gemma-2b", "shape": "long_500k",
        "status": "skipped(full-attention)"}

    def broken(cfg, shape, mesh, **kw):
        if shape.kind == "decode":
            raise RuntimeError("a broken cell")
        return steps.build_step(cfg, shape, mesh, **kw)
    monkeypatch.setattr(dryrun, "build_step", broken)
    with pytest.raises(SystemExit) as exc:
        dryrun.main(["--arch", "gemma-2b", "--shape", "decode_32k",
                     "--artifact-dir", str(tmp_path)])
    assert exc.value.code == 1
    assert "1 FAILURES" in capsys.readouterr().out


# -- the class path: one representative per symmetric class -----------------------

def _class_fields(rep: dict) -> dict:
    """The fields of a dry report that the class path holds equal to the
    all-devices run's."""
    mem = rep["memory"]
    return {"memory": {k: mem[k] for k in ("argument_bytes",
                                           "argument_parts", "output_bytes",
                                           "alias_bytes")},
            "cost": {k: rep["cost"][k] for k in ("flops", "flops_total")},
            **{k: rep[k] for k in ("argument_by_device", "collectives",
                                   "departures", "uneven",
                                   "argument_leaves", "meta")}}


def _whisper(s_enc: int):
    return dataclasses.replace(reduced(get_config("whisper-small"),
                                       d_model=64, vocab=512),
                               enc_seq_len=s_enc)


#: (id, arch or config, mesh (pod, data, model), (seq, batch, kind),
#: knobs, the classes' sizes in units): fsdp (every device its own class
#: member), tp with the expert-parallel MoE on a (data, model) and a pod
#: mesh, fsdp's MoE joined on the first device (with mamba, and the
#: recurrent xLSTM: several slots to a checkpointed period), a model axis
#: wider than the query heads (4 heads over 6 shards: shared and uneven),
#: whisper's
#: context-parallel prefill on both of CP_COUNT_CELLS' branches, the
#: sequence-sharded decode, and microbatches of one row over two data
#: groups (the first group runs them)
CLASS_CELLS = [
    ("gemma-fsdp-2x2", "gemma-2b", (None, 2, 2), (32, 8, "train"), {}, [4]),
    ("gemma-fsdp-4x2", "gemma-2b", (None, 4, 2), (32, 16, "train"), {},
     [8]),
    ("olmoe-tp-2x2", "olmoe-1b-7b", (None, 2, 2), (32, 2, "train"), {},
     [2]),
    ("olmoe-tp-pod", "olmoe-1b-7b", (2, 1, 2), (32, 2, "train"), {}, [2]),
    ("olmoe-fsdp-moe", "olmoe-1b-7b", (None, 2, 2), (32, 8, "train"),
     {"accum_steps": 2, "optimizer": "adamw_q8"}, [1, 3]),
    ("jamba-fsdp-moe-mamba", "jamba-1.5-large-398b", (None, 2, 2),
     (32, 4, "train"), {}, [1, 3]),
    ("xlstm-fsdp", "xlstm-350m", (None, 2, 2), (32, 4, "train"), {}, [4]),
    ("shared-heads-prefill", "gemma-2b", (None, 2, 6), (32, 4, "prefill"),
     {}, [2]),
    ("shared-heads-train", "gemma-2b", (None, 2, 6), (32, 2, "train"), {},
     [2]),
    ("whisper-cp-enc16", _whisper(16), (None, 2, 4), (64, 8, "prefill"),
     {"prefill_cp": True, "param_dtype": torch.float32}, [2]),
    ("whisper-cp-enc18", _whisper(18), (None, 2, 4), (64, 8, "prefill"),
     {"prefill_cp": True, "param_dtype": torch.float32}, [2]),
    ("decode-seq-sharded", "gemma-2b", (None, 2, 4), (64, 8, "decode"), {},
     [2]),
    ("microbatch-first-group", "gemma-2b", (None, 2, 2), (32, 6, "train"),
     {"accum_steps": 6}, [1, 1]),
]


@pytest.mark.parametrize("cfg,axes,shape,knobs,sizes",
                         [c[1:] for c in CLASS_CELLS],
                         ids=[c[0] for c in CLASS_CELLS])
def test_dryrun_classes_equal_the_full_run(cfg, axes, shape, knobs, sizes):
    """The class path (one representative per symmetric class, each run
    alone, its counts given to every member, the microbatches and the
    optimizer's slices folded, fsdp's skipped recompute flops given
    back) against the all-devices ``dry_report`` of
    the same step on the same meta mesh: equal argument, output and alias
    bytes, flops, every device's collective counters, departures, uneven
    leaves and meta; the classes as ``sizes`` says, every device in one."""
    if isinstance(cfg, str):
        cfg = reduced(get_config(cfg), d_model=64, vocab=512)
    pod, data, model = axes
    mesh = make_host_mesh(data, model, ["meta"] * (data * model * (pod or 1)),
                          pod=pod)
    knobs = dict(knobs)
    if shape[2] == "train":
        knobs["dtype"] = torch.float32
    shape = ShapeConfig("t", *shape)
    full = dryrun.dry_report(cfg, shape, mesh, **knobs)
    rep = dryrun.dry_report(cfg, shape, mesh, classes=True, **knobs)
    assert _class_fields(rep) == _class_fields(full)
    assert full["collectives"]["by_device"]
    assert [c["units"] for c in rep["classes"]] == sizes
    assert sum(c["devices"] for c in rep["classes"]) == len(mesh.devices)
    assert rep["memory"]["mesh_peak_bytes"] is None
    assert rep["memory"]["temp_over"] == "representative"
    assert full["memory"]["temp_over"] == "mesh"


def test_dryrun_fold_keeps_the_class_path(monkeypatch):
    """The class path's fold (the microbatches after the first, and the
    8-bit optimizer's stacked slices, run once for all their repeats)
    against the same class path unfolded: every field equal, the memory
    too (each repeat's peak on what the repeats before it left). Every
    stacked leaf is sliced here (``_SLICE_ABOVE`` 0), under fsdp with the
    MoE's first-device class and under tp."""
    from repro_torch.training import optimizer
    monkeypatch.setattr(optimizer, "_SLICE_ABOVE", 0)
    cfg = reduced(get_config("olmoe-1b-7b"), d_model=64, vocab=512,
                  n_layers=3)
    mesh = make_host_mesh(2, 2, ["meta"] * 4)
    for b, accum in ((8, 4), (6, 3)):
        shape = ShapeConfig("t", 32, b, "train")
        knobs = dict(dtype=torch.float32, accum_steps=accum,
                     optimizer="adamw_q8", classes=True)
        folded = dryrun.dry_report(cfg, shape, mesh, **knobs)
        whole = dryrun.dry_report(cfg, shape, mesh, fold=False, **knobs)
        assert _class_fields(folded) == _class_fields(whole)
        assert folded["memory"] == whole["memory"]
        assert [{k: c[k] for k in ("representative", "units", "flops",
                                   "peak_bytes", "temp_bytes")}
                for c in folded["classes"]] == \
            [{k: c[k] for k in ("representative", "units", "flops",
                                "peak_bytes", "temp_bytes")}
             for c in whole["classes"]]


#: production cells whose classes ``test_dryrun_class_partition`` checks:
#: fsdp training, tp training of a giant (FSDP over the pods on the
#: multi-pod mesh), a serve step with FSDP-stored weights
PARTITION_CELLS = [("gemma-2b", "train_4k"), ("kimi-k2-1t-a32b", "train_4k"),
                   ("granite-3-8b", "decode_32k")]


@pytest.mark.parametrize("multi", [False, True], ids=["16x16", "2x16x16"])
def test_dryrun_class_partition(multi):
    """On both production meshes: every device in exactly one class, the
    units of a class all of one size (a device under fsdp, a row
    otherwise), and the members of a class holding, place by place,
    blocks of the representative's shapes of every leaf it holds."""
    mesh = make_production_mesh(multi_pod=multi)
    sizes, cols = mesh.shape, mesh.shape["model"]
    for arch, name in PARTITION_CELLS:
        shape = next(s for s in LM_SHAPES if s.name == name)
        classes, held = dryrun.cell_classes(get_config(arch), shape, mesh)
        devices = [k for units in classes for u in units for k in u]
        assert sorted(devices) == list(range(len(mesh.devices))), arch
        for units in classes:
            assert len({len(u) for u in units}) == 1
            assert len(units[0]) in (1, cols)
            for unit in units[1:]:
                for r, k in zip(units[0], unit):
                    for lays in held:
                        for lay in lays.values():
                            assert lay.block_shape(r // cols, r % cols,
                                                   sizes) == \
                                lay.block_shape(k // cols, k % cols, sizes)


def test_dryrun_shape_cache_changes_no_output():
    """``LiveBytes`` with a ``ShapeCache`` on reduced xlstm-350m's train
    step (fsdp, remat: the forward, its recompute and the backward) and
    its prefill, both through the sLSTM's per-token loop: every op a mode
    above it sees returns outputs of the same shapes, strides, dtypes and
    storage bytes as without the cache, op for op, with the same flops
    below it and the same peak of live bytes, and the cache answers most
    ops (a first run warms the port's own caches, a codebook's LUT among
    them)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import FlopCounterMode

    class Trace(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            self.ops.append((str(func), [
                (tuple(t.shape), t.stride(), t.dtype,
                 t.untyped_storage().nbytes())
                for t in torch.utils._pytree.tree_leaves(out)
                if isinstance(t, torch.Tensor)]))
            return out

    cfg = reduced(get_config("xlstm-350m"), d_model=64, vocab=512)
    mesh = make_host_mesh(1, 2, ["meta"] * 2)
    for shape, knobs in ((ShapeConfig("t", 8, 2, "train"),
                          dict(dtype=torch.float32)),
                         (ShapeConfig("t", 8, 2, "prefill"), {})):
        bundle = steps.build_step(cfg, shape, mesh, **knobs)
        params = dryrun._init(cfg, torch.float32)
        if shape.kind == "train":
            args = (*bundle.place(params), dryrun._batch(cfg, shape))
        else:
            args = (*bundle.place(params, *dryrun._serve_inputs(
                cfg, shape, torch.bfloat16)), bundle.init_caches("meta"))
        runs, cache = [], dryrun.ShapeCache()
        for shapes in (None, None, cache):
            trace, live = Trace(), dryrun.LiveBytes(shapes)
            live.track_tree(args)
            with FlopCounterMode(display=False) as flops, live, trace:
                bundle.fn(*args)
            runs.append((trace.ops, flops.get_total_flops(), live.peak))
        assert runs[1] == runs[2]
        assert cache.hits > cache.misses > 0


def test_tp_loss_head_cut_on_d():
    """A vocabulary that does not divide the model axis cuts an untied
    head on d (granite-3-8b's 49155 over 16 shards at 2 x 16 x 16): the
    tp train step joins the head's row blocks for the loss, on real
    weights within GRAD_RTOL of the one-device loss, and its dry report
    on meta equals the real run's flops and counters."""
    cfg = reduced(get_config("granite-3-8b"), d_model=64, vocab=510)
    assert not cfg.tie_embeddings
    shape = ShapeConfig("t", 32, 2, "train")
    real, want = _real_run(cfg, shape, make_host_mesh(2, 4, ["cpu"] * 8),
                           seed=3)
    meta = dryrun.dry_report(cfg, shape, make_host_mesh(2, 4, ["meta"] * 8),
                             dtype=torch.float32)
    assert real["meta"]["parallelism"] == "tp"
    assert abs(real["metrics"]["loss"] - want) <= GRAD_RTOL * abs(want)
    assert meta["cost"] == real["cost"]
    assert meta["collectives"] == real["collectives"]
