"""The port's MoE (``repro_torch.nn.moe``) against ``repro.nn.moe`` on the
same JAX-made params and the same inputs: top-1 and top-2 routing with the
capacity unconstrained, capacity drops (the same tokens dropped), the
shared expert, the capacity formula, the aux loss, stacked
QuantizedTensor experts, a router tie, where the lower expert index
must win as in ``jax.lax.top_k``, the experts run a block at a time, and
the expert-parallel MoE over two CPU shards (``moe_apply_sharded``)
against the reference's one-device MoE.

Tolerance: outputs within 1e-5 of the largest |output| (``_close``), the
aux loss within 1e-5 relative. Both sides sum f32 products over D and F in
their own orders; the routing itself is compared exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.nn import moe as jmoe
from repro.nn.layers import quantize_params as jquantize
from repro.runtime import Runtime as JRuntime
from repro_torch.interop import params_from_reference
from repro_torch.nn import moe as tmoe
from repro_torch.runtime import Runtime

JRT = JRuntime(impl="ref")
CPU = Runtime(device="cpu")
RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _fresh_jax_caches():
    yield
    jax.clear_caches()


def _setup(seed=0, d=16, f=32, e=4, shape=(2, 12), n_shared=0):
    p = jmoe.moe_init(jax.random.PRNGKey(seed), d, f, e, n_shared=n_shared)
    x = np.random.default_rng(seed).standard_normal(shape + (d,)) \
        .astype(np.float32)
    return p, x


def _both(p, x, **kw):
    jy, jaux = jmoe.moe_apply(p, jnp.asarray(x), rt=JRT, **kw)
    ty, taux = tmoe.moe_apply(params_from_reference(p), torch.from_numpy(x),
                              rt=CPU, **kw)
    return (np.asarray(jy), float(jaux)), (ty.numpy(), float(taux))


def _close(got, want):
    err = np.abs(got - want).max()
    assert err <= RTOL * np.abs(want).max(), err


@pytest.mark.parametrize("top_k", [1, 2])
def test_unconstrained_matches_reference(top_k):
    p, x = _setup()
    (jy, jaux), (ty, taux) = _both(p, x, top_k=top_k, n_experts=4,
                                   capacity_factor=64.0)
    _close(ty, jy)
    assert taux == pytest.approx(jaux, rel=RTOL)


def test_capacity_drops_the_same_tokens():
    """Capacity 8 for 24 tokens x 2 choices over 4 experts: assignments
    overflow, and the port drops exactly the reference's (the rows of a
    dropped token differ from the unconstrained output by its whole
    expert's share, far beyond the tolerance)."""
    p, x = _setup(seed=1)
    kw = dict(top_k=2, n_experts=4)
    (jy, _), (ty, _) = _both(p, x, capacity_factor=0.1, **kw)
    (jfull, _), _ = _both(p, x, capacity_factor=64.0, **kw)
    assert tmoe.expert_capacity(24, 4, 2, 0.1) == 8
    dropped = np.abs(jy - jfull).max(axis=-1) > 1e-3
    assert dropped.any() and not dropped.all()
    _close(ty, jy)


def test_shared_expert_matches_reference():
    """kimi-k2's shape: one shared swiglu expert beside the routed ones."""
    p, x = _setup(seed=2, n_shared=1)
    assert "shared" in p
    (jy, _), (ty, _) = _both(p, x, top_k=2, n_experts=4,
                             capacity_factor=64.0)
    _close(ty, jy)


@pytest.mark.parametrize("n_tokens,n_experts,top_k,cf", [
    (1024, 8, 2, 1.0), (1024, 8, 2, 1.25), (10, 64, 8, 1.25),
    (4, 64, 8, 1.25), (128, 64, 8, 1.25), (32, 16, 2, 1.25),
    (7, 4, 1, 64.0)])
def test_expert_capacity_formula(n_tokens, n_experts, top_k, cf):
    assert tmoe.expert_capacity(n_tokens, n_experts, top_k, cf) \
        == jmoe.expert_capacity(n_tokens, n_experts, top_k, cf)


def test_aux_loss_matches_and_ranks_routers():
    """The aux loss equals the reference's, and a router collapsed onto
    one expert scores higher than the balanced one."""
    p, x = _setup(seed=3)
    w = np.zeros((16, 4), np.float32)
    w[:, 0] = 10.0
    bad = dict(p, router={"w": jnp.asarray(w)})
    kw = dict(top_k=2, n_experts=4, capacity_factor=64.0)
    (_, jaux), (_, taux) = _both(p, x, **kw)
    (_, jbad), (_, tbad) = _both(bad, x, **kw)
    assert taux == pytest.approx(jaux, rel=RTOL)
    assert tbad == pytest.approx(jbad, rel=RTOL)
    assert tbad > taux


def test_quantized_expert_stacks_match_reference():
    """Expert stacks quantized by the reference (sp2_4, per (expert,
    column) scales) and carried over: both sides dequantize them and take
    the same products."""
    p, x = _setup(seed=4, d=32, f=64, e=4)
    qp = jquantize(p, "sp2_4", min_size=1024)
    assert all(hasattr(qp[k], "codes") for k in ("gate", "up", "down"))
    assert not hasattr(qp["router"]["w"], "codes")
    (jy, _), (ty, _) = _both(qp, x, top_k=2, n_experts=4,
                             capacity_factor=1.25)
    _close(ty, jy)


def test_router_tie_takes_the_lower_index():
    """Experts 1 and 3 get identical router columns, the largest logits:
    every token's probabilities tie between them, and top-1 must route to
    expert 1, as the reference does."""
    p, x = _setup(seed=5)
    w = np.asarray(p["router"]["w"]).copy()
    w[:, 1] = np.abs(w).sum(axis=1) + 1.0
    w[:, 3] = w[:, 1]
    x = np.abs(x)                  # positive inputs: column 1 dominates
    tied = dict(p, router={"w": jnp.asarray(w)})
    (jy, _), (ty, _) = _both(tied, x, top_k=1, n_experts=4,
                             capacity_factor=64.0)
    _close(ty, jy)
    probs = torch.softmax(torch.from_numpy(x.reshape(-1, 16) @ w), -1)
    assert torch.equal(probs[:, 1], probs[:, 3])
    _, idx = tmoe._top_k(probs, 1)
    assert (idx[:, 0] == 1).all()
    _, idx2 = tmoe._top_k(torch.tensor([[0.1, 0.3, 0.2, 0.3, 0.1]]), 3)
    assert idx2.tolist() == [[1, 3, 2]]


@pytest.mark.parametrize("per", [1, 3], ids=["one-expert", "three-experts"])
def test_expert_blocks_match_reference(monkeypatch, per):
    """A stack dequantized a block of experts at a time (as a full-width
    jamba layer is: ``EXPERT_BLOCK_ELEMS`` set here to ``per`` experts of
    16 x 32, the last block short) gives the reference's output, capacity
    drops included."""
    p, x = _setup(seed=6)
    monkeypatch.setattr(tmoe, "EXPERT_BLOCK_ELEMS", per * 16 * 32)
    (jy, _), (ty, _) = _both(p, x, top_k=2, n_experts=4,
                             capacity_factor=0.1)
    _close(ty, jy)


def _expert_shards(p, n_experts, n_shared=0):
    """The reference's MoE params cut over two CPU shards by
    ``sharding.shard_params`` (experts split, router whole, a shared
    expert cut as a tensor-parallel MLP), and the runtime of their mesh."""
    import dataclasses
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.sharding import ShardingPolicy, shard_params
    cfg = dataclasses.replace(reduced(get_config("olmoe-1b-7b")),
                              n_experts=n_experts,
                              n_shared_experts=n_shared)
    mesh = make_serving_mesh(2, ["cpu", "cpu"])
    shards = shard_params({"moe": params_from_reference(p)},
                          ShardingPolicy(cfg, mesh), mesh)
    return [s["moe"] for s in shards], Runtime(device="cpu", mesh=mesh)


@pytest.mark.parametrize("cf,n_shared", [(64.0, 0), (0.1, 0), (64.0, 1)],
                         ids=["unconstrained", "drops", "shared"])
def test_expert_parallel_matches_reference(cf, n_shared):
    """``moe_apply_sharded`` over two shards of 2 experts each (the
    reference's expert-parallel body: the router and the capacity global,
    another shard's assignments parked, the partials summed in shard
    order) against the reference's one-device MoE: the same output within
    RTOL (only the combine's order differs), the same tokens dropped, the
    same aux loss, and each shard holding its half of the experts."""
    p, x = _setup(seed=7, n_shared=n_shared)
    shards, rt = _expert_shards(p, 4, n_shared)
    assert [s["gate"].shape[0] for s in shards] == [2, 2]
    assert torch.equal(shards[1]["gate"],
                       torch.tensor(np.asarray(p["gate"])[2:]))
    jy, jaux = jmoe.moe_apply(p, jnp.asarray(x), top_k=2, n_experts=4,
                              capacity_factor=cf, rt=JRT)
    ty, taux = tmoe.moe_apply_sharded(shards, torch.from_numpy(x), top_k=2,
                                      n_experts=4, capacity_factor=cf, rt=rt)
    _close(ty.numpy(), np.asarray(jy))
    assert float(taux) == pytest.approx(float(jaux), rel=RTOL)
