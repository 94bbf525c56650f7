"""The port's copy of the paper's own model (§4.1, 784-128-10 sigmoid MLP)
and its procedural digits against ``repro`` on the CPU:

* ``make_dataset`` gives the reference's digits bit for bit;
* ``paper_mlp_apply`` on the same weights (the JAX init carried over), f32
  and SPx ``sp2_4`` with both layers quantized (``min_size=1024``, as
  ``benchmarks/table1.py`` does; JAX runs the Pallas kernel in interpret
  mode), is within 1e-5 of the reference with identical argmax;
  ``paper_mlp_loss`` within 1e-6; ``paper_mlp_predict`` identical;
* ``mlp_net_apply`` with ReLU on the (4, 64, 64, 2) Q-network of
  ``examples/rl_qlearning.py``;
* ``mlp_net_init`` draws from an explicit ``torch.Generator``;
* the §4 experiments: autograd gradients of ``paper_mlp_loss`` within
  1e-6 of ``jax.grad``, 20 SGD steps within 1e-5, the optimizers' steps,
  ``spx.quantize`` / ``fake_quantize``, ``plan_matmul_blocks`` on the
  reference's hardware fields, a port-only 300-step run to the
  reference's accuracy bars, the cart-pole and one Q-learning step, and
  the example and benchmark entry points on the CPU.

The kernel at these shapes (K = 784 and 128, N = 128 and 10) is held
against its plain version on the card by ``tests/test_torch_kernels.py``
(``gpu``) and ``chip_smoke.py``."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.data.mnist import make_dataset as jmake_dataset
from repro.models import mlp_mnist as jmlp
from repro.nn.layers import quantize_params as jquantize
from repro.runtime import Runtime as JRuntime
from repro_torch import models as tmodels
from repro_torch.core.quantized import QuantizedTensor
from repro_torch.data import SynthDigits, make_dataset
from repro_torch.interop import params_from_reference
from repro_torch.kernels import ops
from repro_torch.models import mlp_mnist as tmlp
from repro_torch.nn.layers import quantize_params
from repro_torch.runtime import Runtime

CPU = Runtime(device="cpu")
JRT = JRuntime(impl="interpret")


def test_make_dataset_is_bit_identical():
    for n, seed in ((64, 7), (10, 0)):
        x, y = make_dataset(n, seed=seed)
        jx, jy = jmake_dataset(n, seed=seed)
        assert x.dtype == jx.dtype == np.float32 and x.shape == (n, 784)
        assert np.array_equal(x, jx) and np.array_equal(y, jy)
    img, _ = make_dataset(3, seed=1, flat=False)
    assert img.shape == (3, 28, 28)
    batch = next(SynthDigits(n_train=128, n_test=16).batches())
    assert batch[0].shape == (64, 784) and batch[1].shape == (64,)


@pytest.fixture(scope="module")
def mlp():
    jparams = jmlp.paper_mlp_init(jax.random.PRNGKey(0))
    x, y = make_dataset(64, seed=7)
    return dict(jparams=jparams, jq=jquantize(jparams, "sp2_4",
                                              min_size=1024), x=x, y=y)


def _arm(mlp, arm):
    """(reference params, the port's params) for one arm."""
    if arm == "dense":
        return mlp["jparams"], params_from_reference(mlp["jparams"])
    if arm == "sp2_4-carried":
        return mlp["jq"], params_from_reference(mlp["jq"])
    # the port quantizes the carried f32 weights itself
    return mlp["jq"], quantize_params(params_from_reference(mlp["jparams"]),
                                      "sp2_4", min_size=1024)


@pytest.mark.parametrize("arm", ["dense", "sp2_4-carried", "sp2_4-port"])
def test_paper_mlp_apply_matches_reference(mlp, arm):
    jp, tp = _arm(mlp, arm)
    quantized = arm != "dense"
    assert all(isinstance(tp[f"l{i}"]["w"], QuantizedTensor) == quantized
               for i in range(2))
    want = np.asarray(jmlp.paper_mlp_apply(jp, jnp.asarray(mlp["x"]), JRT))
    ops.reset_op_calls()
    got = tmlp.paper_mlp_apply(tp, torch.as_tensor(mlp["x"]), CPU)
    # both layers through the op (its plain version on CPU tensors)
    assert ops.ref_calls().get("spx_matmul", 0) == (2 if quantized else 0)
    assert got.shape == (64, 10) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    assert np.array_equal(got.numpy().argmax(-1), want.argmax(-1))
    pred = tmlp.paper_mlp_predict(tp, torch.as_tensor(mlp["x"]), CPU)
    assert np.array_equal(pred.numpy(), np.asarray(
        jmlp.paper_mlp_predict(jp, jnp.asarray(mlp["x"]), JRT)))


@pytest.mark.parametrize("arm", ["dense", "sp2_4-carried"])
def test_paper_mlp_loss_matches_reference(mlp, arm):
    jp, tp = _arm(mlp, arm)
    want = float(jmlp.paper_mlp_loss(jp, jnp.asarray(mlp["x"]),
                                     jnp.asarray(mlp["y"]), JRT))
    got = tmlp.paper_mlp_loss(tp, torch.as_tensor(mlp["x"]),
                              torch.as_tensor(mlp["y"]), CPU)
    assert got.ndim == 0
    assert abs(float(got) - want) <= 1e-6


@pytest.mark.parametrize("batch", [1, 5])
def test_q_network_relu_matches_reference(batch):
    """The §4.2 Q-network: (4, 64, 64, 2), ReLU, no final activation."""
    jp = jmlp.mlp_net_init(jax.random.PRNGKey(1), (4, 64, 64, 2))
    s = np.random.default_rng(batch).normal(size=(batch, 4)) \
        .astype(np.float32)
    want = np.asarray(jmlp.mlp_net_apply(jp, jnp.asarray(s),
                                         act=jax.nn.relu))
    got = tmlp.mlp_net_apply(params_from_reference(jp), torch.as_tensor(s),
                             act=torch.relu, rt=CPU)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_mlp_net_init_draws_from_the_generator():
    def init(seed):
        return tmlp.paper_mlp_init(torch.Generator().manual_seed(seed),
                                   device="cpu")

    a, b, c = init(0), init(0), init(1)
    assert tmodels.PAPER_LAYERS == (784, 128, 10)
    assert a["l0"]["w"].shape == (784, 128) and a["l1"]["w"].shape == (128, 10)
    assert (a["l1"]["b"] == 0).all() and a["l1"]["b"].shape == (10,)
    assert torch.equal(a["l0"]["w"], b["l0"]["w"])
    assert not torch.equal(a["l0"]["w"], c["l0"]["w"])
    # the reference's scale: unit normals over sqrt(fan_in)
    assert abs(float(a["l0"]["w"].std()) * 784 ** 0.5 - 1.0) < 0.02
    q = quantize_params(a, "sp2_4", min_size=1024)
    assert q["l1"]["w"].logical_shape == (128, 10) and q["l1"]["w"].packed
    assert tmodels.paper_mlp_apply is tmlp.paper_mlp_apply


# ---------------------------------------------------------------------------
# The paper's §4 experiments: training, the optimizers, SPx quantize, the
# §3.1 planner, Q-learning, and the example and benchmark entry points
# ---------------------------------------------------------------------------

def _digits(n=64, seed=7):
    x, y = make_dataset(n, seed=seed)
    return x, y, torch.as_tensor(x), torch.as_tensor(y)


def test_autograd_gradients_match_jax_grad(mlp):
    from repro_torch.training import value_and_grad
    x, y, tx, ty = _digits()
    jloss, jgrads = jax.value_and_grad(jmlp.paper_mlp_loss)(
        mlp["jparams"], jnp.asarray(x), jnp.asarray(y))
    params = params_from_reference(mlp["jparams"])
    loss, grads = value_and_grad(tmlp.paper_mlp_loss, params, tx, ty)
    assert abs(float(loss) - float(jloss)) <= 1e-6
    for layer in ("l0", "l1"):
        for leaf in ("w", "b"):
            np.testing.assert_allclose(grads[layer][leaf].numpy(),
                                       np.asarray(jgrads[layer][leaf]),
                                       rtol=0, atol=1e-6)
    # the params themselves stay leaves without gradients
    assert not params["l0"]["w"].requires_grad


def test_sgd_training_matches_reference(mlp):
    """20 steps of the paper's rule (SGD lr 0.5, B = 64) on the same
    SynthDigits batches from the same weights."""
    from repro.training import make_optimizer as jmake_optimizer
    from repro_torch.training import make_optimizer, value_and_grad
    jopt, opt = jmake_optimizer("sgd", lr=0.5), make_optimizer("sgd", lr=0.5)

    @jax.jit
    def jstep(p, s, x, y):
        _, g = jax.value_and_grad(jmlp.paper_mlp_loss)(p, x, y)
        return jopt.update(p, g, s)

    jp, js = mlp["jparams"], jopt.init(mlp["jparams"])
    tp = params_from_reference(mlp["jparams"])
    ts = opt.init(tp)
    it = SynthDigits(n_train=1280, n_test=16, batch_size=64).batches()
    for _ in range(20):
        x, y = next(it)
        jp, js = jstep(jp, js, jnp.asarray(x), jnp.asarray(y))
        _, g = value_and_grad(tmlp.paper_mlp_loss, tp, torch.as_tensor(x),
                              torch.as_tensor(y))
        tp, ts = opt.update(tp, g, ts)
    assert ts["step"] == int(js["step"]) == 20
    for layer in ("l0", "l1"):
        for leaf in ("w", "b"):
            np.testing.assert_allclose(tp[layer][leaf].numpy(),
                                       np.asarray(jp[layer][leaf]),
                                       rtol=0, atol=1e-5)


@pytest.mark.parametrize("name,kw", [
    ("sgd", dict(momentum=0.9)),
    ("adamw", {}),
    ("adamw", dict(weight_decay=0.1)),
], ids=["sgd-momentum", "adamw", "adamw-decay"])
def test_optimizer_steps_match_reference(name, kw):
    from repro.training import make_optimizer as jmake_optimizer
    from repro_torch.training import make_optimizer
    rng = np.random.default_rng(3)
    shapes = {"l0": {"w": (6, 4), "b": (4,)}, "l1": {"w": (4, 3)}}
    leaf = lambda s: rng.standard_normal(s).astype(np.float32)
    p = {k: {n: leaf(s) for n, s in v.items()} for k, v in shapes.items()}
    grads = [{k: {n: leaf(s) for n, s in v.items()}
              for k, v in shapes.items()} for _ in range(2)]
    jopt, opt = jmake_optimizer(name, lr=1e-2, **kw), \
        make_optimizer(name, lr=1e-2, **kw)
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    js = jopt.init(jp)
    tp = params_from_reference(p)
    ts = opt.init(tp)
    for g in grads:                        # one step, then one more
        jp, js = jopt.update(jp, jax.tree_util.tree_map(jnp.asarray, g), js)
        tp, ts = opt.update(tp, params_from_reference(g), ts)
        for k, v in shapes.items():
            for n in v:
                np.testing.assert_allclose(tp[k][n].numpy(),
                                           np.asarray(jp[k][n]),
                                           rtol=1e-6, atol=1e-7)


def test_optimizer_helpers_match_reference():
    from repro.training import clip_by_global_norm as jclip
    from repro.training import global_norm as jglobal_norm
    from repro_torch.training import (clip_by_global_norm, global_norm,
                                      make_optimizer)
    rng = np.random.default_rng(4)
    g = {"a": rng.standard_normal((5, 3)).astype(np.float32),
         "b": [rng.standard_normal(7).astype(np.float32)]}
    jg = jax.tree_util.tree_map(jnp.asarray, g)
    tg = params_from_reference(g)
    assert abs(float(global_norm(tg)) - float(jglobal_norm(jg))) <= 1e-5
    for max_norm in (0.5, 100.0):
        (clipped, norm), (jclipped, jnorm) = clip_by_global_norm(
            tg, max_norm), jclip(jg, max_norm)
        assert abs(float(norm) - float(jnorm)) <= 1e-5
        np.testing.assert_allclose(clipped["a"].numpy(),
                                   np.asarray(jclipped["a"]), atol=1e-7)
    with pytest.raises(NotImplementedError, match="Training the LM"):
        make_optimizer("adamw_q8", lr=1e-3)
    with pytest.raises(ValueError, match="unknown optimizer"):
        make_optimizer("lion", lr=1e-3)


@pytest.mark.parametrize("scheme", ["sp2_4", "pot4", "uniform8", "sp2_8",
                                    "spx_8_x3"])
def test_spx_quantize_and_fake_quantize_match_reference(scheme):
    from repro.core import spx as jspx
    from repro_torch.core import spx as tspx
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((64, 48)) * 0.1).astype(np.float32)
    scale = np.abs(x).max(axis=0, keepdims=True) * 0.8
    # values on the midpoints of the scaled levels: the tie rule
    mids = jspx.scheme_levels(scheme)
    x[0, :5] = ((mids[1:6] + mids[:5]) / 2 * scale[0, :5]).astype(np.float32)
    codes = tspx.quantize(torch.as_tensor(x), scheme, torch.as_tensor(scale))
    jcodes = jspx.quantize(jnp.asarray(x), scheme, jnp.asarray(scale))
    assert codes.dtype == torch.uint8
    assert np.array_equal(codes.numpy(), np.asarray(jcodes))
    for dtype, jdtype in ((None, None), (torch.float32, jnp.float32)):
        got = tspx.fake_quantize(torch.as_tensor(x), scheme,
                                 torch.as_tensor(scale), dtype=dtype)
        want = jspx.fake_quantize(jnp.asarray(x), scheme, jnp.asarray(scale),
                                  dtype=jdtype)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-7)


_PLAN_CASES = [(4096, 4096, 4096, 4), (8192, 8192, 8192, 16),
               (8192, 8192, 8192, 4), (1024, 128, 784, 16),
               (1024, 128, 784, 4), (4096, 4096, 4096, 16),
               (8192, 12800, 4096, 16), (8192, 12800, 4096, 4)]


@pytest.mark.parametrize("m,n,k,bits", _PLAN_CASES)
def test_plan_matmul_blocks_matches_reference(m, n, k, bits):
    """The same HwSpec fields (the reference's TPU v5e, built here: the
    port carries no TPU constant) give the reference's BlockPlan."""
    from repro.core import pipeline as jpipe
    from repro_torch.core import pipeline as tpipe
    hw = tpipe.HwSpec(**dataclasses.asdict(jpipe.TPU_V5E))
    got = tpipe.plan_matmul_blocks(m, n, k, weight_bits=bits, hw=hw)
    want = jpipe.plan_matmul_blocks(m, n, k, weight_bits=bits)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.margin == want.margin


def test_h100_plan_fits_shared_memory():
    """On H100_SXM (the port's default) 4-bit weights fit a 128-tile in a
    block's shared memory; 16-bit weights fit no candidate and fall back
    to one 64-row wgmma tile; 4 bits widen the margin."""
    from repro_torch.core.pipeline import H100_SXM, plan_matmul_blocks
    assert (H100_SXM.vmem_bytes, H100_SXM.mxu_dim) == (227 * 1024, 64)
    for m, n, k in ((1024, 128, 784), (4096, 4096, 4096),
                    (8192, 12800, 4096)):
        p4 = plan_matmul_blocks(m, n, k, weight_bits=4)
        p16 = plan_matmul_blocks(m, n, k, weight_bits=16)
        assert (p4.bm, p4.bn, p4.bk) == (128, 128, 128)
        assert p4.vmem_bytes <= 0.9 * H100_SXM.vmem_bytes
        assert (p16.bm, p16.bn, p16.bk) == (64, 64, 64)
        assert p4.margin >= p16.margin


def test_port_training_reaches_reference_accuracy():
    """The port alone (torch init, autograd, its SGD) trains the paper MLP
    as ``tests/test_system.py`` trains the reference's: 300 steps to test
    accuracy above 0.9, and SPx deployment within 0.01 (8-bit), 0.02
    (sp2_4) and 0.03 (pot4) of it, each quantized layer through the
    plain ``spx_matmul``."""
    from repro_torch.training import make_optimizer, value_and_grad
    data = SynthDigits(n_train=4096, n_test=512, batch_size=64, seed=0)
    params = tmlp.paper_mlp_init(torch.Generator().manual_seed(0),
                                 device="cpu")
    opt = make_optimizer("sgd", lr=0.5)
    state = opt.init(params)
    it = data.batches(epochs=100)
    for _ in range(300):
        x, y = next(it)
        _, g = value_and_grad(tmlp.paper_mlp_loss, params,
                              torch.as_tensor(x), torch.as_tensor(y))
        params, state = opt.update(params, g, state)
    x_test, y_test = torch.as_tensor(data.x_test), torch.as_tensor(
        data.y_test)

    def acc(p):
        return float((tmlp.paper_mlp_predict(p, x_test, CPU) == y_test)
                     .float().mean())

    base = acc(params)
    assert base > 0.9
    for scheme, tol in (("sp2_8", 0.01), ("spx_8_x3", 0.01),
                        ("sp2_4", 0.02), ("pot4", 0.03)):
        ops.reset_op_calls()
        got = acc(quantize_params(params, scheme, min_size=1024))
        assert ops.ref_calls() == {"spx_matmul": 2}
        assert got > base - tol, (scheme, got, base)


def _reference_rl():
    """The reference's examples/rl_qlearning.py (outside its package)."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "examples" / \
        "rl_qlearning.py"
    spec = importlib.util.spec_from_file_location("_reference_rl", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_cartpole_matches_reference():
    from repro_torch.examples.rl_qlearning import CartPole
    jenv, env = _reference_rl().CartPole(7), CartPole(7)
    assert np.array_equal(jenv.reset(), env.reset())
    actions = np.random.default_rng(1).integers(0, 2, 300)
    for a in actions:
        (js, jr, jd), (s, r, d) = jenv.step(int(a)), env.step(int(a))
        assert np.array_equal(js, s) and jr == r and jd == d
        if d:
            assert np.array_equal(jenv.reset(), env.reset())


def test_q_learning_train_step_matches_reference():
    """One TD step of the (4, 64, 64, 2) Q-network with AdamW (lr 1e-3),
    written as the reference's ``train_step`` writes it."""
    from repro.training import make_optimizer as jmake_optimizer
    from repro_torch.examples.rl_qlearning import GAMMA, Q_LAYERS, train_step
    from repro_torch.training import make_optimizer
    jp = jmlp.mlp_net_init(jax.random.PRNGKey(2), Q_LAYERS)
    rng = np.random.default_rng(8)
    s = rng.normal(size=(64, 4)).astype(np.float32)
    s2 = rng.normal(size=(64, 4)).astype(np.float32)
    a = rng.integers(0, 2, 64).astype(np.int32)
    r = np.ones(64, np.float32)
    d = (rng.random(64) < 0.1).astype(np.float32)
    jopt = jmake_optimizer("adamw", lr=1e-3)

    def jloss(p, target):
        q = jmlp.mlp_net_apply(p, jnp.asarray(s), act=jax.nn.relu)
        q_sa = jnp.take_along_axis(q, jnp.asarray(a)[:, None], axis=-1)[:, 0]
        return jnp.mean((q_sa - jax.lax.stop_gradient(target)) ** 2)

    q_next = jnp.max(jmlp.mlp_net_apply(jp, jnp.asarray(s2),
                                        act=jax.nn.relu), axis=-1)
    target = jnp.asarray(r) + GAMMA * q_next * (1.0 - jnp.asarray(d))
    loss, grads = jax.value_and_grad(jloss)(jp, target)
    want, _ = jopt.update(jp, grads, jopt.init(jp))

    opt = make_optimizer("adamw", lr=1e-3)
    tp = params_from_reference(jp)
    t = torch.as_tensor
    got, state, tloss = train_step(tp, opt, opt.init(tp), t(s), t(a), t(r),
                                   t(s2), t(d))
    assert state["step"] == 1 and abs(float(tloss) - float(loss)) <= 1e-5
    for i in range(3):
        for leaf in ("w", "b"):
            np.testing.assert_allclose(got[f"l{i}"][leaf].numpy(),
                                       np.asarray(want[f"l{i}"][leaf]),
                                       rtol=0, atol=1e-5)


def test_examples_and_benchmarks_run_on_the_cpu():
    """Each entry point runs to its end on the CPU at a small size, and its
    quantized arms go through ``spx_matmul`` (its plain version here)."""
    from repro_torch.benchmarks import fig5, quant_quality, table1
    from repro_torch.examples import quickstart, rl_qlearning
    ops.reset_op_calls()
    results = quickstart.main(["--epochs", "1"], device="cpu")
    assert set(results) == {"float32", *quickstart.SCHEMES}
    assert results["float32"] > 0.5
    assert ops.ref_calls() == {"spx_matmul": 2 * len(quickstart.SCHEMES)}

    ops.reset_op_calls()
    out = rl_qlearning.main(["--episodes", "3"], device="cpu")
    assert len(out["returns"]) == 3
    assert set(out["eval"]) == {"float32", "sp2_8", "sp2_4"}
    assert ops.ref_calls()["spx_matmul"] > 0

    csv = []
    ops.reset_op_calls()
    rows = table1.run(csv, device="cpu", iters=1, min_seconds=0.0)
    assert [r["name"] for r in rows] == [
        "fp32_b1", "sp2_4_b1", "fp32_b1024", "sp2_4_b1024",
        "paper_cpu", "paper_gpu", "paper_fpga"]
    assert all(r["s_per_sample"] > 0 for r in rows)
    assert all(r["j_per_sample"] is None for r in rows[:4])   # no card
    assert ops.ref_calls() == {"spx_matmul": 2 * (3 + 1) * 2}
    ops.reset_op_calls()
    fig5.run(csv, device="cpu", iters=1)
    assert ops.ref_calls() == {"spx_matmul": 2 * (3 + 1) * 5}
    ops.reset_op_calls()
    quant_quality.run(csv, device="cpu", steps=1)
    assert ops.ref_calls() == {"spx_matmul": 2 * len(quant_quality.SCHEMES)}
    names = [row[0] for row in csv]
    assert "fig5/pipe_1024x128x784_w4" in names
    assert "quant/sp2_4_acc" in names and "table1/paper_fpga" in names
