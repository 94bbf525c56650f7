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
* ``mlp_net_init`` draws from an explicit ``torch.Generator``.

The kernel at these shapes (K = 784 and 128, N = 128 and 10) is held
against its plain version on the card by ``tests/test_torch_kernels.py``
(``gpu``) and ``chip_smoke.py``."""
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
