"""The port's paged LM steps against the JAX reference on identical weights,
block tables and inputs: ``lm_paged_step`` (a prefill chunk, then a
one-token chunk through ``paged_attention``) and ``lm_paged_fused_step``
(plain decode and a ragged window through ``paged_decode_ragged``) give
the same logits and leave the same page pools, step after step."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config, reduced
from repro.models import lm as jlm
from repro.nn.layers import quantize_params as jquantize
from repro.runtime import Runtime as JRuntime
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import reduced as treduced
from repro_torch.interop import params_from_reference
from repro_torch.kernels import ops
from repro_torch.models import lm as tlm
from repro_torch.runtime import Runtime

TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def _fresh_jax_caches():
    """Drop this module's compiled JAX steps when it ends: a later module
    on the same worker (tests/test_fused_decode.py) counts the compiles
    of the reference's fused step."""
    yield
    jax.clear_caches()


def _cfgs():
    j = dataclasses.replace(
        reduced(get_config("gemma-2b"), n_layers=2, vocab=32), head_dim=128)
    t = dataclasses.replace(
        treduced(tget_config("gemma-2b"), n_layers=2, vocab=32),
        head_dim=128)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    return j, t


@pytest.mark.parametrize("quantized", [True, False])
def test_paged_steps_match_reference(quantized):
    jcfg, tcfg = _cfgs()
    jp = jlm.lm_init(jax.random.PRNGKey(3), jcfg)
    if quantized:
        jp = jquantize(jp, "sp2_4")
    tp = params_from_reference(jp)
    jrt, trt = JRuntime(impl="ref", q_chunk=16), Runtime(device="cpu")
    n_pages, ps = 8, 8
    jc = jlm.paged_init_caches(jcfg, n_pages, ps, dtype=jnp.float32)
    tc = tlm.paged_init_caches(tcfg, n_pages, ps, dtype=torch.float32,
                               device="cpu")
    bt = np.array([[3, 0, 5, 1], [2, 7, 4, 6]], np.int32)
    sidx = jnp.zeros((2, 2), jnp.int32)
    rng = np.random.default_rng(0)

    def both(fused, tokens, ctx, nv):
        args = [np.asarray(a, np.int32) for a in (tokens, ctx, bt, nv)]
        jfn = jlm.lm_paged_fused_step if fused else jlm.lm_paged_step
        tfn = tlm.lm_paged_fused_step if fused else tlm.lm_paged_step
        jl, jc_new = jfn(jp, *(jnp.asarray(a) for a in args), sidx, jc,
                         jcfg, jrt)
        tl, _ = tfn(tp, *(torch.from_numpy(a) for a in args), tc, tcfg, trt)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        for js, ts in zip(jc_new, tc):
            for k in ("kp", "vp"):
                np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]),
                                           **TOL)
        return jc_new

    ops.reset_op_calls()
    # prefill chunk of 8 (ragged: row 1 holds 5 valid tokens)
    jc = both(False, rng.integers(0, 32, (2, 8)), [0, 0], [8, 5])
    # one-token chunk: the paged_attention path
    jc = both(False, rng.integers(0, 32, (2, 1)), [8, 5], [1, 1])
    # fused decode tick, one slot inactive
    jc = both(True, rng.integers(0, 32, (2, 1)), [9, 6], [1, 0])
    # fused ragged window of 3 across a page boundary
    jc = both(True, rng.integers(0, 32, (2, 3)), [10, 6], [3, 2])
    calls = ops.ref_calls()
    assert calls["paged_attention"] == jcfg.n_layers
    assert calls["paged_decode_ragged"] == 2 * jcfg.n_layers
    assert calls.get("spx_matmul", 0) == (4 * 7 * jcfg.n_layers if quantized
                                           else 0)
    assert ops.op_calls() == {}
