"""Reference params carried into the port (``repro_torch.interop``): the
per-period stacking survives, and quantized leaves arrive as the same
uint8 codes, f32 scale, scheme and packing."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config, reduced
from repro.core.quantized import QuantizedTensor as JQT
from repro.models import lm as jlm
from repro.nn.layers import quantize_params as jquantize
from repro_torch.core.quantized import QuantizedTensor, dequantize
from repro_torch.interop import params_from_reference


@pytest.fixture(scope="module", autouse=True)
def _fresh_jax_caches():
    """Drop this module's compiled JAX steps when it ends: a later module
    on the same worker (tests/test_fused_decode.py) counts the compiles
    of the reference's fused step."""
    yield
    jax.clear_caches()


def _cfg():
    return dataclasses.replace(
        reduced(get_config("gemma-2b"), n_layers=3, vocab=32), head_dim=128)


def test_dense_params_keep_structure_and_stacking():
    cfg = _cfg()
    jp = jlm.lm_init(jax.random.PRNGKey(0), cfg)
    tp = params_from_reference(jp)
    jleaves = jax.tree_util.tree_leaves_with_path(jp)
    assert len(jleaves) > 0
    for path, leaf in jleaves:
        node = tp
        for key in path:
            node = node[getattr(key, "key", getattr(key, "idx", None))]
        assert isinstance(node, torch.Tensor)
        assert node.dtype == torch.float32
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    wq = tp["stack"]["slots"][0]["attn"]["wq"]["w"]
    assert wq.shape == (cfg.n_periods, cfg.d_model, cfg.n_heads * cfg.dh)


def test_quantized_params_carry_codes_scale_scheme_packing():
    cfg = _cfg()
    jp = jquantize(jlm.lm_init(jax.random.PRNGKey(1), cfg), "sp2_4")
    tp = params_from_reference(jp)
    jqts = [(p, l) for p, l in jax.tree_util.tree_leaves_with_path(
        jp, is_leaf=lambda x: isinstance(x, JQT)) if isinstance(l, JQT)]
    assert len(jqts) == 7                     # wq wk wv wo up down gate
    for path, jqt in jqts:
        node = tp
        for key in path:
            node = node[getattr(key, "key", getattr(key, "idx", None))]
        assert isinstance(node, QuantizedTensor)
        assert (node.scheme, node.packed) == (jqt.scheme, jqt.packed)
        assert node.codes.dtype == torch.uint8
        assert node.codes.shape[0] == cfg.n_periods
        np.testing.assert_array_equal(node.codes.numpy(),
                                      np.asarray(jqt.codes))
        np.testing.assert_array_equal(node.scale.numpy(),
                                      np.asarray(jqt.scale))
        np.testing.assert_array_equal(
            dequantize(node).numpy(),
            np.asarray(jqt.dequantize(dtype=jnp.float32)))
        # one period sliced out is the 2-D weight the kernels take
        assert node[1].logical_shape == jqt.logical_shape[1:]
    # embedding table and norm gains stay dense
    assert isinstance(tp["embed"]["table"], torch.Tensor)
    assert isinstance(tp["stack"]["slots"][0]["norm1"]["g"], torch.Tensor)
