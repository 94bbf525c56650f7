"""The port's SPx core (``repro_torch.core``) against the JAX reference:
for every scheme, codes are bit-identical — values exactly on a midpoint
included — and calibrated scales are equal, through quantize_to_codes,
calibrate_mse, quantize_weight and the int4 packing."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import quantized as jq
from repro.core import spx as jspx
from repro_torch.core import quantized as tq
from repro_torch.core import spx as tspx

SCHEMES = sorted(jspx.SCHEMES)


def _weight(seed: int, shape=(96, 40)) -> np.ndarray:
    """Heavy-tailed f32 weights (student-t), so the MSE sweep has a real
    optimum away from max|w|."""
    rng = np.random.default_rng(seed)
    return (rng.standard_t(3, size=shape) * 0.05).astype(np.float32)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_codes_scales_and_packing_match_reference(scheme):
    levels = jspx.scheme_levels(scheme)
    np.testing.assert_array_equal(tspx.scheme_levels(scheme), levels)
    np.testing.assert_array_equal(tspx.codebook(levels).numpy(),
                                  np.asarray(jspx.codebook(levels)))

    w = _weight(SCHEMES.index(scheme))
    # exact f32 midpoints (unit scale) must take the lower level in both
    mids = jnp.asarray(jspx._midpoints(levels), jnp.float32)
    w[0, :len(mids)] = np.asarray(mids)[:w.shape[1]]
    scale = np.ones((1, w.shape[1]), np.float32)
    want = np.asarray(jspx.quantize_to_codes(jnp.asarray(w), levels,
                                             jnp.asarray(scale)))
    got = tspx.quantize_to_codes(torch.from_numpy(w), levels,
                                 torch.from_numpy(scale)).numpy()
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)

    # MSE calibration: same per-channel alpha, bit for bit
    want_s = np.asarray(jspx.calibrate_mse(jnp.asarray(w), scheme, axes=(-2,)))
    got_s = tspx.calibrate_mse(torch.from_numpy(w), scheme, axes=(-2,)).numpy()
    np.testing.assert_array_equal(got_s, want_s)

    # the deployment step, stacked over a leading period dim
    ws = np.stack([w, _weight(100 + SCHEMES.index(scheme))])
    jqt = jq.quantize_weight(jnp.asarray(ws), scheme)
    tqt = tq.quantize_weight(torch.from_numpy(ws), scheme)
    assert tqt.packed == jqt.packed and tqt.scheme == jqt.scheme
    np.testing.assert_array_equal(tqt.codes.numpy(), np.asarray(jqt.codes))
    np.testing.assert_array_equal(tqt.scale.numpy(), np.asarray(jqt.scale))
    np.testing.assert_array_equal(
        tq.dequantize(tqt).numpy(),
        np.asarray(jq.dequantize(jqt, dtype=jnp.float32)))


@pytest.mark.parametrize("shape", [(7, 8), (3, 5, 16)])
def test_int4_pack_roundtrip_matches_reference(shape):
    rng = np.random.default_rng(sum(shape))
    codes = rng.integers(0, 16, shape).astype(np.uint8)
    want = np.asarray(jspx.pack_int4(jnp.asarray(codes)))
    got = tspx.pack_int4(torch.from_numpy(codes)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[..., 0] & 0x0F == codes[..., 0]).all()      # low = even
    np.testing.assert_array_equal(
        tspx.unpack_int4(torch.from_numpy(got)).numpy(), codes)
    np.testing.assert_array_equal(
        np.asarray(jspx.unpack_int4(jnp.asarray(want))), codes)


def test_pack_int4_rejects_odd_last_dim():
    with pytest.raises(ValueError, match="even last dim"):
        tspx.pack_int4(torch.zeros((2, 3), dtype=torch.uint8))
