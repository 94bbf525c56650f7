"""The port's kernel ops against the JAX reference on the CPU, where they
take their plain PyTorch versions; the JAX side runs the Pallas kernel
bodies in interpret mode (the quantized paged kernels and the flash
kernel: ``test_torch_kv_quant.py``, ``test_torch_dense.py``). The tests
marked ``gpu`` hold each CUDA kernel against its plain version on the
card and skip without one:

    python -m pytest -m gpu tests/test_torch_kernels.py

JAX is imported inside a fixture, so the file also collects where JAX is
not installed (the card's machine)."""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import quantized as tq
from repro_torch.kernels import ops, ref
from repro_torch.runtime import registry


@pytest.fixture(scope="module")
def jx():
    import jax.numpy as jnp
    from repro.core import quantized as jq
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    return types.SimpleNamespace(jnp=jnp, jq=jq, ops=jops, ref=jref)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("scheme,lead", [("sp2_4", (5,)), ("sp2_4", (2, 3)),
                                         ("sp2_8", (5,)), ("sp2_8", (1,))])
def test_spx_matmul_matches_interpret_kernel(jx, scheme, lead):
    rng = np.random.default_rng(len(lead) + len(scheme))
    k, n = 256, 384
    w = rng.standard_normal((k, n)).astype(np.float32) * 0.05
    x = rng.standard_normal(lead + (k,)).astype(np.float32)
    jqt = jx.jq.quantize_weight(jx.jnp.asarray(w), scheme)
    want = np.asarray(jx.ops.spx_matmul(jx.jnp.asarray(x), jqt,
                                        impl="interpret"))
    tqt = tq.QuantizedTensor(_t(jqt.codes), _t(jqt.scale), scheme,
                             bool(jqt.packed))
    assert tqt.packed == (scheme == "sp2_4")
    ops.reset_op_calls()
    got = ops.spx_matmul(torch.from_numpy(x), tqt).numpy()
    assert got.shape == lead + (n,)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # a CPU tensor takes the plain version; nothing launched
    assert ops.ref_calls() == {"spx_matmul": 1}
    assert ops.op_calls() == {}


def _pools(rng, b, hkv, ps, max_pages, dh):
    n_pages = 1 + b * max_pages
    kp = rng.standard_normal((n_pages, hkv, ps, dh)).astype(np.float32)
    vp = rng.standard_normal((n_pages, hkv, ps, dh)).astype(np.float32)
    bt = rng.integers(0, n_pages, (b, max_pages)).astype(np.int32)
    return kp, vp, bt


@pytest.mark.parametrize("w,ctx,qlen", [
    (4, [0, 7, 8, 9], [0, 1, 3, 4]),          # q_len 0..w, page straddles
    (1, [0, 7, 8, 25], [0, 1, 1, 1]),         # plain decode window
    (3, [16, 3, 15, 0], [2, 3, 0, 1]),
])
def test_paged_decode_ragged_matches_interpret_kernel(jx, w, ctx, qlen):
    rng = np.random.default_rng(11 + w)
    b, hq, hkv, dh, ps, mp = 4, 4, 2, 32, 8, 4
    kp, vp, bt = _pools(rng, b, hkv, ps, mp, dh)
    q = rng.standard_normal((b, w, hq, dh)).astype(np.float32)
    args = (q, kp, vp, bt, np.asarray(ctx, np.int32),
            np.asarray(qlen, np.int32))
    want = np.asarray(jx.ops.paged_decode_ragged(
        *(jx.jnp.asarray(a) for a in args), impl="interpret"))
    got = ops.paged_decode_ragged(*(torch.from_numpy(a) for a in args)).numpy()
    assert got.shape == (b, w, hq, dh)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    for row, n in enumerate(qlen):
        assert (got[row, n:] == 0).all()       # exact zeros past q_len
        if n:
            assert (got[row, :n] != 0).any()


def test_paged_attention_matches_interpret_kernel(jx):
    rng = np.random.default_rng(5)
    b, hq, hkv, dh, ps, mp = 4, 4, 2, 32, 8, 3
    kp, vp, bt = _pools(rng, b, hkv, ps, mp, dh)
    q = rng.standard_normal((b, hq, dh)).astype(np.float32)
    ctx = np.asarray([0, 1, ps, 2 * ps + 3], np.int32)
    args = (q, kp, vp, bt, ctx)
    want = np.asarray(jx.ops.paged_attention(
        *(jx.jnp.asarray(a) for a in args), impl="interpret"))
    got = ops.paged_attention(*(torch.from_numpy(a) for a in args)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert (got[0] == 0).all()                 # ctx_len == 0 -> zeros


def _bf16_case(rng, dh, ps, w, dtype=torch.bfloat16):
    """Kernels 2 and 5 over bf16 (or ``dtype``) pages: 4 slots, 2 KV heads
    under rep 2, 3 pages per slot. Slot 0 is empty (ctx_len 0), slot 1's
    window crosses a page boundary (ctx = ps - 2), slot 2 ends one token
    into its last page. The page values are made in torch and handed to
    JAX as the f32 values they are, so both sides hold the same pages."""
    b, hkv, rep, mp = 4, 2, 2, 3
    n_pages = 1 + b * mp
    kp, vp = (torch.from_numpy(rng.standard_normal(
        (n_pages, hkv, ps, dh)).astype(np.float32)).to(dtype)
        for _ in range(2))
    bt = rng.permutation(n_pages)[:b * mp].reshape(b, mp).astype(np.int32)
    q = rng.standard_normal((b, w, hkv * rep, dh)).astype(np.float32)
    ctx = np.asarray([0, ps - 2, 2 * ps + 1 - w, 3 * ps - w], np.int32)
    qlen = np.asarray([0, w, max(1, w - 2), w], np.int32)
    return q, kp, vp, bt, ctx, qlen


def _jbf16(jx, t):
    """A torch bf16 (or f16) tensor as the JAX array of the same dtype."""
    return jx.jnp.asarray(t.float().numpy()).astype(
        getattr(jx.jnp, str(t.dtype).replace("torch.", "")))


def _slot_rel_err(got, want) -> float:
    """The largest over slots (axis 0) of max|got - want| over that slot's
    own max|want|: a long slot's outputs are far smaller than a one-token
    slot's, so one peak over all slots would hide an error there. A slot
    whose ``want`` is all zeros counts as inf unless ``got``'s is too."""
    got, want = np.asarray(got), np.asarray(want)
    b = want.shape[0]
    err = np.abs(got - want).reshape(b, -1).max(1)
    peak = np.abs(want).reshape(b, -1).max(1)
    rel = np.where(peak > 0, err / np.maximum(peak, 1e-30),
                   np.where(err > 0, np.inf, 0.0))
    return float(rel.max())


@pytest.mark.parametrize("w", [1, 5])
@pytest.mark.parametrize("ps", [16, 32])
@pytest.mark.parametrize("dh", [32, 64, 128, 256])
def test_bf16_pages_plain_versions_match_reference(jx, dh, ps, w):
    """The port's plain versions of kernels 2 and 5 over bf16 pages (upcast
    after the gather, probabilities in f32) against the reference oracle
    on the same pages, within 1e-5 of the largest |output|, and against
    the Pallas kernels in interpret mode, which round each probability to
    bf16 before P @ V (``pv.astype(v.dtype)``), within 1e-2 of each slot's
    own largest |output|."""
    from repro.kernels.paged_attention import (paged_attention_pallas,
                                               paged_decode_ragged_pallas)
    rng = np.random.default_rng(dh + ps + w)
    q, kp, vp, bt, ctx, qlen = _bf16_case(rng, dh, ps, w)
    t = lambda a: torch.from_numpy(a)
    ops.reset_op_calls()
    got = ops.paged_decode_ragged(t(q), kp, vp, t(bt), t(ctx),
                                  t(qlen)).numpy()
    assert ops.ref_calls() == {"paged_decode_ragged": 1}
    assert ops.op_calls() == {}
    b, _, hq, _ = q.shape
    hkv = kp.shape[1]
    # the reference's (B, Hkv, rep * w, dh) rep-major rows
    q4 = q.reshape(b, w, hkv, hq // hkv, dh).transpose(0, 2, 3, 1, 4) \
        .reshape(b, hkv, -1, dh)
    j = (jx.jnp.asarray(q4), _jbf16(jx, kp), _jbf16(jx, vp),
         jx.jnp.asarray(bt), jx.jnp.asarray(ctx), jx.jnp.asarray(qlen))
    unpack = lambda o: np.asarray(o).reshape(b, hkv, hq // hkv, w, dh) \
        .transpose(0, 3, 1, 2, 4).reshape(b, w, hq, dh)
    oracle = unpack(jx.ref.paged_decode_ragged_ref(*j, w=w))
    pallas = unpack(paged_decode_ragged_pallas(*j, w=w, interpret=True))
    peak = np.abs(oracle).max()
    assert np.abs(got - oracle).max() <= 1e-5 * peak
    assert _slot_rel_err(got, pallas) <= 1e-2
    for row, n in enumerate(qlen):
        assert (got[row, n:] == 0).all()

    # kernel 5: one query token per slot, positions < ctx_len attended
    ctx1 = np.asarray([0, 1, ps, 3 * ps], np.int32)
    q1 = np.ascontiguousarray(q[:, 0])
    got = ops.paged_attention(t(q1), kp, vp, t(bt), t(ctx1)).numpy()
    q14 = jx.jnp.asarray(q1.reshape(b, hkv, hq // hkv, dh))
    j1 = (q14, j[1], j[2], j[3], jx.jnp.asarray(ctx1))
    oracle = np.asarray(jx.ref.paged_attention_ref(*j1)).reshape(b, hq, dh)
    pallas = np.asarray(paged_attention_pallas(*j1, interpret=True)) \
        .reshape(b, hq, dh)
    peak = np.abs(oracle).max()
    assert np.abs(got - oracle).max() <= 1e-5 * peak
    assert _slot_rel_err(got, pallas) <= 1e-2
    assert (got[0] == 0).all()


#: f16 pages: the plain versions' largest error in a slot, over that slot's
#: largest |output|, against the reference oracle (probabilities in f32)
#: and against the Pallas kernels (each probability rounded to f16 at the
#: page's running max): the bf16 bound of 1e-2 over 2^3, f16 carrying
#: three more significand bits (measured: up to 2.6e-4)
F16_SLOT_RTOL = 1e-2 / 8


@pytest.mark.parametrize("w", [1, 5])
@pytest.mark.parametrize("dh", [32, 128])
def test_f16_pages_plain_versions_match_reference(jx, dh, w):
    """The port's plain versions of kernels 2 and 5 over f16 pages (upcast
    after the gather; each probability rounded to f16 before P @ V, as the
    TPU kernel's ``pv.astype(v.dtype)`` does) against the reference oracle
    and the Pallas kernels in interpret mode on the same pages, within
    F16_SLOT_RTOL of each slot's largest |output|."""
    from repro.kernels.paged_attention import (paged_attention_pallas,
                                               paged_decode_ragged_pallas)
    ps = 16
    rng = np.random.default_rng(dh + ps + w + 1)
    q, kp, vp, bt, ctx, qlen = _bf16_case(rng, dh, ps, w, torch.float16)
    t = lambda a: torch.from_numpy(a)
    ops.reset_op_calls()
    got = ops.paged_decode_ragged(t(q), kp, vp, t(bt), t(ctx),
                                  t(qlen)).numpy()
    assert ops.ref_calls() == {"paged_decode_ragged": 1}
    assert ops.op_calls() == {}
    b, _, hq, _ = q.shape
    hkv = kp.shape[1]
    q4 = q.reshape(b, w, hkv, hq // hkv, dh).transpose(0, 2, 3, 1, 4) \
        .reshape(b, hkv, -1, dh)
    j = (jx.jnp.asarray(q4), _jbf16(jx, kp), _jbf16(jx, vp),
         jx.jnp.asarray(bt), jx.jnp.asarray(ctx), jx.jnp.asarray(qlen))
    unpack = lambda o: np.asarray(o).reshape(b, hkv, hq // hkv, w, dh) \
        .transpose(0, 3, 1, 2, 4).reshape(b, w, hq, dh)
    for want in (jx.ref.paged_decode_ragged_ref(*j, w=w),
                 paged_decode_ragged_pallas(*j, w=w, interpret=True)):
        assert _slot_rel_err(got, unpack(want)) <= F16_SLOT_RTOL
    for row, n in enumerate(qlen):
        assert (got[row, n:] == 0).all()

    ctx1 = np.asarray([0, 1, ps, 3 * ps], np.int32)
    q1 = np.ascontiguousarray(q[:, 0])
    got = ops.paged_attention(t(q1), kp, vp, t(bt), t(ctx1)).numpy()
    j1 = (jx.jnp.asarray(q1.reshape(b, hkv, hq // hkv, dh)), j[1], j[2],
          j[3], jx.jnp.asarray(ctx1))
    for want in (jx.ref.paged_attention_ref(*j1),
                 paged_attention_pallas(*j1, interpret=True)):
        assert _slot_rel_err(got, np.asarray(want).reshape(b, hq, dh)) \
            <= F16_SLOT_RTOL
    assert (got[0] == 0).all()


def f16_subnormal_case(device="cpu", n_tokens=64, dh=32):
    """f16 pages whose probabilities are f16 subnormals: every fourth
    position (the first of each of the kernel's 16-token chunks among
    them, so every running max already holds one) scores 12 over the
    rest and has V = 0;
    the others score 0 and have V = 1, so each of their probabilities,
    exp(-12) = 6.1e-6, lies below f16's normal range (6.1e-5) and the
    output, 3 round(exp(-12)) / (1 + 3 exp(-12)), is made of them alone:
    zero where they are flushed. 2 slots of one KV head, one query row;
    slot 1 attends half the context. Returns (q (B, 1, 1, dh), kp, vp,
    block_table, ctx, q_len)."""
    b, ps = 2, 16
    mp = n_tokens // ps
    k = torch.zeros((b * mp, 1, ps, dh))
    k[:, :, ::4, 0] = 1.0
    v = torch.ones((b * mp, 1, ps, dh))
    v[:, :, ::4] = 0.0
    q = torch.zeros((b, 1, 1, dh))
    q[..., 0] = 12.0 * dh ** 0.5
    bt = torch.arange(b * mp, dtype=torch.int32).reshape(b, mp)
    ctx = torch.tensor([n_tokens - 1, n_tokens // 2 - 1], dtype=torch.int32)
    return tuple(x.to(device) for x in (
        q, k.half(), v.half(), bt, ctx, torch.ones(b, dtype=torch.int32)))


def test_f16_subnormal_probabilities_are_kept(jx):
    """The plain version rounds subnormal probabilities as the Pallas
    kernel does (within 1e-5 of it), where flushing them would give
    zeros."""
    from repro.kernels.paged_attention import paged_decode_ragged_pallas
    q, kp, vp, bt, ctx, qlen = f16_subnormal_case()
    got = ops.paged_decode_ragged(q, kp, vp, bt, ctx, qlen).numpy()
    p = np.float32(np.exp(np.float32(-12.0)))
    want = 3 * np.float32(np.float16(p)) / (1 + 3 * p)
    assert np.float16(p) != 0 and np.float16(p) < np.finfo(np.float16).tiny
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # one KV head and one row: (B, W, Hq, dh) is (B, Hkv, R, dh)
    j = (jx.jnp.asarray(q.numpy()), _jbf16(jx, kp), _jbf16(jx, vp),
         jx.jnp.asarray(bt.numpy()), jx.jnp.asarray(ctx.numpy()),
         jx.jnp.asarray(qlen.numpy()))
    pallas = np.asarray(paged_decode_ragged_pallas(*j, w=1, interpret=True))
    np.testing.assert_allclose(got, pallas, rtol=1e-5)


def _split_case(rng, quant: bool):
    """Pools, block table and rows of a multi-page ragged case: 4 slots,
    2 KV heads of 32 under rep 2, 8-token pages (f32) or 16-token code
    pages (spx_8_x3), 6 pages per slot."""
    from repro_torch.nn.attention import kv_lut, quantize_kv
    b, hkv, rep, dh, mp = 4, 2, 2, 32, 6
    ps = 16 if quant else 8
    n_pages = 1 + b * mp
    k = rng.standard_normal((n_pages, hkv, ps, dh)).astype(np.float32)
    v = rng.standard_normal((n_pages, hkv, ps, dh)).astype(np.float32)
    bt = rng.permutation(n_pages)[:b * mp].reshape(b, mp).astype(np.int32)
    if not quant:
        return (k, v, bt), None, rep, ps
    kc, ks = quantize_kv(torch.from_numpy(k), "spx_8_x3")
    vc, vs = quantize_kv(torch.from_numpy(v), "spx_8_x3")
    lut = kv_lut("spx_8_x3")
    return ((kc.numpy(), vc.numpy(), bt),
            (ks.numpy(), vs.numpy(), lut.numpy()), rep, ps)


@pytest.mark.parametrize("splits", [1, 2, 5])
@pytest.mark.parametrize("quant", [False, True], ids=["f32", "spx_8_x3"])
def test_paged_decode_split_merge_matches_reference(jx, splits, quant):
    """The kernel's split-and-merge formula (``ref.paged_decode_split_ref``)
    against the JAX reference: ragged windows (w = 3, q_len 0..3, a context
    ending one token into a page, an empty slot) and the single-token
    mode against ``paged_attention_ref``."""
    rng = np.random.default_rng(17 + splits + 10 * quant)
    (kp, vp, bt), qz, rep, ps = _split_case(rng, quant)
    b, hkv, dh, w = 4, kp.shape[1], kp.shape[3], 3
    ctx = np.asarray([0, 2 * ps + 1 - 2, ps - 1, 6 * ps - 3], np.int32)
    qlen = np.asarray([0, 2, 1, 3], np.int32)
    q = rng.standard_normal((b, hkv, rep * w, dh)).astype(np.float32)
    t = [torch.from_numpy(a) for a in (q, kp, vp, bt, ctx, qlen)]
    quant_t = None if qz is None else tuple(torch.from_numpy(a) for a in qz)
    got = ref.paged_decode_split_ref(*t, w=w, splits=splits,
                                     quant=quant_t).numpy()
    j = [jx.jnp.asarray(a) for a in (q, kp, vp, bt, ctx, qlen)]
    if qz is None:
        want = jx.ref.paged_decode_ragged_ref(*j, w=w)
    else:
        jks, jvs, jlut = (jx.jnp.asarray(a) for a in qz)
        want = jx.ref.paged_decode_ragged_quant_ref(
            j[0], j[1], jks, j[2], jvs, j[3], j[4], j[5], jlut, w=w)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)
    rows_off = np.arange(rep * w) % w >= qlen[:, None]       # (B, R)
    assert (got.transpose(0, 2, 1, 3)[rows_off] == 0).all()

    ctx1 = np.asarray([0, 1, ps + 1, 6 * ps], np.int32)
    q1 = np.ascontiguousarray(q[:, :, :rep])
    got = ref.paged_decode_split_ref(
        torch.from_numpy(q1), t[1], t[2], t[3], torch.from_numpy(ctx1),
        splits=splits, quant=quant_t).numpy()
    j1 = [jx.jnp.asarray(a) for a in (q1, kp, vp, bt, ctx1)]
    if qz is None:
        want = jx.ref.paged_attention_ref(*j1)
    else:
        want = jx.ref.paged_attention_quant_ref(
            j1[0], j1[1], jks, j1[2], jvs, j1[3], j1[4], jlut)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)
    assert (got[0] == 0).all()


def test_decode_split_rule():
    """The wrapper's split count: about two blocks per SM, no split under
    16 tokens, and normalised to the kernel's split_tokens: ceil(tokens /
    splits) rounded up to 16."""
    from repro_torch.kernels.paged_attention import (decode_splits,
                                                     split_tokens)
    # gemma-2b decode tick: 4 slots x 1 KV head x 8 rows, 256 tokens
    assert decode_splits(4, 1, 8, 16, 16, 132) == 16
    assert decode_splits(4, 1, 8, 8, 32, 132) == 16       # code pages
    assert decode_splits(4, 1, 8, 128, 16, 132) == 64     # 2048 tokens
    assert split_tokens(2048, 66) == 32
    assert decode_splits(1, 1, 8, 10, 8, 132) == 5        # 80 tokens
    # enough blocks already: one split
    assert decode_splits(64, 8, 64, 16, 16, 132) == 1
    assert decode_splits(4, 1, 8, 0, 16, 132) == 1
    for args in ((3, 2, 40, 7, 16, 132), (4, 1, 8, 100, 16, 132),
                 (2, 1, 8, 33, 32, 114)):
        splits = decode_splits(*args)
        tokens = args[3] * args[4]
        per = split_tokens(tokens, splits)
        assert per % 16 == 0 and -(-tokens // per) == splits
        assert 1 <= splits <= -(-tokens // 16)


#: the 16-bit kernel's probabilities rounded to the page's type, against
#: the reference's oracle (f32 probabilities) and the Pallas kernel (each
#: rounded at its page's running max): the per-slot bounds of the
#: bf16 and f16 plain-version tests
HALF_SLOT_RTOL = {torch.bfloat16: 1e-2, torch.float16: 1e-2 / 8}


@pytest.mark.parametrize("cluster", [1, 2, 4])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "f16"])
def test_paged_decode_cluster_merge_matches_reference(jx, dtype, cluster):
    """The 16-bit kernel's chunked, cluster-merged formula
    (``ref.paged_decode_cluster_ref``) against the JAX reference: ragged
    windows (w = 3, q_len 0..3, an empty slot, contexts of 1 to 253
    tokens over 16-token pages, so a slot keeps 1 to 2 ranks busy and a
    warp takes 0 to 2 chunks) and the single-token mode. With f32 probabilities it is the oracle within
    1e-5; with each probability rounded to the page's type, as the kernel
    and the Pallas kernel round it, within the per-slot bound of the
    16-bit plain-version tests of both."""
    from repro.kernels.paged_attention import (paged_attention_pallas,
                                               paged_decode_ragged_pallas)
    rng = np.random.default_rng(29 + cluster + 5 * (dtype == torch.float16))
    b, hkv, rep, dh, ps, mp, w = 4, 2, 2, 32, 16, 16, 3
    n_pages = 1 + b * mp
    kp, vp = (torch.from_numpy(rng.standard_normal(
        (n_pages, hkv, ps, dh)).astype(np.float32)).to(dtype)
        for _ in range(2))
    bt = rng.permutation(n_pages)[:b * mp].reshape(b, mp).astype(np.int32)
    ctx = np.asarray([0, 1, 2 * ps + 1 - 2, mp * ps - 3], np.int32)
    qlen = np.asarray([0, 2, 1, 3], np.int32)
    q = rng.standard_normal((b, hkv, rep * w, dh)).astype(np.float32)
    t = [torch.from_numpy(a) for a in (q, bt, ctx, qlen)]
    j = (jx.jnp.asarray(q), _jbf16(jx, kp), _jbf16(jx, vp),
         jx.jnp.asarray(bt), jx.jnp.asarray(ctx), jx.jnp.asarray(qlen))
    oracle = np.asarray(jx.ref.paged_decode_ragged_ref(*j, w=w))
    pallas = np.asarray(paged_decode_ragged_pallas(*j, w=w, interpret=True))
    tol = HALF_SLOT_RTOL[dtype]
    exact = ref.paged_decode_cluster_ref(t[0], kp, vp, t[1], t[2], t[3], w=w,
                                         cluster=cluster,
                                         round_p=False).numpy()
    np.testing.assert_allclose(exact, oracle, rtol=1e-5, atol=1e-5)
    got = ref.paged_decode_cluster_ref(t[0], kp, vp, t[1], t[2], t[3], w=w,
                                       cluster=cluster).numpy()
    assert _slot_rel_err(got, oracle) <= tol
    assert _slot_rel_err(got, pallas) <= tol
    rows_off = np.arange(rep * w) % w >= qlen[:, None]       # (B, R)
    assert (got.transpose(0, 2, 1, 3)[rows_off] == 0).all()

    ctx1 = np.asarray([0, 1, ps + 1, mp * ps], np.int32)
    q1 = np.ascontiguousarray(q[:, :, :rep])
    j1 = (jx.jnp.asarray(q1), j[1], j[2], j[3], jx.jnp.asarray(ctx1))
    args = (torch.from_numpy(q1), kp, vp, t[1], torch.from_numpy(ctx1))
    exact = ref.paged_decode_cluster_ref(*args, cluster=cluster,
                                         round_p=False).numpy()
    np.testing.assert_allclose(exact, np.asarray(jx.ref.paged_attention_ref(
        *j1)), rtol=1e-5, atol=1e-5)
    got = ref.paged_decode_cluster_ref(*args, cluster=cluster).numpy()
    assert _slot_rel_err(got, np.asarray(paged_attention_pallas(
        *j1, interpret=True))) <= tol
    assert (got[0] == 0).all()


def test_decode_cluster_rule():
    """The 16-bit kernel's cluster size: a power of two, at most 16, no
    more blocks than SMs, and no block whose warps get fewer than 2
    16-token chunks of a full block table; of them, the ranks a slot keeps
    busy: the fewest that give no warp more than 2 of its live chunks."""
    from repro_torch.kernels.paged_attention import (active_ranks,
                                                     decode_cluster)
    # gemma-2b decode tick: 4 slots x 1 KV head x 8 rows, 256-token table
    assert decode_cluster(4, 1, 8, 8, 32, 132) == 2
    assert decode_cluster(4, 1, 8, 64, 32, 132) == 16     # 2048 tokens
    assert decode_cluster(4, 1, 40, 8, 32, 132) == 2      # verify, w = 5
    assert decode_cluster(64, 8, 64, 16, 16, 132) == 1    # enough blocks
    assert decode_cluster(4, 1, 8, 0, 16, 132) == 1
    assert decode_cluster(1, 1, 8, 3, 16, 132) == 1       # 48 tokens
    for args in ((3, 2, 40, 7, 16, 132), (4, 1, 8, 100, 16, 132),
                 (2, 1, 8, 33, 32, 114), (1, 1, 1, 128, 16, 132)):
        c = decode_cluster(*args)
        units = args[0] * args[1] * -(-args[2] // 8)
        chunks = -(-args[3] * args[4] // 16)
        assert 1 <= c <= 16 and c & (c - 1) == 0
        assert c == 1 or (units * c <= args[5] and 8 * (c - 1) < chunks)
    # the decode tick's 49 tokens (4 chunks) keep one rank busy: no barrier
    assert active_ranks(4, 2) == 1 and active_ranks(0, 16) == 1
    assert [active_ranks(n, 16) for n in (8, 9, 16, 17, 128, 200)] == \
        [1, 2, 2, 4, 16, 16]
    assert active_ranks(128, 4) == 4


def _q_planes(q, dtype):
    """The 16-bit kernel's planes of q (B, R, dh) f32, as f64: three bf16
    planes (bf16 pages), or two f16 planes of q scaled per row by 2^e with
    max|q| 2^e in [2^14, 2^15) and the scale undone (f16 pages)."""
    if dtype == torch.bfloat16:
        return [p.double() for p in _split3(q)]
    peak = q.abs().amax(-1, keepdim=True)
    _, ex = torch.frexp(peak)
    e = torch.where(peak > 0, 15 - ex, torch.zeros_like(ex)).clamp(-100, 100)
    x = torch.ldexp(q, e.float())
    hi = x.to(torch.float16).float()
    lo = (x - hi).to(torch.float16).float()
    return [torch.ldexp(p.double(), -e.double()) for p in (hi, lo)]


@pytest.mark.parametrize("k_range", ["large", "unit", "tiny", "subnormal"])
@pytest.mark.parametrize("q_scale", [1.0, 1e6, 1e-7])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "f16"])
def test_half_page_q_planes_reproduce_f32_scores(dtype, q_scale, k_range):
    """The planes of q the 16-bit kernel multiplies page K by on the
    tensor cores: each plane times a page value is exact in f32, so the
    score differs from the exact dot of q and K only by what the planes
    drop (summed here in f64, itself within 2^-40 of sum |q_d k_d|).
    bf16: three planes rebuild q exactly. f16: at most 2^-22 of each
    |q_d| plus 2^-39 of the row's max|q| for each element, over K of
    magnitude 1e4 (to 4e4, near f16's 65504), around 1, tiny and in f16's
    subnormal range; q of 1e6 (past f16's range) and 1e-7 (below its
    normal range) as well. The f32 scores of the planes' products are
    then within 1e-5 of an f32 dot's (relative to sum |q_d k_d|)."""
    rng = np.random.default_rng(7)
    b, r, dh = 3, 8, 256
    q = torch.from_numpy(rng.standard_normal((b, r, dh)).astype(np.float32))
    q = q * q_scale
    q[0, 1] *= 1e-3                          # rows far below the others
    q[1, 2, ::2] *= 1e-5                     # elements far below the row's
    mag = {"large": 1e4, "unit": 1.0, "tiny": 1e-3, "subnormal": 3e-6}
    k = torch.from_numpy((rng.standard_normal((b, 40, dh))
                          * mag[k_range]).astype(np.float32)).to(dtype)
    k64 = k.double()
    assert bool(torch.isfinite(k).all())
    if dtype == torch.float16 and k_range == "subnormal":
        assert bool((k.abs() < 6.1e-5).all())
    exact = q.double() @ k64.transpose(1, 2)
    planes = _q_planes(q, dtype)
    got = sum(p @ k64.transpose(1, 2) for p in planes)
    scale = q.double().abs() @ k64.abs().transpose(1, 2)
    bound = 2.0 ** -40 * scale
    if dtype == torch.bfloat16:
        assert torch.equal(sum(planes), q.double())
    else:
        floor = q.double().abs().amax(-1, keepdim=True) * 2.0 ** -39
        bound = bound + 2.0 ** -22 * scale \
            + floor * k64.abs().sum(-1)[:, None, :]
    assert bool(((got - exact).abs() <= bound).all())
    # the score as f32 sums of the planes' products, against an f32 dot
    f32 = sum(p.float() @ k.float().transpose(1, 2) for p in planes)
    dot = q @ k.float().transpose(1, 2)
    assert bool(((f32.double() - dot.double()).abs()
                 <= 1e-5 * scale + 1e-30).all())


def test_cuda_wrappers_refuse_cpu_tensors():
    """The kernel wrappers never run a plain version themselves: given CPU
    tensors they raise before touching nvcc or the card."""
    from repro_torch.kernels.paged_attention import (paged_attention_cuda,
                                                     paged_decode_ragged_cuda)
    from repro_torch.kernels.spx_matmul import spx_matmul_cuda
    x = torch.zeros((2, 8))
    with pytest.raises(ValueError, match="CUDA"):
        spx_matmul_cuda(x, torch.zeros((8, 2), dtype=torch.uint8),
                        torch.ones((1, 4)), torch.zeros(16), packed=True)
    q = torch.zeros((1, 1, 2, 32))
    pool = torch.zeros((2, 1, 8, 32))
    bt = torch.zeros((1, 2), dtype=torch.int32)
    one = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        paged_decode_ragged_cuda(q, pool, pool, bt, one, one, w=1)
    with pytest.raises(ValueError, match="CUDA"):
        paged_attention_cuda(q, pool, pool, bt, one)


def test_page_size_rule(monkeypatch):
    """K+V pages of one (slot, KV head) fit 32 KiB of shared memory."""
    from repro_torch.runtime import planner
    monkeypatch.delenv("REPRO_PAGE_SIZE", raising=False)
    assert planner.plan_kv_pages(256).page_size == 16        # gemma-2b
    assert planner.plan_kv_pages(128).page_size == 32
    assert planner.plan_kv_pages(32).page_size == 128
    for dh in (32, 64, 128, 256):
        plan = planner.plan_kv_pages(dh)
        assert plan.smem_bytes == 2 * plan.page_size * dh * 4 \
            <= planner.PAGE_PAIR_SMEM_BYTES
    monkeypatch.setenv("REPRO_PAGE_SIZE", "8")
    assert planner.plan_kv_pages(256).page_size == 8


#: the 24 ``spx_matmul`` launch keys of the paper's §4 experiments (packed,
#: LUT size, M, K, N): the MLP's (784, 128) and (128, 10) at every batch of
#: Table 1, Fig. 5, quickstart and quant_quality, the Q-network's (4, 64)
#: and (64, 64) at one state; sp2_4 (16, packed), pot4 (32) and sp2_8 (256)
PAPER_SPX_KEYS = tuple(
    [(True, 16, m, k, n) for k, n in ((784, 128), (128, 10))
     for m in (1, 8, 64, 256, 1024, 2048)]
    + [(True, 16, 1, 4, 64), (True, 16, 1, 64, 64)]
    + [(False, lut, m, k, n) for lut in (32, 256)
       for k, n in ((784, 128), (128, 10)) for m in (1024, 2048)]
    + [(False, 256, 1, 4, 64), (False, 256, 1, 64, 64)])
#: gemma-2b's projections (K, N): q/o, k/v, gate/up, down
GEMMA_SPX_SHAPES = ((2048, 2048), (2048, 256), (2048, 16384), (16384, 2048))


@pytest.mark.parametrize("key", PAPER_SPX_KEYS,
                         ids=lambda k: "-".join(map(str, k)))
def test_spx_plan_sends_paper_keys_to_small_kernel(key):
    """Every §4 launch key takes the small-layer kernel, with a tile no
    more than half empty whose blocks fit the card's shared memory."""
    from repro_torch.runtime import planner
    packed, lut, m, k, n = key
    plan = planner.plan_spx_launch(m, k, n, packed, lut, 132)
    assert plan.path == "small", key
    assert plan.tile_m in (8, 16, 32) and plan.tile_n in (16, 32, 64)
    assert plan.tile_m == 8 or plan.tile_m // 2 < m
    assert plan.tile_n == 16 or plan.tile_n // 2 < n
    assert 1 <= plan.warps <= planner.spx_small_max_warps(
        plan.tile_m, plan.tile_n)
    assert plan.warps <= max(-(-k // 16), 1 if packed else 8)
    assert planner.spx_small_smem_bytes(plan.tile_m, plan.tile_n, k, packed,
                                        plan.warps) <= 232448


@pytest.mark.parametrize("phase,ms,path", [
    ("decode", (1, 3, 4, 8), "skinny"),
    ("prefill", (128, 256, 2048), "mma")])
def test_spx_plan_keeps_gemma_keys_on_their_kernels(phase, ms, path):
    """gemma-2b's decode keys stay on the decode kernel and its prefill
    keys on the tensor-core prefill kernel, sp2_4 and sp2_8 alike; the
    old kernels take no tile (their cluster splits are the library's)."""
    from repro_torch.runtime import planner
    for k, n in GEMMA_SPX_SHAPES:
        for m in ms:
            for packed, lut in ((True, 16), (False, 256)):
                assert planner.plan_spx_launch(m, k, n, packed, lut, 132) \
                    == planner.SpxLaunchPlan(path), (phase, m, k, n)


def test_spx_plan_bounds():
    """The small kernel's layers end at N = 128 and K = 1024; no rows
    keep the old rule; a LUT is 1 to 256 entries; the tiles widen as M
    grows and the card stays half full."""
    from repro_torch.runtime import planner
    plan = planner.plan_spx_launch
    assert plan(64, 1024, 128, True, 16, 132).path == "small"
    assert plan(64, 1025, 128, True, 16, 132).path == "mma"
    assert plan(4, 784, 130, True, 16, 132).path == "skinny"
    assert plan(0, 784, 128, True, 16, 132).path == "skinny"
    with pytest.raises(ValueError, match="LUT"):
        plan(1, 784, 128, False, 257, 132)
    small = [plan(m, 784, 128, True, 16, 132) for m in (1, 64, 1024, 2048)]
    assert [(p.tile_m, p.tile_n) for p in small] == [
        (8, 16), (8, 16), (32, 32), (32, 64)]
    for m in (64, 1024, 2048):
        p = plan(m, 784, 128, True, 16, 132)
        assert -(-m // p.tile_m) * -(-128 // p.tile_n) >= min(
            66, -(-m // 8) * 8)


def test_cuda_impl_on_cpu_tensors_raises():
    with pytest.raises(registry.KernelUnavailable, match="CUDA"):
        registry.resolve("spx_matmul", "cuda", torch.device("cpu"))
    assert registry.resolve("spx_matmul", "auto", torch.device("cpu"))[0] \
        == "ref"
    assert set(registry.registered_ops()) >= {
        "spx_matmul", "paged_attention", "paged_decode_ragged"}


# ---------------------------------------------------------------------------
# On the card: each CUDA kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_kernels_match_plain_versions(cuda):
    from repro_torch.core import spx
    from repro_torch.kernels.paged_attention import (paged_attention_cuda,
                                                     paged_decode_ragged_cuda)
    from repro_torch.kernels.spx_matmul import spx_matmul_cuda
    gen = torch.Generator(device=cuda).manual_seed(0)
    for scheme, packed in (("sp2_4", True), ("sp2_8", False)):
        lut = spx.codebook(spx.scheme_levels(scheme), device=cuda)
        for m, k, n in ((1, 64, 96), (37, 300, 130), (130, 1024, 512)):
            codes = torch.randint(0, 16 if packed else 256,
                                  (k, n // 2 if packed else n),
                                  generator=gen, device=cuda,
                                  dtype=torch.int32).to(torch.uint8)
            scale = torch.rand((1, n), generator=gen, device=cuda)
            x = torch.randn((m, k), generator=gen, device=cuda)
            got = spx_matmul_cuda(x, codes, scale, lut, packed=packed)
            want = ref.spx_matmul_ref(x, codes, scale, lut, packed=packed)
            assert (got - want).abs().max() <= 1e-4 * want.abs().max()
    for dh, rep, w in ((128, 4, 8), (256, 8, 1), (64, 2, 5), (32, 1, 3)):
        b, hkv, ps, mp = 3, 2, 16, 4
        kp = torch.randn((1 + b * mp, hkv, ps, dh), generator=gen,
                         device=cuda)
        vp = torch.randn_like(kp)
        bt = torch.randint(0, 1 + b * mp, (b, mp), generator=gen,
                           device=cuda, dtype=torch.int32)
        ctx = torch.tensor([0, ps - 1, 2 * ps + 1], dtype=torch.int32,
                           device=cuda)
        qn = torch.tensor([0, 1, w], dtype=torch.int32, device=cuda)
        q = torch.randn((b, hkv, rep * w, dh), generator=gen, device=cuda)
        got = paged_decode_ragged_cuda(q, kp, vp, bt, ctx, qn, w=w)
        want = ref.paged_decode_ragged_ref(q, kp, vp, bt, ctx, qn, w=w)
        assert ((got - want).abs() <= 1e-4 * (1 + want.abs())).all()
        assert (got[0] == 0).all()
        q1 = q[:, :, :rep].contiguous()
        got = paged_attention_cuda(q1, kp, vp, bt, ctx)
        want = ref.paged_attention_ref(q1, kp, vp, bt, ctx)
        assert ((got - want).abs() <= 1e-4 * (1 + want.abs())).all()
    with pytest.raises(ValueError, match="head_dim"):
        paged_decode_ragged_cuda(torch.zeros((1, 1, 1, 48), device=cuda),
                                 torch.zeros((2, 1, 8, 48), device=cuda),
                                 torch.zeros((2, 1, 8, 48), device=cuda),
                                 torch.zeros((1, 2), dtype=torch.int32,
                                             device=cuda),
                                 torch.ones(1, dtype=torch.int32, device=cuda),
                                 torch.ones(1, dtype=torch.int32, device=cuda),
                                 w=1)


@pytest.mark.gpu
def test_cuda_quant_kernels_match_plain_versions(cuda):
    from repro_torch.kernels.paged_attention import (
        paged_attention_quant_cuda, paged_decode_ragged_quant_cuda)
    from repro_torch.nn.attention import kv_lut, quantize_kv
    gen = torch.Generator(device=cuda).manual_seed(0)
    for scheme in ("uniform8", "spx_8_x3"):
        lut = kv_lut(scheme, cuda)
        for dh, rep, w in ((128, 4, 8), (256, 8, 1), (64, 2, 5), (32, 1, 3)):
            b, hkv, ps, mp = 3, 2, 32, 4
            n_pages = 1 + b * mp
            kc, ks = quantize_kv(torch.randn((n_pages, hkv, ps, dh),
                                             generator=gen, device=cuda),
                                 scheme)
            vc, vs = quantize_kv(torch.randn((n_pages, hkv, ps, dh),
                                             generator=gen, device=cuda),
                                 scheme)
            bt = torch.randint(0, n_pages, (b, mp), generator=gen,
                               device=cuda, dtype=torch.int32)
            ctx = torch.tensor([0, ps - 1, 2 * ps + 1], dtype=torch.int32,
                               device=cuda)
            qn = torch.tensor([0, 1, w], dtype=torch.int32, device=cuda)
            q = torch.randn((b, hkv, rep * w, dh), generator=gen,
                            device=cuda)
            pools = (kc, ks, vc, vs, bt, ctx)
            got = paged_decode_ragged_quant_cuda(q, *pools, qn, lut, w=w)
            want = ref.paged_decode_ragged_quant_ref(q, *pools, qn, lut, w=w)
            assert ((got - want).abs() <= 1e-4 * (1 + want.abs())).all()
            assert (got[0] == 0).all()
            q1 = q[:, :, :rep].contiguous()
            got = paged_attention_quant_cuda(q1, *pools, lut)
            want = ref.paged_attention_quant_ref(q1, *pools, lut)
            assert ((got - want).abs() <= 1e-4 * (1 + want.abs())).all()


@pytest.mark.gpu
def test_cuda_flash_kernel_matches_plain_version(cuda):
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    gen = torch.Generator(device=cuda).manual_seed(0)
    for s in (1, 33, 128):
        for dh, hkv, rep in ((128, 2, 1), (256, 1, 8), (64, 2, 2)):
            q = torch.randn((2, hkv * rep, s, dh), generator=gen,
                            device=cuda)
            k, v = (torch.randn((2, hkv, s, dh), generator=gen, device=cuda)
                    for _ in range(2))
            for causal in (True, False):
                got = flash_attention_cuda(q, k, v, causal=causal)
                want = ref.flash_attention_ref(q, k, v, causal=causal,
                                               q_chunk=s)
                assert ((got - want).abs() <= 1e-4 * (1 + want.abs())).all()


@pytest.mark.gpu
def test_cuda_flash_kernel_query_offset_matches_plain_version(cuda):
    """The causal query offset of a context-parallel shard: 128 rows of
    gemma-2b's 8 query heads over its KV head of 256, and 4 heads of 64
    over 2, at offsets 0, S/4 and 3S/4 of S = 512 keys; a rerun
    bit-identical."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    gen = torch.Generator(device=cuda).manual_seed(3)
    skv, sq = 512, 128
    for dh, hkv, rep in ((256, 1, 8), (64, 2, 2)):
        q = torch.randn((2, hkv * rep, sq, dh), generator=gen, device=cuda)
        k, v = (torch.randn((2, hkv, skv, dh), generator=gen, device=cuda)
                for _ in range(2))
        for off in (0, skv // 4, 3 * skv // 4):
            got = flash_attention_cuda(q, k, v, causal=True, q_offset=off)
            want = ref.flash_attention_ref(q, k, v, causal=True, q_chunk=sq,
                                           q_offset=off)
            assert _attn_close(got, want)
            assert torch.equal(got, flash_attention_cuda(
                q, k, v, causal=True, q_offset=off))


def _attn_close(got, want) -> bool:
    return bool(((got - want).abs() <= 1e-4 * (1 + want.abs())).all())


@pytest.mark.gpu
def test_cuda_paged_decode_splits_modes_deterministic(cuda):
    """Contexts that take several splits (up to 2048 tokens, one ending
    one token into a page), ragged q_len at w in {1, 5, 8}, an empty slot,
    and the in-kernel single-token mode, on f32 and code pages (split
    kernel and merge) and on bf16 and f16 pages (the tensor-core kernel,
    up to 16 blocks a cluster; each slot within its page type's bound);
    two launches on the same inputs are bit-identical."""
    from repro_torch.kernels.paged_attention import (
        paged_attention_cuda, paged_attention_quant_cuda,
        paged_decode_ragged_cuda, paged_decode_ragged_quant_cuda)
    from repro_torch.nn.attention import kv_lut, quantize_kv
    gen = torch.Generator(device=cuda).manual_seed(1)
    b, hkv, rep, dh, tokens = 4, 1, 8, 256, 2048
    lut = kv_lut("spx_8_x3", cuda)
    for quant, ps in ((False, 16), (True, 32), (torch.bfloat16, 32),
                      (torch.float16, 16)):
        mp = tokens // ps
        n_pages = 1 + b * mp
        k = torch.randn((n_pages, hkv, ps, dh), generator=gen, device=cuda)
        v = torch.randn((n_pages, hkv, ps, dh), generator=gen, device=cuda)
        bt = (torch.randperm(n_pages - 1, generator=gen, device=cuda)[
            :b * mp].reshape(b, mp) + 1).to(torch.int32)
        half = quant in HALF_SLOT_RTOL
        if half:
            k, v = k.to(quant), v.to(quant)
            quant = False
        close = ((lambda got, want: _slot_rel_err(got.cpu(), want.cpu())
                  <= HALF_SLOT_RTOL[k.dtype]) if half else _attn_close)
        if quant:
            (kc, ks), (vc, vs) = quantize_kv(k, "spx_8_x3"), \
                quantize_kv(v, "spx_8_x3")
            pools = (kc, ks, vc, vs, bt)
            ragged, single = (paged_decode_ragged_quant_cuda,
                              paged_attention_quant_cuda)
            ragged_ref, single_ref = (ref.paged_decode_ragged_quant_ref,
                                      ref.paged_attention_quant_ref)
            extra = (lut,)
        else:
            pools = (k, v, bt)
            ragged, single = paged_decode_ragged_cuda, paged_attention_cuda
            ragged_ref, single_ref = (ref.paged_decode_ragged_ref,
                                      ref.paged_attention_ref)
            extra = ()
        for w in (1, 5, 8):
            qlens = [0, 1, max(1, w - 2), w]
            ctx = [0, 3 * ps + 1 - qlens[1], 37 * 16 - qlens[2],
                   tokens - w]
            ctx_t = torch.tensor(ctx, dtype=torch.int32, device=cuda)
            qn = torch.tensor(qlens, dtype=torch.int32, device=cuda)
            q = torch.randn((b, hkv, rep * w, dh), generator=gen,
                            device=cuda)
            got = ragged(q, *pools, ctx_t, qn, *extra, w=w)
            again = ragged(q, *pools, ctx_t, qn, *extra, w=w)
            want = ragged_ref(q, *pools, ctx_t, qn, *extra, w=w)
            assert close(got, want), (quant, k.dtype, w)
            assert torch.equal(got, again), (quant, w)
            rows_off = torch.arange(rep * w, device=cuda) % w >= qn[:, None]
            assert (got.permute(0, 2, 1, 3)[rows_off] == 0).all()
        ctx1 = torch.tensor([0, 1, 3 * ps + 1, tokens], dtype=torch.int32,
                            device=cuda)
        q = torch.randn((b, hkv, rep, dh), generator=gen, device=cuda)
        got = single(q, *pools, ctx1, *extra)
        again = single(q, *pools, ctx1, *extra)
        want = single_ref(q, *pools, ctx1, *extra)
        assert close(got, want) and torch.equal(got, again), (quant, k.dtype)
        assert (got[0] == 0).all()


@pytest.mark.gpu
def test_cuda_spx_matmul_ragged_shapes_deterministic(cuda):
    """spx_matmul at M in {1, 3, 4, 8, 9, 37, 128} (both kernels), with K
    and N that no tile divides and one gemma-2b shape; two launches are
    bit-identical."""
    from repro_torch.core import spx
    from repro_torch.kernels.spx_matmul import spx_matmul_cuda
    gen = torch.Generator(device=cuda).manual_seed(2)
    for scheme, packed in (("sp2_4", True), ("sp2_8", False)):
        lut = spx.codebook(spx.scheme_levels(scheme), device=cuda)
        for k, n in ((1000, 2050), (333, 130), (16384, 2048)):
            codes = torch.randint(0, 16 if packed else 256,
                                  (k, n // 2 if packed else n),
                                  generator=gen, device=cuda,
                                  dtype=torch.int32).to(torch.uint8)
            scale = torch.rand((1, n), generator=gen, device=cuda)
            for m in (1, 3, 4, 8, 9, 37, 128):
                x = torch.randn((m, k), generator=gen, device=cuda)
                got = spx_matmul_cuda(x, codes, scale, lut, packed=packed)
                again = spx_matmul_cuda(x, codes, scale, lut, packed=packed)
                want = ref.spx_matmul_ref(x, codes, scale, lut,
                                          packed=packed)
                assert (got - want).abs().max() <= 1e-4 * want.abs().max(), \
                    (scheme, k, n, m)
                assert torch.equal(got, again), (scheme, k, n, m)


def _cuda_half_pages_match_plain_version(cuda, dtype, tol, suffix):
    """Kernels 2 and 5 over ``dtype`` pages (the tensor-core kernel) at dh
    in {32, 64, 128, 256}, page sizes 16 and 32, w in {1, 5, 8} under rep
    8 (up to 8 row groups), block tables of 256 and 2048 tokens (two
    cluster sizes): slots with contexts 0, 1, 15, 16, 17, 49, 300 (within
    the table: some of a cluster's ranks busy, the others only at its
    barriers) and a full table, a partial window and an empty slot; the
    single-token mode at ctx_len 0, 1, 15, 16, 17, 49, 300 and the full
    table. Within ``tol`` of the
    plain version's largest |output| in each slot, masked rows exact
    zeros, a second launch bit-identical, and every launch counted under
    the ``suffix`` route."""
    from repro_torch.kernels.paged_attention import (paged_attention_cuda,
                                                     paged_decode_ragged_cuda)
    gen = torch.Generator(device=cuda).manual_seed(16)
    ops.reset_op_calls()
    ragged_launches = single_launches = 0
    rep = 8
    for dh in (32, 64, 128, 256):
        hkv = 2 if dh < 256 else 1
        for ps in (16, 32):
            for tokens in (256, 2048):
                mp = tokens // ps
                contexts = [c for c in (0, 1, 15, 16, 17, 49, 300)
                            if c + 8 <= tokens]
                for w in (1, 5, 8):
                    ctx_l = contexts + [tokens - w, tokens - w, 0]
                    qlens = [w] * len(contexts) + [max(1, w - 2), w, 0]
                    b = len(ctx_l)
                    n_pages = 1 + b * mp
                    kp, vp = (torch.randn((n_pages, hkv, ps, dh),
                                          generator=gen,
                                          device=cuda).to(dtype)
                              for _ in range(2))
                    bt = (torch.randperm(n_pages - 1, generator=gen,
                                         device=cuda)[:b * mp]
                          .reshape(b, mp) + 1).to(torch.int32)
                    ctx = torch.tensor(ctx_l, dtype=torch.int32, device=cuda)
                    qn = torch.tensor(qlens, dtype=torch.int32, device=cuda)
                    q = torch.randn((b, hkv, rep * w, dh), generator=gen,
                                    device=cuda)
                    got = paged_decode_ragged_cuda(q, kp, vp, bt, ctx, qn,
                                                   w=w)
                    again = paged_decode_ragged_cuda(q, kp, vp, bt, ctx, qn,
                                                     w=w)
                    want = ref.paged_decode_ragged_ref(q, kp, vp, bt, ctx,
                                                       qn, w=w)
                    case = (dh, ps, tokens, w)
                    assert got.dtype == torch.float32, case
                    assert _slot_rel_err(got.cpu(), want.cpu()) <= tol, case
                    assert torch.equal(got, again), case
                    rows_off = torch.arange(rep * w, device=cuda) % w \
                        >= qn[:, None]
                    assert (got.permute(0, 2, 1, 3)[rows_off] == 0).all(), \
                        case
                    ragged_launches += 2
                ctx1 = torch.tensor(contexts + [tokens],
                                    dtype=torch.int32, device=cuda)
                q1 = torch.randn((len(ctx1), hkv, rep, dh), generator=gen,
                                 device=cuda)
                bt1 = bt[:len(ctx1)].contiguous()
                got = paged_attention_cuda(q1, kp, vp, bt1, ctx1)
                again = paged_attention_cuda(q1, kp, vp, bt1, ctx1)
                want = ref.paged_attention_ref(q1, kp, vp, bt1, ctx1)
                assert _slot_rel_err(got.cpu(), want.cpu()) <= tol, case
                assert torch.equal(got, again) and (got[0] == 0).all(), case
                single_launches += 2
    assert ops.op_calls() == {"paged_decode_ragged" + suffix: ragged_launches,
                              "paged_attention" + suffix: single_launches}
    with pytest.raises(TypeError, match=str(dtype).replace("torch.", "")):
        # a half K pool beside an f32 V pool
        paged_decode_ragged_cuda(q, kp, vp.float(), bt, ctx, qn, w=w)


@pytest.mark.gpu
def test_cuda_bf16_pages_match_plain_version(cuda):
    """``_cuda_half_pages_match_plain_version`` on bf16 pages (the
    tensor-core kernel's ``Bf16Mma`` instance), within 1e-2: the kernel
    rounds each probability to bf16, the plain version does not."""
    _cuda_half_pages_match_plain_version(cuda, torch.bfloat16, 1e-2, "_bf16")


@pytest.mark.gpu
def test_cuda_f16_pages_match_plain_version(cuda):
    """``_cuda_half_pages_match_plain_version`` on f16 pages (the
    ``F16Mma`` instance), within F16_SLOT_RTOL: both round each
    probability to f16, the kernel at its running max, the plain version
    at the global one. Then the subnormal case at 2048 tokens (split over
    blocks): within 1e-5 of the plain version, which keeps the subnormal
    probabilities as the kernel must."""
    from repro_torch.kernels.paged_attention import paged_decode_ragged_cuda
    _cuda_half_pages_match_plain_version(cuda, torch.float16, F16_SLOT_RTOL,
                                         "_f16")
    q, kp, vp, bt, ctx, qn = f16_subnormal_case(cuda, n_tokens=2048, dh=128)
    # one KV head and one row: (B, W, Hq, dh) is (B, Hkv, R, dh)
    got = paged_decode_ragged_cuda(q, kp, vp, bt, ctx, qn, w=1)
    want = ref.paged_decode_ragged_ref(q, kp, vp, bt, ctx, qn, w=1)
    assert (want > 0).all()
    assert ((got - want).abs() <= 1e-5 * want.abs()).all()


# ---------------------------------------------------------------------------
# The tensor-core kernels' exact bf16 splits, in plain PyTorch
# ---------------------------------------------------------------------------

def _bf16(t):
    """Round f32 to bf16 (nearest even) and back, as the kernels'
    ``__float2bfloat16_rn`` does."""
    return t.to(torch.bfloat16).to(torch.float32)


def _split3(x):
    """The prefill kernel's planes of x: x1 = bf16(x), x2 = bf16(x - x1),
    x3 = bf16(x - x1 - x2)."""
    x1 = _bf16(x)
    r = x - x1
    x2 = _bf16(r)
    return x1, x2, _bf16(r - x2)


def _split2(x):
    """hi = bf16(x), lo = bf16(x - hi): the LUT's planes and the flash
    kernel's operands."""
    hi = _bf16(x)
    return hi, _bf16(x - hi)


@pytest.mark.parametrize("scale", [1.0, 1e-20, 1e30])
def test_three_bf16_planes_rebuild_f32_exactly(scale):
    """Exact while the residuals stay normal floats (|x| above about
    2^-100); below that x3 loses subnormal bits, under 2^-126."""
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (64, 4096)).astype(np.float32)) * scale
    x1, x2, x3 = _split3(x)
    for plane in (x1, x2, x3):
        assert torch.equal(plane, _bf16(plane))       # each plane is bf16
    assert torch.equal(x1 + x2 + x3, x)


@pytest.mark.parametrize("scheme", ["sp2_4", "pot3", "pot4", "sp2_8",
                                    "spx_5_x3", "spx_8_x3", "uniform4",
                                    "uniform8"])
def test_which_codebooks_are_exact_in_bf16(scheme):
    """The prefill kernel skips the w_lo products when every LUT entry is
    exact in bf16 (one vote per block): true of sp2_4, pot3 and pot4."""
    from repro_torch.core import spx
    lut = spx.codebook(spx.scheme_levels(scheme))
    _, lo = _split2(lut)
    assert bool((lo == 0).all()) == (scheme in ("sp2_4", "pot3", "pot4"))


@pytest.mark.parametrize("scheme,packed", [("sp2_4", True),
                                           ("sp2_8", False)])
def test_split_products_match_f32_product(scheme, packed):
    """x @ W as the prefill kernel sums it: three products x_p @ w_hi, and
    for a LUT not exact in bf16 two more, x1 @ w_lo + x2 @ w_lo; within
    1e-4 of the largest output of the f32 product at K = 16384."""
    from repro_torch.core import spx
    rng = np.random.default_rng(7)
    k, n, m = 16384, 64, 8
    lut = spx.codebook(spx.scheme_levels(scheme))
    codes = torch.from_numpy(rng.integers(0, 16 if packed else 256,
                                          (k, n // 2 if packed else n))
                             .astype(np.uint8))
    scale = torch.from_numpy(rng.random((1, n)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    want = ref.spx_matmul_ref(x, codes, scale, lut, packed=packed)
    w_hi, w_lo = _split2(lut)
    ids = (spx.unpack_int4(codes) if packed else codes).long()
    planes = _split3(x)
    acc = sum(p @ w_hi[ids] for p in planes)
    if scheme == "sp2_8":
        assert bool((w_lo != 0).any())
        acc = acc + planes[0] @ w_lo[ids] + planes[1] @ w_lo[ids]
    got = acc * scale
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()


def _flash_split_emulation(q, k, v, *, causal):
    """The flash kernel's arithmetic in plain PyTorch: S = Q K^T and
    O = P V each as hi.hi + hi.lo + lo.hi of bf16 planes, online softmax
    statistics in f32 (one KV tile here: the statistics are exact)."""
    rep = q.shape[1] // k.shape[1]
    k = k.repeat_interleave(rep, dim=1)
    v = v.repeat_interleave(rep, dim=1)
    dh = q.shape[-1]

    def mm3(a, b):
        ah, al = _split2(a)
        bh, bl = _split2(b)
        return ah @ bh + ah @ bl + al @ bh

    s = mm3(q, k.transpose(-1, -2)) * dh ** -0.5
    if causal:
        keep = torch.arange(q.shape[2])[:, None] >= torch.arange(k.shape[2])
        s = torch.where(keep, s, torch.full_like(s, -1e30))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    if causal:
        p = torch.where(keep, p, torch.zeros_like(p))
    return mm3(p, v) / torch.clamp(p.sum(-1, keepdim=True), min=1e-30)


@pytest.mark.parametrize("rep", [1, 8])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_hi_lo_split_within_attention_tolerance(rep, causal):
    rng = np.random.default_rng(11 + rep + 2 * causal)
    s, dh = 129, 256
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               for shape in ((1, rep, s, dh), (1, 1, s, dh), (1, 1, s, dh)))
    got = _flash_split_emulation(q, k, v, causal=causal)
    want = ref.flash_attention_ref(q, k, v, causal=causal, q_chunk=s)
    assert bool(((got - want).abs() <= 1e-4 * (1 + want.abs())).all())


@pytest.mark.gpu
def test_cuda_spx_prefill_kernel_matches_plain_version(cuda):
    """The tensor-core prefill kernel (M > 8) at gemma-2b's projection
    shapes and M in {9, 64, 65, 128, 256}, for sp2_4 packed (three
    passes) and sp2_8 unpacked (five); a second launch is bit-identical."""
    from repro_torch.core import spx
    from repro_torch.kernels.spx_matmul import spx_matmul_cuda
    gen = torch.Generator(device=cuda).manual_seed(4)
    for scheme, packed in (("sp2_4", True), ("sp2_8", False)):
        lut = spx.codebook(spx.scheme_levels(scheme), device=cuda)
        for k, n in ((2048, 2048), (2048, 256), (2048, 16384),
                     (16384, 2048)):
            codes = torch.randint(0, 16 if packed else 256,
                                  (k, n // 2 if packed else n),
                                  generator=gen, device=cuda,
                                  dtype=torch.int32).to(torch.uint8)
            scale = torch.rand((1, n), generator=gen, device=cuda) * 0.05
            for m in (9, 64, 65, 128, 256):
                x = torch.randn((m, k), generator=gen, device=cuda)
                got = spx_matmul_cuda(x, codes, scale, lut, packed=packed)
                again = spx_matmul_cuda(x, codes, scale, lut, packed=packed)
                want = ref.spx_matmul_ref(x, codes, scale, lut,
                                          packed=packed)
                assert (got - want).abs().max() <= 1e-4 * want.abs().max(), \
                    (scheme, k, n, m)
                assert torch.equal(got, again), (scheme, k, n, m)


@pytest.mark.gpu
def test_cuda_spx_matmul_paper_mlp_shapes(cuda):
    """The paper MLP's two layers, (K, N) = (784, 128) and (128, 10): K not
    a multiple of the prefill kernel's K step, packed rows of 5 bytes, one
    column tile; M over both kernels up to quickstart's 2048 test digits;
    and the Q-network's quantized layers (4, 64) and (64, 64) at M = 1 and
    64; 4-bit packed, 5-bit (pot4) and 8-bit codebooks; bit-identical
    reruns."""
    from repro_torch.core import spx
    from repro_torch.kernels.spx_matmul import spx_matmul_cuda
    gen = torch.Generator(device=cuda).manual_seed(6)
    for scheme, packed in (("sp2_4", True), ("sp2_8", False),
                           ("pot4", False)):
        lut = spx.codebook(spx.scheme_levels(scheme), device=cuda)
        for k, n, ms in ((784, 128, (1, 8, 9, 64, 1024, 2048)),
                         (128, 10, (1, 8, 9, 64, 1024, 2048)),
                         (4, 64, (1, 64)), (64, 64, (1, 64))):
            codes = torch.randint(0, lut.numel(),
                                  (k, n // 2 if packed else n),
                                  generator=gen, device=cuda,
                                  dtype=torch.int32).to(torch.uint8)
            scale = torch.rand((1, n), generator=gen, device=cuda) * 0.05
            for m in ms:
                x = torch.rand((m, k), generator=gen, device=cuda)
                got = spx_matmul_cuda(x, codes, scale, lut, packed=packed)
                again = spx_matmul_cuda(x, codes, scale, lut, packed=packed)
                want = ref.spx_matmul_ref(x, codes, scale, lut,
                                          packed=packed)
                assert (got - want).abs().max() <= 1e-4 * want.abs().max(), \
                    (scheme, k, n, m)
                assert torch.equal(got, again), (scheme, k, n, m)


@pytest.mark.gpu
def test_cuda_spx_matmul_small_layers(cuda):
    """The small-layer kernel at the 24 §4 launch keys and at ragged
    edges: K = 777 and 100 ending in a partial 16-row step, K = 4, N = 10
    packed (5-byte code rows), odd N unpacked (13, 127), M not a multiple
    of any tile. Within 1e-4 of the plain version's largest |output|, a
    second launch bit-identical, every launch on the small kernel."""
    from repro_torch.core import spx
    from repro_torch.kernels.spx_matmul import spx_matmul_cuda
    gen = torch.Generator(device=cuda).manual_seed(25)
    schemes = {16: "sp2_4", 32: "pot4", 256: "sp2_8"}
    keys = list(PAPER_SPX_KEYS) + [
        (True, 16, m, k, n) for k, n in ((777, 128), (100, 10), (4, 10))
        for m in (1, 37, 1000)] + [
        (False, 256, m, k, n) for k, n in ((777, 13), (100, 127), (4, 13))
        for m in (3, 65)]
    ops.reset_op_calls()
    for packed, lut_size, m, k, n in keys:
        lut = spx.codebook(spx.scheme_levels(schemes[lut_size]),
                           device=cuda)
        assert lut.numel() == lut_size
        codes = torch.randint(0, 256 if packed else lut_size,
                              (k, n // 2 if packed else n), generator=gen,
                              device=cuda, dtype=torch.int32).to(torch.uint8)
        scale = torch.rand((1, n), generator=gen, device=cuda) * 0.05
        x = torch.randn((m, k), generator=gen, device=cuda)
        got = spx_matmul_cuda(x, codes, scale, lut, packed=packed)
        again = spx_matmul_cuda(x, codes, scale, lut, packed=packed)
        want = ref.spx_matmul_ref(x, codes, scale, lut, packed=packed)
        key = (packed, lut_size, m, k, n)
        assert (got - want).abs().max() <= 1e-4 * want.abs().max(), key
        assert torch.equal(got, again), key
    assert ops.path_calls() == {"spx_matmul_small": 2 * len(keys)}


@pytest.mark.gpu
def test_cuda_verify_window_crosses_page_boundary(cuda):
    """The speculative verify window (w = 5) whose rows straddle a page
    boundary (ctx = page_size - 2), beside the one-token rows of the same
    tick."""
    from repro_torch.kernels.paged_attention import paged_decode_ragged_cuda
    gen = torch.Generator(device=cuda).manual_seed(7)
    b, hkv, rep, dh, ps, mp, w = 4, 1, 8, 256, 16, 4, 5
    kp = torch.randn((1 + b * mp, hkv, ps, dh), generator=gen, device=cuda)
    vp = torch.randn_like(kp)
    bt = (torch.randperm(b * mp, generator=gen, device=cuda).reshape(b, mp)
          + 1).to(torch.int32)
    ctx = torch.tensor([ps - 2, ps - 2, 2 * ps - 1, 0], dtype=torch.int32,
                       device=cuda)
    qn = torch.tensor([5, 1, 3, 0], dtype=torch.int32, device=cuda)
    q = torch.randn((b, hkv, rep * w, dh), generator=gen, device=cuda)
    got = paged_decode_ragged_cuda(q, kp, vp, bt, ctx, qn, w=w)
    want = ref.paged_decode_ragged_ref(q, kp, vp, bt, ctx, qn, w=w)
    assert ((got - want).abs() <= 1e-4 * (1 + want.abs())).all()
    assert torch.equal(got, paged_decode_ragged_cuda(q, kp, vp, bt, ctx, qn,
                                                     w=w))


@pytest.mark.gpu
def test_cuda_flash_kernel_long_and_ragged_deterministic(cuda):
    """Flash attention at S in {1, 33, 129, 2048}, rep in {1, 8}, causal
    and not, head_dim 256; a second launch is bit-identical."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    gen = torch.Generator(device=cuda).manual_seed(5)
    for s in (1, 33, 129, 2048):
        for rep in (1, 8):
            q = torch.randn((1, rep, s, 256), generator=gen, device=cuda)
            k, v = (torch.randn((1, 1, s, 256), generator=gen, device=cuda)
                    for _ in range(2))
            for causal in (True, False):
                got = flash_attention_cuda(q, k, v, causal=causal)
                again = flash_attention_cuda(q, k, v, causal=causal)
                want = ref.flash_attention_ref(q, k, v, causal=causal,
                                               q_chunk=s)
                assert _attn_close(got, want), (s, rep, causal)
                assert torch.equal(got, again), (s, rep, causal)


@pytest.mark.gpu
def test_cuda_family_shapes_match_plain_versions(cuda):
    """The shapes the MoE, recurrent and M-RoPE families give the kernels:
    ``spx_matmul`` at xlstm's gate projection (2048, 8: packed rows of 4
    bytes), jamba's x_proj (4096, 160) and dt_proj (128, 4096), through
    the decode (M = 4) and the prefill (M = 128) kernels; kernels 2 and 5
    at head_dim 128 with olmoe's 16 KV heads of GQA ratio 1 and qwen2-vl's
    2 of ratio 6, on 32-token pages; bit-identical reruns."""
    from repro_torch.core import spx
    from repro_torch.kernels.paged_attention import (paged_attention_cuda,
                                                     paged_decode_ragged_cuda)
    from repro_torch.kernels.spx_matmul import spx_matmul_cuda
    gen = torch.Generator(device=cuda).manual_seed(8)
    lut = spx.codebook(spx.scheme_levels("sp2_4"), device=cuda)
    for k, n in ((2048, 8), (4096, 160), (128, 4096)):
        codes = torch.randint(0, 256, (k, n // 2), generator=gen,
                              device=cuda, dtype=torch.int32).to(torch.uint8)
        scale = torch.rand((1, n), generator=gen, device=cuda) * 0.05
        for m in (4, 128):
            x = torch.randn((m, k), generator=gen, device=cuda)
            got = spx_matmul_cuda(x, codes, scale, lut, packed=True)
            want = ref.spx_matmul_ref(x, codes, scale, lut, packed=True)
            assert (got - want).abs().max() <= 1e-4 * want.abs().max(), \
                (k, n, m)
            assert torch.equal(got, spx_matmul_cuda(x, codes, scale, lut,
                                                    packed=True))
    b, dh, ps, mp = 4, 128, 32, 8
    for hkv, rep in ((16, 1), (2, 6)):
        kp = torch.randn((1 + b * mp, hkv, ps, dh), generator=gen,
                         device=cuda)
        vp = torch.randn_like(kp)
        bt = (torch.randperm(b * mp, generator=gen, device=cuda)
              .reshape(b, mp) + 1).to(torch.int32)
        ctx = torch.tensor([ps - 1, ps, ps + 1, 3 * ps + 7],
                           dtype=torch.int32, device=cuda)
        qn = torch.tensor([0, 1, 1, 1], dtype=torch.int32, device=cuda)
        q = torch.randn((b, hkv, rep, dh), generator=gen, device=cuda)
        got = paged_decode_ragged_cuda(q, kp, vp, bt, ctx, qn, w=1)
        want = ref.paged_decode_ragged_ref(q, kp, vp, bt, ctx, qn, w=1)
        assert ((got - want).abs() <= 1e-4 * (1 + want.abs())).all()
        assert (got[0] == 0).all()
        assert torch.equal(got, paged_decode_ragged_cuda(q, kp, vp, bt, ctx,
                                                         qn, w=1))
        got = paged_attention_cuda(q, kp, vp, bt, ctx)
        want = ref.paged_attention_ref(q, kp, vp, bt, ctx)
        assert ((got - want).abs() <= 1e-4 * (1 + want.abs())).all()


@pytest.mark.gpu
def test_cuda_whisper_shapes_match_plain_versions(cuda):
    """whisper-small's shapes: flash attention not causal at head_dim 64,
    12 heads over 12 KV heads, (Sq, Skv) in {(1500, 1500), (1, 1500),
    (32, 1500)} (the encoder and the cross-attention of decode ticks and
    prefill chunks: Skv not a multiple of the 32-key tile); kernels 2 and
    5 at head_dim 64 with 12 KV heads on f32 and bf16 pages; spx_matmul at
    M = 1500 with whisper's (K, N); bit-identical reruns."""
    from repro_torch.core import spx
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.paged_attention import (paged_attention_cuda,
                                                     paged_decode_ragged_cuda)
    from repro_torch.kernels.spx_matmul import spx_matmul_cuda
    gen = torch.Generator(device=cuda).manual_seed(9)
    for sq, skv in ((1500, 1500), (1, 1500), (32, 1500)):
        q = torch.randn((4 if sq < skv else 1, 12, sq, 64), generator=gen,
                        device=cuda)
        k, v = (torch.randn((q.shape[0], 12, skv, 64), generator=gen,
                            device=cuda) for _ in range(2))
        got = flash_attention_cuda(q, k, v, causal=False)
        want = ref.flash_attention_ref(q, k, v, causal=False, q_chunk=sq)
        assert _attn_close(got, want), (sq, skv)
        assert torch.equal(got, flash_attention_cuda(q, k, v, causal=False))
    b, hkv, dh, ps, mp = 4, 12, 64, 64, 4
    for dtype in (torch.float32, torch.bfloat16):
        kp = torch.randn((1 + b * mp, hkv, ps, dh), generator=gen,
                         device=cuda).to(dtype)
        vp = torch.randn_like(kp)
        bt = (torch.randperm(b * mp, generator=gen, device=cuda)
              .reshape(b, mp) + 1).to(torch.int32)
        ctx = torch.tensor([0, 1, ps, 3 * ps + 7], dtype=torch.int32,
                           device=cuda)
        qn = torch.tensor([0, 1, 1, 1], dtype=torch.int32, device=cuda)
        q = torch.randn((b, hkv, 1, dh), generator=gen, device=cuda)
        tol = 1e-4 if dtype == torch.float32 else 1e-2
        for got, want in (
                (paged_decode_ragged_cuda(q, kp, vp, bt, ctx, qn, w=1),
                 ref.paged_decode_ragged_ref(q, kp, vp, bt, ctx, qn, w=1)),
                (paged_attention_cuda(q, kp, vp, bt, ctx + 1),
                 ref.paged_attention_ref(q, kp, vp, bt, ctx + 1))):
            assert ((got - want).abs()
                    <= tol * (1 + want.abs().amax())).all(), dtype
    lut = spx.codebook(spx.scheme_levels("sp2_4"), device=cuda)
    for k, n in ((768, 768), (768, 3072), (3072, 768)):
        codes = torch.randint(0, 256, (k, n // 2), generator=gen,
                              device=cuda, dtype=torch.int32).to(torch.uint8)
        scale = torch.rand((1, n), generator=gen, device=cuda) * 0.05
        x = torch.randn((1500, k), generator=gen, device=cuda)
        got = spx_matmul_cuda(x, codes, scale, lut, packed=True)
        want = ref.spx_matmul_ref(x, codes, scale, lut, packed=True)
        assert (got - want).abs().max() <= 1e-4 * want.abs().max(), (k, n)
        assert torch.equal(got, spx_matmul_cuda(x, codes, scale, lut,
                                                packed=True))


@pytest.mark.gpu
@pytest.mark.parametrize("b,hq,hkv,sq,skv,dh,causal", [
    (2, 8, 1, 256, 256, 256, True),         # gemma-2b's heads, training
    (2, 12, 12, 1500, 1500, 64, False),     # whisper's encoder
    (2, 12, 12, 256, 256, 64, True),        # whisper's decoder
    (2, 12, 12, 256, 1500, 64, False),      # whisper's cross-attention
    (16, 8, 2, 256, 256, 80, True)],        # granite-100m (train_llm)
    ids=["gemma", "whisper-encoder", "whisper-decoder", "whisper-cross",
         "granite-100m"])
def test_cuda_flash_function_grads_match_plain_autograd(cuda, b, hq, hkv, sq,
                                                        skv, dh, causal):
    """The flash kernel inside ``FlashAttentionFn`` on the card: its output
    is the kernel's, bit for bit, and its gradients equal plain autograd
    through the plain version within 1e-4 of each input's largest
    gradient (the forward differs from the plain version by the kernel's
    f32 sums in another order; the backward recomputes the plain one)."""
    from repro_torch.kernels.flash_attention import (FUNCTION_CALLS,
                                                     flash_attention_autograd,
                                                     flash_attention_cuda)
    gen = torch.Generator(device=cuda).manual_seed(11)
    q = torch.randn((b, hq, sq, dh), generator=gen, device=cuda)
    k, v = (torch.randn((b, hkv, skv, dh), generator=gen, device=cuda)
            for _ in range(2))
    g = torch.randn(q.shape, generator=gen, device=cuda)

    def run(fn):
        ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = fn(*ts)
        return out.detach(), torch.autograd.grad(out, ts, g)
    FUNCTION_CALLS.clear()
    ops.reset_op_calls()
    got, got_g = run(lambda *t: flash_attention_autograd(
        *t, causal=causal, q_chunk=1024))
    assert ops.op_calls() == {"flash_attention": 1}
    assert FUNCTION_CALLS == {"forward": 1, "backward": 1}
    assert torch.equal(got, flash_attention_cuda(q, k, v, causal=causal))
    want, want_g = run(lambda *t: ref.flash_attention_ref(
        *t, causal=causal, q_chunk=1024))
    assert _attn_close(got, want)
    for a, w in zip(got_g, want_g):
        assert (a - w).abs().max() <= 1e-4 * w.abs().max()


# ---------------------------------------------------------------------------
# The planner's knobs (REPRO_BLOCKS_MATMUL, REPRO_BLOCKS_ATTN) and measured
# autotuning (REPRO_AUTOTUNE), held against the reference's planner where
# it has the same function
# ---------------------------------------------------------------------------

_KNOBS = ("REPRO_BLOCKS_MATMUL", "REPRO_BLOCKS_ATTN", "REPRO_AUTOTUNE")


@pytest.fixture
def port_planner(monkeypatch):
    """The port's planner with no knob set, and no measured winner or
    cached launch choice left before or after."""
    from repro_torch.runtime import planner
    for var in _KNOBS:
        monkeypatch.delenv(var, raising=False)
    planner.clear_plan_cache()
    yield planner
    planner.clear_plan_cache()


@pytest.fixture
def knobs_unset(port_planner):
    """``port_planner`` and the reference's planner, both tables empty
    before and after."""
    from repro.runtime import planner as jplanner
    jplanner.clear_plan_cache()
    yield types.SimpleNamespace(port=port_planner, ref=jplanner)
    jplanner.clear_plan_cache()


#: seconds per candidate of a fake runner (None: the candidate raises)
MEASURE_CASES = {
    "faster_second": (2.0, 1.0, 3.0),
    "tie_keeps_first": (1.0, 1.0),
    "raising_first": (None, 3.0, 2.0),
    "raising_winner_skipped": (5.0, None, 4.0),
    "all_raise": (None, None),
}


@pytest.mark.parametrize("case", sorted(MEASURE_CASES))
def test_measured_best_matches_reference(knobs_unset, case):
    """``measured_best`` and ``measured_plan`` of both packages, on the same
    candidates and the same fake runner: the same winner, the same table
    after it (a raising candidate skipped, nothing kept where none could
    be measured, a kept key never measured again). The port also reports
    each candidate's seconds, None where it raised."""
    times = MEASURE_CASES[case]

    def runner(i):
        if times[i] is None:
            raise RuntimeError("refused")
        return times[i]

    def never(i):
        raise AssertionError("a kept key was measured again")
    seen = {}
    for name in ("ref", "port"):
        pkg = getattr(knobs_unset, name)
        key = ("spx_matmul", "case", case)
        best = pkg.measured_best(key, list(range(len(times))), runner)
        kept = pkg.measured_plan(key)
        again = pkg.measured_best(key, list(range(len(times))),
                                  runner if kept is None else never)
        seen[name] = (best, kept, again)
    assert seen["port"] == seen["ref"], seen
    report = knobs_unset.port.measured_report()[("spx_matmul", "case", case)]
    assert [t for _, t in report.tried] == list(times)
    assert report.seed == 0 and report.seed_s == times[0]
    assert report.best == seen["port"][1]


def test_clear_plan_cache_empties_both_tables(knobs_unset):
    """``clear_plan_cache`` drops the measured winners of both packages and
    the port's cached launch choices (``spx_matmul``'s plans, the paged
    kernels' splits and clusters) and its report."""
    from repro_torch.kernels import paged_attention, spx_matmul
    port, jref = knobs_unset.port, knobs_unset.ref
    for pkg in (port, jref):
        assert pkg.measured_best("k", [7, 8], lambda p: 1.0 / p) == 8
        assert pkg.measured_plan("k") == 8
    spx_matmul._plan(1, 784, 128, True, 16, 132)
    paged_attention.decode_splits(4, 1, 8, 16, 16, 132)
    paged_attention.decode_cluster(4, 1, 8, 16, 16, 132)
    cached = (spx_matmul._plan, paged_attention.decode_splits,
              paged_attention.decode_cluster)
    assert all(c.cache_info().currsize for c in cached)
    port.clear_plan_cache()
    jref.clear_plan_cache()
    assert port.measured_plan("k") is None and jref.measured_plan("k") is None
    assert port.measured_report() == {}
    assert not any(c.cache_info().currsize for c in cached + (
        spx_matmul.library_splits, paged_attention.cluster_used))


def test_fused_decode_key_separates_scheme_window_and_dtype(knobs_unset):
    """The port's key is the reference's fields and the pool's dtype: a
    coded pool, a verify window and a bf16 or f16 pool each key apart, and
    a winner kept for one is invisible to the others."""
    port, jref = knobs_unset.port, knobs_unset.ref
    base = dict(b=4, hkv=2, rep=4, dh=128, page_size=16, max_pages=8)
    for w, scheme in ((1, None), (5, None), (1, "spx_8_x3"), (1, "uniform8")):
        assert port.fused_decode_key(w=w, kv_scheme=scheme, **base)[:-1] == \
            jref.fused_decode_key(w=w, kv_scheme=scheme, **base)
    keys = [port.fused_decode_key(w=w, kv_scheme=scheme, pool_dtype=dtype,
                                  **base)
            for w, scheme, dtype in ((1, None, "float32"),
                                     (5, None, "float32"),
                                     (1, "spx_8_x3", torch.uint8),
                                     (1, "uniform8", torch.uint8),
                                     (1, None, torch.bfloat16),
                                     (1, None, torch.float16))]
    assert len(set(keys)) == len(keys)
    assert keys[4][-1] == "bfloat16" and keys[2][-1] == "uint8"
    assert port.measured_best(keys[0], [16, 8], lambda p: p) == 8
    assert port.measured_plan(keys[0]) == 8
    assert all(port.measured_plan(k) is None for k in keys[1:])


@pytest.mark.parametrize("scheme", [None, "uniform8", "spx_8_x3"],
                         ids=["f32", "uniform8", "spx_8_x3"])
def test_plan_fused_decode_matches_reference(knobs_unset, scheme):
    """On the reference's TPU numbers the port's §3.1 account equals the
    reference's field for field (its ``smem_bytes`` the reference's
    ``vmem_bytes``); on the H100 the relations of the reference's test
    hold: the window's rows, the 8-bit codebook resident, a coded pool's
    margin above the dense one's, a wider window's above one row's."""
    from repro.core.pipeline import TPU_V5E
    from repro_torch.core.pipeline import HwSpec
    port, jref = knobs_unset.port, knobs_unset.ref
    tpu = HwSpec(name=TPU_V5E.name, peak_bf16_flops=TPU_V5E.peak_bf16_flops,
                 hbm_bw=TPU_V5E.hbm_bw, ici_bw=TPU_V5E.ici_bw,
                 vmem_bytes=TPU_V5E.vmem_bytes)
    for w, ps, act in ((5, 16, 4), (1, 32, 2)):
        got = port.plan_fused_decode(128, rep=4, w=w, page_size=ps,
                                     act_bytes=act, kv_scheme=scheme, hw=tpu)
        want = jref.plan_fused_decode(128, rep=4, w=w, page_size=ps,
                                      act_bytes=act, kv_scheme=scheme)
        assert (got.rows, got.lut_bytes, got.pipelined, got.smem_bytes) == \
            (want.rows, want.lut_bytes, want.pipelined, want.vmem_bytes)
        assert got.margin == pytest.approx(want.margin, rel=1e-12)
    plan = port.plan_fused_decode(128, rep=4, w=5, page_size=16,
                                  kv_scheme=scheme)
    dense = port.plan_fused_decode(128, rep=4, w=5, page_size=16)
    one = port.plan_fused_decode(128, rep=4, w=1, page_size=16,
                                 kv_scheme=scheme)
    assert plan.rows == 20 and plan.smem_bytes > 0
    assert plan.lut_bytes == (0 if scheme is None else 4 * 256)
    assert plan.margin > one.margin
    if scheme is not None:
        assert plan.margin > dense.margin


@pytest.mark.parametrize("raw", ["", "64,128,128", " 64, 128 ,128", "64,128",
                                 "a,b,c", "1,2,3,4"])
def test_env_override_matches_reference(monkeypatch, knobs_unset, raw):
    """``_env_override`` parses a pin as the reference does, read at the
    call: the same ints, None when empty, ``ValueError`` where the
    reference raises (a wrong count of fields, a field not an int)."""
    monkeypatch.setenv("REPRO_BLOCKS_MATMUL", raw)
    seen = []
    for pkg in (knobs_unset.ref, knobs_unset.port):
        try:
            seen.append(pkg._env_override("REPRO_BLOCKS_MATMUL", 3))
        except ValueError as e:
            seen.append(type(e))
    assert seen[0] == seen[1], seen


@pytest.mark.parametrize("m,k,n,packed,pin,want", [
    (64, 784, 128, True, (16, 32, 128), ("small", 16, 32, 8, 0)),
    (4, 2048, 2048, True, (4, 256, 128), ("skinny", 0, 0, 0, 16)),
    (128, 2048, 16384, False, (128, 256, 256), ("mma", 0, 0, 0, 8)),
], ids=["small", "skinny", "mma"])
def test_matmul_pin_picks_the_launch_or_raises(monkeypatch, port_planner, m,
                                               k, n, packed, pin, want):
    """``REPRO_BLOCKS_MATMUL`` maps (bm, bn, bk) onto a launch at the shape:
    a small tile and 16 K rows a warp, or the decode or prefill kernel's K
    per cluster split; read at every call, past the analytical plan. A
    block no launch has raises ``ValueError`` naming the legal ones (the
    reference falls back to its oracle there; the port has no
    fallback)."""
    planner = port_planner
    analytical = planner.plan_spx_launch(m, k, n, packed, 16, 132)
    monkeypatch.setenv("REPRO_BLOCKS_MATMUL", ",".join(map(str, pin)))
    got = planner.plan_spx_launch(m, k, n, packed, 16, 132)
    assert got == planner.SpxLaunchPlan(*want) and got != analytical
    assert planner.spx_matmul_block(got, m, k) == pin
    assert planner.pinned_spx_launch(m, k, n, packed, 16) == got
    monkeypatch.setenv("REPRO_BLOCKS_MATMUL", "100,100,100")
    with pytest.raises(ValueError, match=r"legal \(bm, bn, bk\)") as err:
        planner.plan_spx_launch(m, k, n, packed, 16, 132)
    assert str(pin) in str(err.value)
    monkeypatch.delenv("REPRO_BLOCKS_MATMUL")
    assert planner.plan_spx_launch(m, k, n, packed, 16, 132) == analytical


@pytest.mark.parametrize("dh,legal", [
    (256, ((32, 32), (64, 32))),
    (128, ((32, 32), (32, 64), (64, 32), (64, 64), (128, 32), (128, 64)))])
def test_attention_pin_picks_a_built_tile_or_raises(monkeypatch, port_planner,
                                                    dh, legal):
    """The flash kernel's tile: (64, 32) unset, whose block is the parent
    kernel's 200704 bytes at dh 256; ``REPRO_BLOCKS_ATTN`` picks any built
    tile whose block fits, at lengths no tile divides (the kernel masks
    the tails, so the reference's divisibility rule does not apply); a
    tile that does not fit raises naming the legal ones."""
    planner = port_planner
    assert planner.flash_legal_tiles(dh) == legal
    unset = planner.plan_attention(33, 33, dh)
    assert (unset.bq, unset.bkv) == (64, 32)
    assert planner.flash_tile_smem_bytes(256, 64, 32) == 200704
    for bq, bkv in legal:
        monkeypatch.setenv("REPRO_BLOCKS_ATTN", f"{bq},{bkv}")
        tile = planner.plan_attention(33, 17, dh)
        assert (tile.bq, tile.bkv) == (bq, bkv)
        assert tile.smem_bytes == planner.flash_tile_smem_bytes(dh, bq, bkv) \
            <= planner.SMEM_MAX
    for bad in ("128,64", "16,32", "64,128"):
        if tuple(map(int, bad.split(","))) in legal:
            continue
        monkeypatch.setenv("REPRO_BLOCKS_ATTN", bad)
        with pytest.raises(ValueError, match=str(list(legal)).replace(
                "(", r"\(").replace(")", r"\)").replace("[", r"\[")
                .replace("]", r"\]")):
            planner.plan_attention(33, 33, dh)


#: (M values, (K, N) shapes, packed, LUT size, the library splits assumed)
CANDIDATE_SHAPES = {
    "gemma_decode": ((1, 4, 8), GEMMA_SPX_SHAPES, True, 16, 16),
    "gemma_prefill": ((9, 128, 2048), GEMMA_SPX_SHAPES, True, 16, 4),
    "paper_mlp": ((1, 64, 1024, 2048), ((784, 128), (128, 10)), True, 16, 8),
    "paper_mlp_8bit": ((1, 64, 1024), ((784, 128), (128, 10)), False, 256,
                       8),
    "q_network": ((1, 64), ((4, 64), (64, 64)), False, 256, 1),
}


@pytest.mark.parametrize("case", sorted(CANDIDATE_SHAPES))
def test_spx_launch_candidates_pass_the_planners_rules(port_planner, case):
    """What the tuner times at gemma-2b's decode and prefill keys and the
    paper's layers: the analytical launch first (its splits the
    library's), at most 12, no two alike, every block within the card's
    shared memory by the planner's own rule, the small path's warps within
    what its tile and codes allow, and each a launch a pin may name."""
    planner = port_planner
    ms, shapes, packed, lut, splits = CANDIDATE_SHAPES[case]
    for m in ms:
        for k, n in shapes:
            cands = planner.spx_launch_candidates(m, k, n, packed, lut, 132,
                                                  splits)
            seed = planner.spx_analytical_launch(m, k, n, packed, lut, 132)
            if seed.path != "small":
                seed = planner.SpxLaunchPlan(seed.path, splits=splits)
            assert cands[0] == seed and len(set(cands)) == len(cands) <= 12
            assert len(cands) > 1, (m, k, n)
            table = planner.spx_pin_table(m, k, n, packed)
            for c in cands:
                assert planner.spx_path_smem_bytes(c, m, k, packed) \
                    <= planner.SMEM_MAX, (m, k, n, c)
                assert planner.spx_matmul_block(c, m, k) in table
                if c.path == "small":
                    assert planner.spx_small_min_warps(packed) <= c.warps \
                        <= planner.spx_small_max_warps(c.tile_m, c.tile_n)
                else:
                    assert 1 <= c.splits <= 16
                    assert c.path == ("skinny" if m <= 8 else "mma")


def test_paged_launch_candidates_rule():
    """The split counts the tuner times over f32 and code pools:
    ``decode_splits`` first, half and twice it normalised to whole
    16-token groups and within the table; the cluster sizes asked for
    over 16-bit pools, down by halves to 1."""
    from repro_torch.kernels.paged_attention import (cluster_candidates,
                                                     decode_splits,
                                                     split_candidates,
                                                     split_tokens)
    assert split_candidates(4, 1, 8, 16, 16, 132) == (16, 8)
    assert split_candidates(4, 1, 8, 128, 16, 132) == (64, 32, 128)
    assert split_candidates(64, 8, 64, 16, 16, 132) == (1, 2)
    for args in ((4, 1, 8, 16, 16, 132), (3, 2, 40, 7, 16, 132),
                 (4, 1, 8, 100, 16, 132), (2, 1, 8, 33, 32, 114)):
        cands = split_candidates(*args)
        tokens = args[3] * args[4]
        assert cands[0] == decode_splits(*args)
        for s in cands:
            assert -(-tokens // split_tokens(tokens, s)) == s
            assert 1 <= s <= -(-tokens // 16)
    assert cluster_candidates(16) == (16, 8, 4, 2, 1)
    assert cluster_candidates(1) == (1,)


def test_knobs_change_nothing_on_the_cpu(monkeypatch, port_planner):
    """With all three variables set, the ops on CPU tensors take their
    plain versions as before: bit-identical outputs, no launch counted,
    the same plain calls, and no tuning."""
    gen = torch.Generator().manual_seed(28)
    w = torch.randn((96, 40), generator=gen)
    qt = tq.quantize_weight(w, "sp2_4")
    x = torch.randn((3, 96), generator=gen)
    q = torch.randn((2, 3, 4, 32), generator=gen)
    kv = torch.randn((2, 1, 40, 32), generator=gen)
    pools = torch.randn((2, 9, 1, 8, 32), generator=gen)
    bt = torch.arange(8, dtype=torch.int32).reshape(2, 4)
    ctx = torch.tensor([5, 20], dtype=torch.int32)
    ones = torch.ones(2, dtype=torch.int32)

    def run():
        ops.reset_op_calls()
        out = (ops.spx_matmul(x, qt),
               ops.flash_attention(q.repeat(1, 1, 10, 1)[:, :, :33], kv, kv),
               ops.paged_decode_ragged(q[:, :1].transpose(1, 2)
                                       .reshape(2, 1, 4, 32), pools[0],
                                       pools[1], bt, ctx, ones),
               ops.paged_attention(q[:, 0].reshape(2, 4, 32), pools[0],
                                   pools[1], bt, ctx))
        return out, ops.op_calls(), ops.ref_calls()
    plain = run()
    monkeypatch.setenv("REPRO_BLOCKS_MATMUL", "8,16,64")
    monkeypatch.setenv("REPRO_BLOCKS_ATTN", "128,64")
    monkeypatch.setenv("REPRO_AUTOTUNE", "1")
    knobbed = run()
    assert all(torch.equal(a, b) for a, b in zip(plain[0], knobbed[0]))
    assert plain[1] == knobbed[1] == {}
    assert plain[2] == knobbed[2] and sum(plain[2].values()) == 4
    assert port_planner.measured_report() == {}


def test_available_impls():
    """The impls of an op usable on a device, sorted: the plain version
    anywhere, the kernel on a CUDA device; nothing for an unknown op."""
    assert registry.available_impls("spx_matmul", "cpu") == ("ref",)
    assert registry.available_impls("spx_matmul", torch.device("cuda")) == \
        ("cuda", "ref")
    for op in registry.registered_ops():
        assert registry.available_impls(op, "cuda") == ("cuda", "ref")
    assert registry.available_impls("no_such_op", "cuda") == ()


@pytest.mark.gpu
def test_cuda_spx_launch_candidates_match_plain_version(cuda, port_planner):
    """Every launch the tuner times, at the paper's layers and gemma-2b's
    decode and prefill keys, against the plain version (1e-4 of its
    largest |output|), counted under its own path; and a pinned launch."""
    from repro_torch.core import spx
    from repro_torch.kernels import spx_matmul as sm
    planner = port_planner
    gen = torch.Generator(device=cuda).manual_seed(28)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for scheme, packed, m, k, n in (
            ("sp2_4", True, 1, 784, 128), ("sp2_4", True, 64, 784, 128),
            ("sp2_4", True, 1024, 128, 10), ("sp2_8", False, 1, 784, 128),
            ("sp2_8", False, 1, 4, 64), ("sp2_4", True, 4, 2048, 2048),
            ("sp2_4", True, 128, 2048, 256)):
        lut = spx.codebook(spx.scheme_levels(scheme), device=cuda)
        codes = torch.randint(0, lut.numel(), (k, n // 2 if packed else n),
                              generator=gen, device=cuda,
                              dtype=torch.int32).to(torch.uint8)
        scale = torch.rand((1, n), generator=gen, device=cuda) * 0.05
        x = torch.randn((m, k), generator=gen, device=cuda)
        want = ref.spx_matmul_ref(x, codes, scale, lut, packed=packed)
        cands = planner.spx_launch_candidates(
            m, k, n, packed, lut.numel(), sms, sm.library_splits(m, k, n, sms))
        for plan in cands:
            ops.reset_op_calls()
            got = sm.spx_matmul_cuda(x, codes, scale, lut, packed=packed,
                                     plan=plan)
            assert (got - want).abs().max() <= 1e-4 * want.abs().max(), plan
            assert ops.path_calls() == {f"spx_matmul_{plan.path}": 1}


@pytest.mark.gpu
def test_cuda_flash_tiles_match_plain_version(cuda, monkeypatch,
                                              port_planner):
    """Each built flash tile, pinned by ``REPRO_BLOCKS_ATTN``, at every
    head dim: causal and not, GQA 8 and 1, lengths no tile divides;
    within 1e-4 (1 + |plain|); the library's block bytes equal the
    planner's."""
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels.flash_attention import (HEAD_DIMS,
                                                     flash_attention_cuda)
    planner = port_planner
    lib = cuda_lib.library("flash_attention")
    gen = torch.Generator(device=cuda).manual_seed(28)
    for dh in HEAD_DIMS:
        for bq, bkv in planner.FLASH_TILES:
            built = lib.flash_attention_tile_bytes(dh, bq, bkv)
            legal = (bq, bkv) in planner.flash_legal_tiles(dh)
            assert built == (planner.flash_tile_smem_bytes(dh, bq, bkv)
                             if legal else 0), (dh, bq, bkv)
        for bq, bkv in planner.flash_legal_tiles(dh):
            monkeypatch.setenv("REPRO_BLOCKS_ATTN", f"{bq},{bkv}")
            for s, skv, hkv, rep in ((33, 33, 1, 8), (130, 97, 2, 1)):
                q = torch.randn((2, hkv * rep, s, dh), generator=gen,
                                device=cuda)
                k, v = (torch.randn((2, hkv, skv, dh), generator=gen,
                                    device=cuda) for _ in range(2))
                for causal in (True, False):
                    got = flash_attention_cuda(q, k, v, causal=causal)
                    want = ref.flash_attention_ref(q, k, v, causal=causal,
                                                   q_chunk=s)
                    assert ((got - want).abs()
                            <= 1e-4 * (1 + want.abs())).all(), (dh, bq, bkv)


@pytest.mark.gpu
def test_cuda_paged_launch_candidates_match_plain_version(cuda, port_planner):
    """Every split count and cluster the tuner times, over f32, code and
    bf16 pools, in both modes: f32 and code pools within 1e-4 (1 +
    |plain|), bf16 pools within 1e-2 of each slot's peak."""
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.nn.attention import kv_lut, quantize_kv
    gen = torch.Generator(device=cuda).manual_seed(28)
    sms = cuda_lib.sm_count(0)
    b, hkv, rep, dh, ps, mp = 4, 1, 8, 256, 16, 32
    n_pages = 1 + b * mp
    bt = torch.randperm(n_pages, generator=gen, device=cuda)[:b * mp] \
        .reshape(b, mp).to(torch.int32)
    ctx = torch.tensor([0, 48, 300, mp * ps - 1], dtype=torch.int32,
                       device=cuda)
    ones = torch.ones(b, dtype=torch.int32, device=cuda)
    q = torch.randn((b, hkv, rep, dh), generator=gen, device=cuda)
    kp, vp = (torch.randn((n_pages, hkv, ps, dh), generator=gen, device=cuda)
              for _ in range(2))
    want = ref.paged_decode_ragged_ref(q, kp, vp, bt, ctx, ones, w=1)
    for s in pa.launch_candidates(torch.float32, b, hkv, rep, dh, mp, ps,
                                  sms):
        got = pa.paged_decode_ragged_cuda(q, kp, vp, bt, ctx, ones, w=1,
                                          plan=s)
        assert ((got - want).abs() <= 1e-4 * (1 + want.abs())).all(), s
    lut = kv_lut("spx_8_x3", cuda)
    kc, ks = quantize_kv(kp, "spx_8_x3")
    vc, vs = quantize_kv(vp, "spx_8_x3")
    want = ref.paged_attention_quant_ref(q, kc, ks, vc, vs, bt, ctx + 1, lut)
    for s in pa.launch_candidates(torch.uint8, b, hkv, rep, dh, mp, ps, sms):
        got = pa.paged_attention_quant_cuda(q, kc, ks, vc, vs, bt, ctx + 1,
                                            lut, plan=s)
        assert ((got - want).abs() <= 1e-4 * (1 + want.abs())).all(), s
    kb, vb = kp.to(torch.bfloat16), vp.to(torch.bfloat16)
    want = ref.paged_decode_ragged_ref(q, kb, vb, bt, ctx, ones, w=1)
    clusters = pa.launch_candidates(torch.bfloat16, b, hkv, rep, dh, mp, ps,
                                    sms)
    assert clusters[0] == pa.cluster_used(
        torch.bfloat16, dh, pa.decode_cluster(b, hkv, rep, mp, ps, sms))
    for c in clusters:
        got = pa.paged_decode_ragged_cuda(q, kb, vb, bt, ctx, ones, w=1,
                                          plan=c)
        peak = want.abs().amax(dim=(1, 2, 3), keepdim=True)
        assert ((got - want).abs() <= 1e-2 * peak).all(), c


@pytest.mark.gpu
def test_cuda_autotune_ops_match_plain_versions(cuda, monkeypatch,
                                                port_planner):
    """Under ``REPRO_AUTOTUNE=1`` the ops measure each new key once (the
    analytical launch first), keep the winner and launch it; the outputs
    match the plain versions; a second call measures nothing."""
    from repro_torch.core import spx
    planner = port_planner
    monkeypatch.setenv("REPRO_AUTOTUNE", "1")
    gen = torch.Generator(device=cuda).manual_seed(28)
    w = torch.randn((784, 128), generator=gen, device=cuda)
    qt = tq.quantize_weight(w, "sp2_4")
    x = torch.randn((1, 784), generator=gen, device=cuda)
    lut = spx.codebook(spx.scheme_levels("sp2_4"), device=cuda)
    want = ref.spx_matmul_ref(x, qt.codes, qt.scale.reshape(1, -1), lut,
                              packed=True)
    got = ops.spx_matmul(x, qt)
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()
    report = planner.measured_report()
    assert len(report) == 1
    (key, r), = report.items()
    assert key[:4] == ("spx_matmul", 1, 784, 128) and r.best is not None
    assert r.seed == planner.spx_analytical_launch(1, 784, 128, True, 16,
                                                   key[-1])
    ops.reset_op_calls()
    ops.spx_matmul(x, qt)
    assert ops.op_calls() == {"spx_matmul": 1}
    assert planner.measured_report() == report
