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


def _bf16_case(rng, dh, ps, w):
    """Kernels 2 and 5 over bf16 pages: 4 slots, 2 KV heads under rep 2,
    3 pages per slot. Slot 0 is empty (ctx_len 0), slot 1's window
    crosses a page boundary (ctx = ps - 2), slot 2 ends one token into its
    last page. The bf16 values are made in torch and handed to JAX as the
    f32 values they are, so both sides hold the same bf16 pages."""
    b, hkv, rep, mp = 4, 2, 2, 3
    n_pages = 1 + b * mp
    kp, vp = (torch.from_numpy(rng.standard_normal(
        (n_pages, hkv, ps, dh)).astype(np.float32)).bfloat16()
        for _ in range(2))
    bt = rng.permutation(n_pages)[:b * mp].reshape(b, mp).astype(np.int32)
    q = rng.standard_normal((b, w, hkv * rep, dh)).astype(np.float32)
    ctx = np.asarray([0, ps - 2, 2 * ps + 1 - w, 3 * ps - w], np.int32)
    qlen = np.asarray([0, w, max(1, w - 2), w], np.int32)
    return q, kp, vp, bt, ctx, qlen


def _jbf16(jx, t):
    return jx.jnp.asarray(t.float().numpy()).astype(jx.jnp.bfloat16)


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


def _attn_close(got, want) -> bool:
    return bool(((got - want).abs() <= 1e-4 * (1 + want.abs())).all())


@pytest.mark.gpu
def test_cuda_paged_decode_splits_modes_deterministic(cuda):
    """Contexts that take several splits (up to 2048 tokens, one ending
    one token into a page), ragged q_len at w in {1, 5, 8}, an empty slot,
    and the in-kernel single-token mode, on f32 and code pages; two
    launches on the same inputs are bit-identical."""
    from repro_torch.kernels.paged_attention import (
        paged_attention_cuda, paged_attention_quant_cuda,
        paged_decode_ragged_cuda, paged_decode_ragged_quant_cuda)
    from repro_torch.nn.attention import kv_lut, quantize_kv
    gen = torch.Generator(device=cuda).manual_seed(1)
    b, hkv, rep, dh, tokens = 4, 1, 8, 256, 2048
    lut = kv_lut("spx_8_x3", cuda)
    for quant, ps in ((False, 16), (True, 32)):
        mp = tokens // ps
        n_pages = 1 + b * mp
        k = torch.randn((n_pages, hkv, ps, dh), generator=gen, device=cuda)
        v = torch.randn((n_pages, hkv, ps, dh), generator=gen, device=cuda)
        bt = (torch.randperm(n_pages - 1, generator=gen, device=cuda)[
            :b * mp].reshape(b, mp) + 1).to(torch.int32)
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
            assert _attn_close(got, want), (quant, w)
            assert torch.equal(got, again), (quant, w)
            rows_off = torch.arange(rep * w, device=cuda) % w >= qn[:, None]
            assert (got.permute(0, 2, 1, 3)[rows_off] == 0).all()
        ctx1 = torch.tensor([0, 1, 3 * ps + 1, tokens], dtype=torch.int32,
                            device=cuda)
        q = torch.randn((b, hkv, rep, dh), generator=gen, device=cuda)
        got = single(q, *pools, ctx1, *extra)
        again = single(q, *pools, ctx1, *extra)
        want = single_ref(q, *pools, ctx1, *extra)
        assert _attn_close(got, want) and torch.equal(got, again), quant
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


@pytest.mark.gpu
def test_cuda_bf16_pages_match_plain_version(cuda):
    """Kernels 2 and 5 over bf16 pages (the ``Bf16Page`` instance) at dh in
    {32, 64, 128, 256} and page sizes 16 and 32, W = 1 and 5, an empty
    slot, a window across a page boundary, and a context of 2048 tokens
    that splits: within 1e-2 of the plain version's largest |output| in
    each slot (the kernel rounds each probability to bf16, the plain
    version does not),
    masked rows exact zeros, a second launch bit-identical, and every
    launch counted under the bf16 route."""
    from repro_torch.kernels.paged_attention import (paged_attention_cuda,
                                                     paged_decode_ragged_cuda)
    gen = torch.Generator(device=cuda).manual_seed(16)
    ops.reset_op_calls()
    launches = 0
    for dh in (32, 64, 128, 256):
        for ps in (16, 32):
            for w, mp in ((1, 3), (5, 3), (1, 2048 // ps)):
                b, hkv, rep = 4, 2 if dh < 256 else 1, 8 if w == 1 else 2
                n_pages = 1 + b * mp
                kp, vp = (torch.randn((n_pages, hkv, ps, dh), generator=gen,
                                      device=cuda).bfloat16()
                          for _ in range(2))
                bt = (torch.randperm(n_pages - 1, generator=gen,
                                     device=cuda)[:b * mp].reshape(b, mp)
                      + 1).to(torch.int32)
                top = mp * ps
                ctx = torch.tensor([0, ps - 2, top - 1 - w, top - w],
                                   dtype=torch.int32, device=cuda)
                qn = torch.tensor([0, w, max(1, w - 2), w],
                                  dtype=torch.int32, device=cuda)
                q = torch.randn((b, hkv, rep * w, dh), generator=gen,
                                device=cuda)
                got = paged_decode_ragged_cuda(q, kp, vp, bt, ctx, qn, w=w)
                again = paged_decode_ragged_cuda(q, kp, vp, bt, ctx, qn, w=w)
                want = ref.paged_decode_ragged_ref(q, kp, vp, bt, ctx, qn,
                                                   w=w)
                case = (dh, ps, w, mp)
                assert got.dtype == torch.float32, case
                assert _slot_rel_err(got.cpu(), want.cpu()) <= 1e-2, case
                assert torch.equal(got, again), case
                rows_off = torch.arange(rep * w, device=cuda) % w \
                    >= qn[:, None]
                assert (got.permute(0, 2, 1, 3)[rows_off] == 0).all(), case
                ctx1 = torch.tensor([0, 1, ps + 1, top], dtype=torch.int32,
                                    device=cuda)
                q1 = q[:, :, :rep].contiguous()
                got = paged_attention_cuda(q1, kp, vp, bt, ctx1)
                again = paged_attention_cuda(q1, kp, vp, bt, ctx1)
                want = ref.paged_attention_ref(q1, kp, vp, bt, ctx1)
                assert _slot_rel_err(got.cpu(), want.cpu()) <= 1e-2, case
                assert torch.equal(got, again) and (got[0] == 0).all(), case
                launches += 2
    assert ops.op_calls() == {"paged_decode_ragged_bf16": launches,
                              "paged_attention_bf16": launches}
    with pytest.raises(TypeError, match="bfloat16"):
        # a bf16 K pool beside an f32 V pool
        paged_decode_ragged_cuda(q, kp, vp.float(), bt, ctx, qn, w=w)


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
