"""The port's recurrent blocks (``repro_torch.nn.ssm``) and M-RoPE against
``repro.nn.ssm`` and ``repro.nn.rotary`` on JAX-made params and the same
inputs, mirroring tests/test_ssm.py: the selective scan and the chunkwise
mLSTM at chunk lengths 4 to 32, mamba, mLSTM and sLSTM in their
full-sequence, decode and paged forms (ragged ``n_valid``, across the
``SSM_CHUNK`` boundary, an inactive row's state kept bit for bit), and
``apply_mrope`` with the M-RoPE attention steps.

Tolerance: 2e-5 of the largest |value| (``_close``). The port runs the
selective scan's steps in order inside a chunk where the reference
composes them associatively, so the sums differ in order; the mLSTM
chunk form is the reference's, summed by other einsum orders."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config, reduced
from repro.nn import attention as jattn
from repro.nn import rotary as jrot
from repro.nn import ssm as jssm
from repro.runtime import Runtime as JRuntime
from repro_torch.interop import params_from_reference
from repro_torch.nn import attention as tattn
from repro_torch.nn import rotary as trot
from repro_torch.nn import ssm as tssm
from repro_torch.runtime import Runtime

JRT = JRuntime(impl="ref", q_chunk=16)
CPU = Runtime(device="cpu")
RTOL = 2e-5


@pytest.fixture(scope="module", autouse=True)
def _fresh_jax_caches():
    yield
    jax.clear_caches()


def _close(got, want, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    err = np.abs(got - want).max()
    assert err <= rtol * max(np.abs(want).max(), 1e-30), err


def _t(tree):
    return params_from_reference(tree)


def _states_close(tst, jst):
    assert set(tst) == set(jst)
    for k in jst:
        _close(tst[k], jst[k])


def test_selective_scan_matches_reference_at_every_chunk():
    rng = np.random.default_rng(0)
    B, S, di, ds = 2, 32, 8, 4
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    u, Bm, Cm = f(B, S, di), f(B, S, ds), f(B, S, ds)
    dt = rng.uniform(0.01, 0.2, (B, S, di)).astype(np.float32)
    A = -rng.uniform(0.5, 2.0, (di, ds)).astype(np.float32)
    D, h0 = f(di), f(B, di, ds)
    for chunk in (4, 8, 16, 32):
        jy, jh = jssm._selective_scan(*map(jnp.asarray, (u, dt, A, Bm, Cm,
                                                         D, h0)),
                                      chunk=chunk)
        ty, th = tssm._selective_scan(*map(torch.from_numpy,
                                           (u, dt, A, Bm, Cm, D, h0)),
                                      chunk=chunk)
        _close(ty, jy)
        _close(th, jh)


@pytest.mark.parametrize("chunk", [4, 8, 16, 32])
def test_mlstm_chunkwise_matches_reference(chunk):
    rng = np.random.default_rng(1)
    B, S, NH, dh = 2, 32, 2, 8
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    args = (f(B, S, NH, dh), f(B, S, NH, dh), f(B, S, NH, dh),
            f(B, S, NH) * 2, f(B, S, NH) * 2 + 1, f(B, NH, dh, dh) * 0.1,
            np.abs(f(B, NH, dh)) * 0.1, f(B, NH) * 0.1)
    want = jssm._mlstm_chunkwise(*map(jnp.asarray, args), chunk=chunk)
    got = tssm._mlstm_chunkwise(*map(torch.from_numpy, args), chunk=chunk)
    for g, w in zip(got, want):
        _close(g, w)


def test_log_sigmoid_of_the_identity_gate_is_exactly_zero():
    """The paged mLSTM step forces fg = 1e9 past n_valid: its log-sigmoid
    must be exactly 0.0 in f32 (decay 1), as JAX's is."""
    x = torch.tensor([1e9], dtype=torch.float32)
    assert tssm._log_sigmoid(x).item() == 0.0
    assert float(jax.nn.log_sigmoid(jnp.float32(1e9))) == 0.0


def _mamba():
    return jssm.mamba_init(jax.random.PRNGKey(4), 8, d_state=4, d_conv=4,
                           expand=2, dt_rank=4)


def _mlstm():
    return jssm.mlstm_init(jax.random.PRNGKey(6), 16, n_heads=2)


def _slstm():
    return jssm.slstm_init(jax.random.PRNGKey(7), 16, n_heads=2)


_KINDS = {
    "mamba": (_mamba, 8, jssm.mamba_apply, tssm.mamba_apply,
              jssm.mamba_decode_step, tssm.mamba_decode_step,
              jssm.mamba_paged_step, tssm.mamba_paged_step, {}),
    "mlstm": (_mlstm, 16, jssm.mlstm_apply, tssm.mlstm_apply,
              jssm.mlstm_decode_step, tssm.mlstm_decode_step,
              jssm.mlstm_paged_step, tssm.mlstm_paged_step,
              {"n_heads": 2}),
    "slstm": (_slstm, 16, jssm.slstm_apply, tssm.slstm_apply,
              jssm.slstm_decode_step, tssm.slstm_decode_step,
              jssm.slstm_paged_step, tssm.slstm_paged_step, {}),
}


def _zero_state(kind, p, b):
    if kind == "mamba":
        return jssm.mamba_init_state(p, b)
    if kind == "mlstm":
        return jssm.mlstm_init_state(p, b, n_heads=2)
    return jssm.slstm_init_state(p, b)


@pytest.mark.parametrize("kind", sorted(_KINDS))
def test_apply_and_prefill_state_match_reference(kind):
    """The full-sequence form over two chunks of SSM_CHUNK = 128 (the
    mLSTM's masked exponents at c = 128, the state carried across the
    seam), and the prefill state."""
    init, d, japply, tapply, *_, kw = _KINDS[kind]
    p = init()
    x = np.random.default_rng(10).standard_normal(
        (2, 2 * tssm.SSM_CHUNK, d)).astype(np.float32)
    jy, jst = japply(p, jnp.asarray(x), rt=JRT, return_state=True, **kw)
    ty, tst = tapply(_t(p), torch.from_numpy(x), rt=CPU, return_state=True,
                     **kw)
    assert not np.isnan(ty.numpy()).any()
    _close(ty, jy)
    _states_close(tst, jst)


@pytest.mark.parametrize("kind", sorted(_KINDS))
def test_decode_steps_match_reference(kind):
    """Prefill half the sequence, then decode one token at a time from the
    prefill state: outputs and states step for step."""
    init, d, japply, tapply, jdec, tdec, *_, kw = _KINDS[kind]
    p = init()
    x = np.random.default_rng(11).standard_normal((2, 12, d)) \
        .astype(np.float32)
    _, jst = japply(p, jnp.asarray(x[:, :6]), rt=JRT, return_state=True,
                    **kw)
    _, tst = tapply(_t(p), torch.from_numpy(x[:, :6]), rt=CPU,
                    return_state=True, **kw)
    tp = _t(p)
    for t in range(6, 12):
        jy, jst = jdec(p, jnp.asarray(x[:, t:t + 1]), jst, rt=JRT, **kw)
        ty, tst = tdec(tp, torch.from_numpy(x[:, t:t + 1]), tst, rt=CPU,
                       **kw)
        _close(ty, jy)
        _states_close(tst, jst)


@pytest.mark.parametrize("kind", sorted(_KINDS))
def test_paged_steps_match_reference_ragged(kind):
    """Chunks of uneven, ragged lengths that cross the SSM_CHUNK boundary
    (row 1 feeds fewer valid tokens per chunk than row 0), chained from
    the zero state: outputs at the valid positions and the states match
    the reference's; a row with n_valid == 0 keeps its state bit for
    bit."""
    init, d, *_, jpaged, tpaged, kw = _KINDS[kind]
    p = init()
    tp = _t(p)
    rng = np.random.default_rng(12)
    jst = _zero_state(kind, p, 2)
    tst = _t(jst)
    for c, nv in ((96, (96, 90)), (40, (40, 33)), (8, (5, 0))):
        x = rng.standard_normal((2, c, d)).astype(np.float32)
        n_valid = np.asarray(nv, np.int32)
        jy, jst = jpaged(p, jnp.asarray(x), jst, jnp.asarray(n_valid),
                         rt=JRT, **kw)
        before = {k: v.clone() for k, v in tst.items()}
        ty, tst = tpaged(tp, torch.from_numpy(x), tst,
                         torch.from_numpy(n_valid), rt=CPU, **kw)
        for i, n in enumerate(nv):
            if n:
                _close(ty[i, :n], np.asarray(jy)[i, :n])
        _states_close(tst, jst)
        if nv[1] == 0:
            for k in tst:
                assert torch.equal(tst[k][1], before[k][1]), k


def _mrope_cfgs():
    j = reduced(get_config("qwen2-vl-2b"), n_layers=2)
    return j, j.mrope_sections


def test_apply_mrope_matches_reference():
    """Distinct (t, h, w) streams, so each frequency section turns by its
    own positions."""
    _, sections = _mrope_cfgs()
    rng = np.random.default_rng(13)
    dh = 2 * sum(sections)
    x = rng.standard_normal((2, 7, 3, dh)).astype(np.float32)
    pos = rng.integers(0, 50, (2, 3, 7)).astype(np.int32)
    want = jrot.apply_mrope(jnp.asarray(x), jnp.asarray(pos),
                            sections=sections, theta=1e4)
    got = trot.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos),
                           sections=sections, theta=1e4)
    _close(got, want)
    # equal streams: RoPE exactly
    same = np.broadcast_to(pos[:, :1], pos.shape).copy()
    rope = trot.apply_rope(torch.from_numpy(x), torch.from_numpy(same[:, 0]))
    _close(trot.apply_mrope(torch.from_numpy(x), torch.from_numpy(same),
                            sections=sections), rope.numpy())


def test_mrope_attention_steps_match_reference():
    """qwen2-vl's attention sublayer with M-RoPE: the dense forward, the
    one-token decode against a dense cache, and a paged prefill chunk then
    a fused decode tick."""
    cfg, sections = _mrope_cfgs()
    p = jattn.attn_init(jax.random.PRNGKey(8), cfg.d_model, cfg.n_heads,
                        cfg.n_kv_heads, cfg.dh, qkv_bias=True)
    tp = _t(p)
    heads = dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                 head_dim=cfg.dh, mrope_sections=sections)
    rng = np.random.default_rng(14)
    b, s = 2, 9
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    pos3 = np.broadcast_to(np.arange(s, dtype=np.int32), (b, 3, s)).copy()
    jy = jattn.attn_apply_dense(p, jnp.asarray(x), jnp.asarray(pos3),
                                rt=JRT, **heads)
    ty = tattn.attn_apply_dense(tp, torch.from_numpy(x),
                                torch.from_numpy(pos3), rt=CPU, **heads)
    _close(ty, jy)

    shape = (b, cfg.n_kv_heads, 16, cfg.dh)
    jk, jv = jnp.zeros(shape), jnp.zeros(shape)
    tk, tv = torch.zeros(shape), torch.zeros(shape)
    x1 = x[:, :1]
    for pos in (0, 5):
        jy, (jk, jv) = jattn.attn_decode_step(
            p, jnp.asarray(x1), pos, (jk, jv), rt=JRT, **heads)
        ty, (tk, tv) = tattn.attn_decode_step(
            tp, torch.from_numpy(x1), pos, (tk, tv), rt=CPU, **heads)
        _close(ty, jy)
        _close(tk, jk)

    n_pages, ps = 6, 8
    bt = np.array([[4, 1, 2], [0, 5, 3]], np.int32)
    pools = (n_pages, cfg.n_kv_heads, ps, cfg.dh)
    jc = {"kp": jnp.zeros(pools), "vp": jnp.zeros(pools)}
    tc = {"kp": torch.zeros(pools), "vp": torch.zeros(pools)}
    for fused, xs, ctx, nv in ((False, x, [0, 0], [9, 6]),
                               (True, x[:, :1], [9, 6], [1, 1])):
        args = [np.asarray(a, np.int32) for a in (ctx, bt, nv)]
        jy, jc = jattn.attn_paged_step(
            p, jnp.asarray(xs), jnp.asarray(args[0]), jnp.asarray(args[1]),
            jc, n_valid=jnp.asarray(args[2]), rt=JRT, fused=fused, **heads)
        ty, tc = tattn.attn_paged_step(
            tp, torch.from_numpy(xs), *(torch.from_numpy(a)
                                        for a in args[:2]),
            tc, n_valid=torch.from_numpy(args[2]), rt=CPU, fused=fused,
            **heads)
        for i, n in enumerate(nv):
            _close(ty[i, :n], np.asarray(jy)[i, :n])
        _close(tc["kp"], jc["kp"])
