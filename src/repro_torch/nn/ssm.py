"""Recurrent blocks: Mamba (Jamba's mixer) and xLSTM's mLSTM and sLSTM,
each in four forms — the full-sequence ``*_apply`` (train and prefill),
the one-token ``*_decode_step``, and the ``*_paged_step`` of serving, a
ragged C-token chunk against state gathered from the engine's slab region.
Their projections go through ``dense_apply`` (``spx_matmul`` for quantized
weights); the recurrences are plain tensor code, as the reference's
``lax.scan`` bodies are.

PyTorch has no associative scan: the selective scan runs its steps in
order inside each chunk of ``SSM_CHUNK`` tokens, where the reference
composes them associatively. The chunk length and the states each chunk
returns are the reference's; the sums are taken in another order, so the
outputs agree to rounding, not bit for bit. The chunkwise mLSTM keeps the
reference's chunk form as it is (masked exponents before ``exp``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.quantized import QuantizedTensor
from repro_torch.runtime import Runtime

from .layers import dense_apply, dense_init

__all__ = [
    "mamba_init", "mamba_apply", "mamba_decode_step", "mamba_init_state",
    "mamba_paged_step",
    "mlstm_init", "mlstm_apply", "mlstm_decode_step", "mlstm_init_state",
    "mlstm_paged_step",
    "slstm_init", "slstm_apply", "slstm_decode_step", "slstm_init_state",
    "slstm_paged_step", "SSM_CHUNK",
]

SSM_CHUNK = 128


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_sigmoid``: -softplus(-x); exactly 0.0 at x = 1e9."""
    return -_softplus(-x)


def _split(t: torch.Tensor, sizes) -> tuple:
    return torch.split(t, list(sizes), dim=-1)


# ===========================================================================
# Mamba (selective SSM, the mamba-1 form Jamba uses)
# ===========================================================================

def mamba_init(gen: torch.Generator, d_model: int, *, d_state: int = 16,
               d_conv: int = 4, expand: int = 2, dt_rank: int | None = None,
               dtype=torch.float32, device="cpu") -> dict:
    di = expand * d_model
    dt_rank = dt_rank or max(16, d_model // 16)
    kw = dict(dtype=dtype, device=device)
    a = torch.arange(1, d_state + 1, dtype=torch.float32, device=device)
    return {
        "in_proj": dense_init(gen, d_model, 2 * di, **kw),
        "conv_w": torch.randn((d_conv, di), generator=gen, **kw) * 0.2,
        "conv_b": torch.zeros((di,), **kw),
        "x_proj": dense_init(gen, di, dt_rank + 2 * d_state, **kw),
        "dt_proj": {"w": torch.randn((dt_rank, di), generator=gen, **kw)
                    * dt_rank ** -0.5,
                    "b": torch.log(torch.exp(torch.full(
                        (di,), 0.01, device=device)) - 1.0).to(dtype)},
        "A_log": torch.log(a.expand(di, d_state)).to(dtype).contiguous(),
        "D": torch.ones((di,), **kw),
        "out_proj": dense_init(gen, di, d_model, **kw),
    }


def _mamba_dims(p):
    d_conv, di = p["conv_w"].shape
    d_state = p["A_log"].shape[1]
    w = p["dt_proj"]["w"]
    dt_rank = w.logical_shape[0] if isinstance(w, QuantizedTensor) \
        else w.shape[0]
    return di, d_state, d_conv, dt_rank


def mamba_init_state(p, batch: int, dtype=torch.float32) -> dict:
    di, d_state, d_conv, _ = _mamba_dims(p)
    dev = p["conv_w"].device
    return {"h": torch.zeros((batch, di, d_state), dtype=torch.float32,
                             device=dev),
            "conv": torch.zeros((batch, d_conv - 1, di), dtype=dtype,
                                device=dev)}


def _causal_depthwise_conv(x, w, b):
    """x: (B, S, di); w: (dc, di). Causal, per channel."""
    dc, s = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, dc - 1, 0))
    out = torch.zeros_like(x)
    for j in range(dc):
        out = out + pad[:, j:j + s, :] * w[j]
    return out + b


def _selective_scan(u, dt, A, Bm, Cm, D, h0, *, chunk: int = SSM_CHUNK):
    """u, dt: (B, S, di); A: (di, ds); Bm/Cm: (B, S, ds); h0: (B, di, ds).
    Returns y (B, S, di) and the final state. Chunks of ``chunk`` steps
    (the whole sequence when it does not divide), each run step by step
    in f32 from the carried state."""
    b, s, di = u.shape
    c = min(chunk, s)
    if s % c:
        c = s
    h = h0
    ys = []
    for c0 in range(0, s, c):
        u32 = u[:, c0:c0 + c].to(torch.float32)
        dt32 = dt[:, c0:c0 + c].to(torch.float32)
        dA = torch.exp(dt32[..., None] * A)                 # (B, c, di, ds)
        dBu = dt32[..., None] * Bm[:, c0:c0 + c].to(torch.float32)[
            :, :, None, :] * u32[..., None]
        hs = []
        for t in range(c):
            h = dA[:, t] * h + dBu[:, t]
            hs.append(h)
        hs = torch.stack(hs, dim=1)                         # (B, c, di, ds)
        y_c = torch.einsum("bcds,bcs->bcd", hs,
                           Cm[:, c0:c0 + c].to(torch.float32))
        ys.append(y_c.to(u.dtype))
    y = torch.cat(ys, dim=1) + u * D.to(u.dtype)
    return y, h


def mamba_apply(p: dict, x: torch.Tensor, *, rt: Runtime,
                state: dict | None = None, return_state: bool = False):
    """x: (B, S, D) -> (B, S, D): the full-sequence form (train and
    prefill)."""
    b, s, _ = x.shape
    di, d_state, d_conv, dt_rank = _mamba_dims(p)
    xz = dense_apply(p["in_proj"], x, rt)
    u_pre, z = _split(xz, (di, di))
    u = F.silu(_causal_depthwise_conv(u_pre, p["conv_w"], p["conv_b"]))
    proj = dense_apply(p["x_proj"], u, rt)
    dt, Bm, Cm = _split(proj, (dt_rank, d_state, d_state))
    dt = _softplus(dense_apply(p["dt_proj"], dt, rt)
                   .to(torch.float32)).to(x.dtype)
    A = -torch.exp(p["A_log"].to(torch.float32))
    h0 = (state["h"] if state is not None
          else torch.zeros((b, di, d_state), dtype=torch.float32,
                           device=x.device))
    y, hT = _selective_scan(u, dt, A, Bm, Cm, p["D"].to(torch.float32), h0)
    out = dense_apply(p["out_proj"], y.to(x.dtype) * F.silu(z), rt)
    if return_state:
        conv = F.pad(u_pre, (0, 0, d_conv - 1, 0))[:, s:s + d_conv - 1]
        return out, {"h": hT, "conv": conv.to(x.dtype)}
    return out


def _conv_step(window, conv_w, conv_b):
    """The conv output at a window's last position. window: (B, dc, di)."""
    return (window.to(torch.float32) * conv_w.to(torch.float32)).sum(1) \
        + conv_b


def mamba_decode_step(p: dict, x: torch.Tensor, state: dict, *,
                      rt: Runtime):
    """x: (B, 1, D); state: {'h': (B, di, ds), 'conv': (B, dc-1, di)}."""
    di, d_state, d_conv, dt_rank = _mamba_dims(p)
    xz = dense_apply(p["in_proj"], x, rt)
    u, z = _split(xz, (di, di))                             # (B, 1, di)
    window = torch.cat([state["conv"], u.to(state["conv"].dtype)], dim=1)
    u_c = F.silu(_conv_step(window, p["conv_w"], p["conv_b"]))[:, None, :]
    proj = dense_apply(p["x_proj"], u_c.to(x.dtype), rt)
    dt, Bm, Cm = _split(proj, (dt_rank, d_state, d_state))
    dt = _softplus(dense_apply(p["dt_proj"], dt, rt).to(torch.float32))
    A = -torch.exp(p["A_log"].to(torch.float32))
    dA = torch.exp(dt[:, 0, :, None] * A)                   # (B, di, ds)
    dBu = dt[:, 0, :, None] * Bm[:, 0, None, :] * u_c[:, 0, :, None]
    h = dA * state["h"] + dBu
    y = torch.einsum("bds,bs->bd", h, Cm[:, 0].to(torch.float32))
    y = y + u_c[:, 0].to(torch.float32) * p["D"]
    out = dense_apply(p["out_proj"], y[:, None, :].to(x.dtype) * F.silu(z),
                      rt)
    return out, {"h": h, "conv": window[:, 1:, :]}


def _paged_conv(state_conv, u_pre, n_valid, conv_w, conv_b):
    """Causal depthwise conv over a ragged C-token chunk, continuing from
    the cached window of the dc-1 pre-activations before it (the slab's
    ``conv`` leaf). u_pre: (B, C, di); n_valid: (B,). Returns the f32 conv
    outputs at every chunk position (garbage past n_valid) and the window
    advanced to end at each row's last valid token (unchanged for a row
    with n_valid == 0)."""
    c = u_pre.shape[1]
    dcm1 = state_conv.shape[1]
    window = torch.cat([state_conv, u_pre.to(state_conv.dtype)], dim=1)
    w32 = conv_w.to(torch.float32)
    win32 = window.to(torch.float32)
    out = torch.zeros(u_pre.shape, dtype=torch.float32, device=u_pre.device)
    for j in range(dcm1 + 1):
        out = out + win32[:, j:j + c, :] * w32[j]
    out = out + conv_b.to(torch.float32)
    idx = n_valid[:, None].long() + torch.arange(dcm1,
                                                 device=u_pre.device)[None]
    new_conv = torch.gather(window, 1,
                            idx[..., None].expand(-1, -1, window.shape[2]))
    return out, new_conv


def _valid(n_valid, c: int, device) -> torch.Tensor:
    """(B, C) bool: position < n_valid of its row."""
    return torch.arange(c, device=device)[None, :] < n_valid[:, None]


def mamba_paged_step(p: dict, x: torch.Tensor, state: dict, n_valid, *,
                     rt: Runtime):
    """Slab-backed ragged chunk step: x (B, C, D) with ``n_valid`` (B,)
    valid tokens per row; state {'h': (B, di, ds) f32, 'conv': (B, dc-1,
    di)}. Positions past n_valid step with dt = 0 (dA = 1, dBu = 0), so
    the returned state is that of each row's valid prefix, and a row with
    n_valid == 0 gets its state back bit for bit."""
    c = x.shape[1]
    di, d_state, d_conv, dt_rank = _mamba_dims(p)
    xz = dense_apply(p["in_proj"], x, rt)
    u_pre, z = _split(xz, (di, di))
    u_c, new_conv = _paged_conv(state["conv"], u_pre, n_valid,
                                p["conv_w"], p["conv_b"])
    u = F.silu(u_c).to(x.dtype)
    proj = dense_apply(p["x_proj"], u, rt)
    dt, Bm, Cm = _split(proj, (dt_rank, d_state, d_state))
    dt = _softplus(dense_apply(p["dt_proj"], dt, rt)
                   .to(torch.float32)).to(x.dtype)
    valid = _valid(n_valid, c, x.device)
    dt = torch.where(valid[..., None], dt, torch.zeros_like(dt))
    A = -torch.exp(p["A_log"].to(torch.float32))
    y, hT = _selective_scan(u, dt, A, Bm, Cm, p["D"].to(torch.float32),
                            state["h"])
    out = dense_apply(p["out_proj"], y.to(x.dtype) * F.silu(z), rt)
    return out, {"h": hT, "conv": new_conv}


# ===========================================================================
# mLSTM (xLSTM's matrix-memory block, stabilized exponential gating)
# ===========================================================================

def mlstm_init(gen: torch.Generator, d_model: int, *, n_heads: int = 4,
               expand: int = 2, d_conv: int = 4, dtype=torch.float32,
               device="cpu") -> dict:
    di = expand * d_model
    kw = dict(dtype=dtype, device=device)
    return {
        "in_proj": dense_init(gen, d_model, 2 * di, **kw),
        "conv_w": torch.randn((d_conv, di), generator=gen, **kw) * 0.2,
        "conv_b": torch.zeros((di,), **kw),
        "wq": dense_init(gen, di, di, **kw),
        "wk": dense_init(gen, di, di, **kw),
        "wv": dense_init(gen, di, di, **kw),
        "w_gates": dense_init(gen, di, 2 * n_heads, **kw),
        "out_norm_g": torch.ones((di,), **kw),
        "down_proj": dense_init(gen, di, d_model, **kw),
    }


def _mlstm_dims(p, n_heads):
    w = p["wq"]["w"]
    di = w.logical_shape[0] if isinstance(w, QuantizedTensor) \
        else w.shape[0]
    return di, n_heads, di // n_heads


def mlstm_init_state(p, batch: int, dtype=torch.float32, *,
                     n_heads: int = 4) -> dict:
    di, nh, dh = _mlstm_dims(p, n_heads)
    d_conv = p["conv_w"].shape[0]
    kw = dict(dtype=torch.float32, device=p["conv_w"].device)
    return {"C": torch.zeros((batch, nh, dh, dh), **kw),
            "n": torch.zeros((batch, nh, dh), **kw),
            "m": torch.zeros((batch, nh), **kw),
            "conv": torch.zeros((batch, d_conv - 1, di), dtype=dtype,
                                device=p["conv_w"].device)}


def _mlstm_qkv_gates(p, u, rt, n_heads):
    """u: (B, S, di) -> q, k, v (B, S, NH, dh), i/f gate preacts
    (B, S, NH) f32."""
    b, s, _ = u.shape
    _, nh, dh = _mlstm_dims(p, n_heads)
    q = dense_apply(p["wq"], u, rt).reshape(b, s, nh, dh)
    k = dense_apply(p["wk"], u, rt).reshape(b, s, nh, dh) * (dh ** -0.5)
    v = dense_apply(p["wv"], u, rt).reshape(b, s, nh, dh)
    gates = dense_apply(p["w_gates"], u, rt).to(torch.float32)
    ig, fg = _split(gates, (nh, nh))
    return q, k, v, ig, fg


def _mlstm_cell(C, n, m, q, k, v, ig, fg):
    """One stabilized mLSTM step. C (B, NH, dh, dh), n (B, NH, dh), m
    (B, NH); q, k, v (B, NH, dh); ig, fg (B, NH)."""
    logf = _log_sigmoid(fg)
    m_new = torch.maximum(logf + m, ig)
    fs = torch.exp(logf + m - m_new)[..., None]             # (B, NH, 1)
    is_ = torch.exp(ig - m_new)[..., None]
    kf = k.to(torch.float32)
    vf = v.to(torch.float32)
    C = fs[..., None] * C + is_[..., None] * vf[..., :, None] \
        * kf[..., None, :]
    n = fs * n + is_ * kf
    qf = q.to(torch.float32)
    num = torch.einsum("bhvk,bhk->bhv", C, qf)
    den = torch.abs(torch.einsum("bhk,bhk->bh", n, qf))
    den = torch.maximum(den, torch.exp(-m_new))[..., None]
    return C, n, m_new, num / den


def _mlstm_chunkwise(q, k, v, ig, fg, C0, n0, m0, *, chunk: int = SSM_CHUNK):
    """Chunkwise-parallel stabilized mLSTM (linear-attention form), the
    reference's chunk body. q, k, v: (B, S, NH, dh); ig, fg: (B, S, NH);
    states C0 (B, NH, dh, dh), n0 (B, NH, dh), m0 (B, NH). Returns
    (h (B, S, NH, dh), C, n, m)."""
    b, s, nh, dh = q.shape
    c = min(chunk, s)
    if s % c:
        c = s
    causal = torch.tril(torch.ones((c, c), dtype=torch.bool,
                                   device=q.device))
    Cc, nc, mc = C0, n0, m0
    hs = []
    for c0 in range(0, s, c):
        sl = slice(c0, c0 + c)
        qf = q[:, sl].to(torch.float32)
        kf = k[:, sl].to(torch.float32)
        vf = v[:, sl].to(torch.float32)
        ig_c = ig[:, sl].to(torch.float32)
        logf = _log_sigmoid(fg[:, sl].to(torch.float32))     # (B, c, NH)
        Fc = torch.cumsum(logf, dim=1)                      # inclusive
        G = torch.cummax(ig_c - Fc, dim=1).values
        m = Fc + torch.maximum(mc[:, None], G)              # (B, c, NH)
        scale0 = torch.exp(Fc + mc[:, None] - m)
        num0 = torch.einsum("bhvk,bchk->bchv", Cc, qf) * scale0[..., None]
        den0 = torch.einsum("bhk,bchk->bch", nc, qf) * scale0
        # mask the exponent, not the product: for j > t it grows like
        # F_t - F_j and overflows exp at c >= 128 (inf * 0 = NaN)
        a_j = ig_c - Fc
        expo = a_j[:, None, :, :] + (Fc - m)[:, :, None, :]  # (B, t, j, NH)
        w = torch.exp(torch.where(causal[None, :, :, None], expo,
                                  torch.full_like(expo, -torch.inf)))
        s_qk = torch.einsum("bthk,bjhk->btjh", qf, kf)
        sw = s_qk * w
        num = num0 + torch.einsum("btjh,bjhv->bthv", sw, vf)
        den = den0 + torch.sum(sw, dim=2)
        hs.append(num / torch.maximum(torch.abs(den)[..., None],
                                      torch.exp(-m)[..., None]))
        F_c = Fc[:, -1]                                     # (B, NH)
        m_c = m[:, -1]
        sc_state = torch.exp(ig_c - Fc + F_c[:, None] - m_c[:, None])
        decay = torch.exp(F_c + mc - m_c)
        Cc = decay[..., None, None] * Cc \
            + torch.einsum("bch,bchv,bchk->bhvk", sc_state, vf, kf)
        nc = decay[..., None] * nc + torch.einsum("bch,bchk->bhk",
                                                  sc_state, kf)
        mc = m_c
    return torch.cat(hs, dim=1), Cc, nc, mc


def _mlstm_out(p, h4, z, nh, dh, x, rt):
    """Per-head RMS norm of the cell output, the gain, the z gate and the
    down projection. h4: (B, S, NH, dh)."""
    b, s = h4.shape[:2]
    hn = h4.to(x.dtype)
    hn = hn * torch.rsqrt(torch.mean(hn.to(torch.float32) ** 2, dim=-1,
                                     keepdim=True) + 1e-6).to(x.dtype)
    h = hn.reshape(b, s, nh * dh) * p["out_norm_g"].to(x.dtype)
    return dense_apply(p["down_proj"], h * F.silu(z), rt)


def mlstm_apply(p: dict, x: torch.Tensor, *, rt: Runtime, n_heads: int = 4,
                state: dict | None = None, return_state: bool = False):
    """x: (B, S, D) -> (B, S, D)."""
    b, s, _ = x.shape
    di, nh, dh = _mlstm_dims(p, n_heads)
    xz = dense_apply(p["in_proj"], x, rt)
    u_pre, z = _split(xz, (di, di))
    u = F.silu(_causal_depthwise_conv(u_pre, p["conv_w"], p["conv_b"]))
    q, k, v, ig, fg = _mlstm_qkv_gates(p, u, rt, nh)
    st = state or mlstm_init_state(p, b, x.dtype, n_heads=nh)
    h4, C, n, m = _mlstm_chunkwise(q, k, v, ig, fg, st["C"], st["n"],
                                   st["m"])
    out = _mlstm_out(p, h4, z, nh, dh, x, rt)
    if return_state:
        d_conv = p["conv_w"].shape[0]
        conv = F.pad(u_pre, (0, 0, d_conv - 1, 0))[:, s:s + d_conv - 1]
        return out, {"C": C, "n": n, "m": m, "conv": conv.to(x.dtype)}
    return out


def mlstm_decode_step(p: dict, x: torch.Tensor, state: dict, *, rt: Runtime,
                      n_heads: int = 4):
    di, nh, dh = _mlstm_dims(p, n_heads)
    xz = dense_apply(p["in_proj"], x, rt)
    u, z = _split(xz, (di, di))                             # (B, 1, di)
    window = torch.cat([state["conv"], u.to(state["conv"].dtype)], dim=1)
    u_c = F.silu(_conv_step(window, p["conv_w"], p["conv_b"]))
    u_c = u_c[:, None, :].to(x.dtype)
    q, k, v, ig, fg = _mlstm_qkv_gates(p, u_c, rt, nh)
    C, n, m, h = _mlstm_cell(state["C"], state["n"], state["m"],
                             q[:, 0], k[:, 0], v[:, 0], ig[:, 0], fg[:, 0])
    out = _mlstm_out(p, h[:, None], z, nh, dh, x, rt)
    return out, {"C": C, "n": n, "m": m, "conv": window[:, 1:, :]}


def mlstm_paged_step(p: dict, x: torch.Tensor, state: dict, n_valid, *,
                     rt: Runtime, n_heads: int = 4):
    """Slab-backed ragged chunk step: x (B, C, D), ``n_valid`` (B,) valid
    tokens per row, state from the slab region. Positions past n_valid
    step as the identity through the gates — fg = 1e9 (log-sigmoid
    exactly 0.0 in f32, decay 1) and ig = -1e30 (no input) — so each row's
    state is that of its valid prefix."""
    c = x.shape[1]
    di, nh, dh = _mlstm_dims(p, n_heads)
    xz = dense_apply(p["in_proj"], x, rt)
    u_pre, z = _split(xz, (di, di))
    u_c, new_conv = _paged_conv(state["conv"], u_pre, n_valid,
                                p["conv_w"], p["conv_b"])
    u = F.silu(u_c).to(x.dtype)
    q, k, v, ig, fg = _mlstm_qkv_gates(p, u, rt, nh)
    valid = _valid(n_valid, c, x.device)[..., None]
    fg = torch.where(valid, fg, torch.full_like(fg, 1e9))
    ig = torch.where(valid, ig, torch.full_like(ig, -1e30))
    h4, C, n, m = _mlstm_chunkwise(q, k, v, ig, fg, state["C"], state["n"],
                                   state["m"])
    out = _mlstm_out(p, h4, z, nh, dh, x, rt)
    return out, {"C": C, "n": n, "m": m, "conv": new_conv}


# ===========================================================================
# sLSTM (scalar-memory xLSTM block, block-diagonal recurrence)
# ===========================================================================

def slstm_init(gen: torch.Generator, d_model: int, *, n_heads: int = 4,
               dtype=torch.float32, device="cpu") -> dict:
    dh = d_model // n_heads
    kw = dict(dtype=dtype, device=device)
    return {
        # input projections of (z, i, f, o), stacked: (D, 4D)
        "w_in": dense_init(gen, d_model, 4 * d_model, **kw),
        # block-diagonal recurrent weights per gate: (4, NH, dh, dh)
        "r": torch.randn((4, n_heads, dh, dh), generator=gen, **kw)
        * (dh ** -0.5),
        "out_proj": dense_init(gen, d_model, d_model, **kw),
    }


def slstm_init_state(p, batch: int, dtype=torch.float32) -> dict:
    _, nh, dh, _ = p["r"].shape
    return {k: torch.zeros((batch, nh, dh), dtype=torch.float32,
                           device=p["r"].device)
            for k in ("c", "n", "h", "m")}


def _slstm_cell(p, carry, x_t):
    """x_t: (B, 4D) input preactivations; carry {c, n, m, h} (B, NH, dh)."""
    _, nh, dh, _ = p["r"].shape
    b = x_t.shape[0]
    c, n, m, h = carry["c"], carry["n"], carry["m"], carry["h"]
    rec = torch.einsum("ghij,bhj->bghi", p["r"].to(torch.float32), h)
    pre = x_t.reshape(b, 4, nh, dh).to(torch.float32) + rec
    z_t = torch.tanh(pre[:, 0])
    i_t = pre[:, 1]
    f_t = pre[:, 2]
    o_t = torch.sigmoid(pre[:, 3])
    logf = _log_sigmoid(f_t)
    m_new = torch.maximum(logf + m, i_t)
    fs = torch.exp(logf + m - m_new)
    is_ = torch.exp(i_t - m_new)
    c = fs * c + is_ * z_t
    n = fs * n + is_
    h_new = o_t * c / torch.clamp(n, min=1e-6)
    return {"c": c, "n": n, "m": m_new, "h": h_new}


def slstm_apply(p: dict, x: torch.Tensor, *, rt: Runtime,
                state: dict | None = None, return_state: bool = False):
    b, s, d = x.shape
    pre = dense_apply(p["w_in"], x, rt)                     # (B, S, 4D)
    carry = state or slstm_init_state(p, b, x.dtype)
    hs = []
    for t in range(s):
        carry = _slstm_cell(p, carry, pre[:, t])
        hs.append(carry["h"])
    h = torch.stack(hs, dim=1).reshape(b, s, d).to(x.dtype)
    out = dense_apply(p["out_proj"], h, rt)
    if return_state:
        return out, carry
    return out


def slstm_decode_step(p: dict, x: torch.Tensor, state: dict, *,
                      rt: Runtime):
    b, _, d = x.shape
    pre = dense_apply(p["w_in"], x, rt)[:, 0]               # (B, 4D)
    carry = _slstm_cell(p, state, pre)
    h = carry["h"].reshape(b, 1, d).to(x.dtype)
    return dense_apply(p["out_proj"], h, rt), carry


def slstm_paged_step(p: dict, x: torch.Tensor, state: dict, n_valid, *,
                     rt: Runtime):
    """Slab-backed ragged chunk step: x (B, C, D), ``n_valid`` (B,) valid
    tokens per row. The cell runs at every position; a row past its valid
    length keeps its previous state bit for bit."""
    b, c, d = x.shape
    pre = dense_apply(p["w_in"], x, rt)                     # (B, C, 4D)
    valid = _valid(n_valid, c, x.device)
    carry = state
    hs = []
    for t in range(c):
        new = _slstm_cell(p, carry, pre[:, t])
        keep = valid[:, t, None, None]
        carry = {k: torch.where(keep, new[k], carry[k]) for k in carry}
        hs.append(carry["h"])
    h = torch.stack(hs, dim=1).reshape(b, c, d).to(x.dtype)
    return dense_apply(p["out_proj"], h, rt), carry
