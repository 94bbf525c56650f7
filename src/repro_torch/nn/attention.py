"""GQA attention over the paged KV cache (serving): chunked prefill and the
fused decode tick. The dense-cache, training and context-parallel paths of
``repro.nn.attention`` are not in this port yet.

The page pools are updated **in place** (indexed assignment) where the
reference rebuilds them functionally; the functions still return them so
callers read like the reference.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.runtime import Runtime

from .layers import dense_apply, dense_init
from .rotary import apply_rope

__all__ = ["attn_init", "paged_kv_write", "attn_paged_step"]

_NEG = -1e30


def attn_init(gen: torch.Generator, d_model: int, n_heads: int,
              n_kv_heads: int, head_dim: int, *, qkv_bias: bool = False,
              dtype=torch.float32, device="cpu") -> dict:
    kw = dict(dtype=dtype, device=device)
    return {
        "wq": dense_init(gen, d_model, n_heads * head_dim, bias=qkv_bias,
                         **kw),
        "wk": dense_init(gen, d_model, n_kv_heads * head_dim, bias=qkv_bias,
                         **kw),
        "wv": dense_init(gen, d_model, n_kv_heads * head_dim, bias=qkv_bias,
                         **kw),
        "wo": dense_init(gen, n_heads * head_dim, d_model, **kw),
    }


def _project_qkv(p, x, n_heads, n_kv_heads, head_dim, rt):
    b, s, _ = x.shape
    q = dense_apply(p["wq"], x, rt).reshape(b, s, n_heads, head_dim)
    k = dense_apply(p["wk"], x, rt).reshape(b, s, n_kv_heads, head_dim)
    v = dense_apply(p["wv"], x, rt).reshape(b, s, n_kv_heads, head_dim)
    return q, k, v


def _apply_positional(q, k, positions, rope_theta, mrope_sections):
    if mrope_sections is not None:
        raise NotImplementedError(
            "M-RoPE (qwen2-vl) is not ported yet (ROADMAP.md: the other "
            "architecture families)")
    return (apply_rope(q, positions, theta=rope_theta),
            apply_rope(k, positions, theta=rope_theta))


def paged_kv_write(k_pages, v_pages, k_new, v_new, block_table, positions,
                   valid):
    """Scatter a chunk of new K/V rows into the physical page pools, in
    place. k_pages/v_pages: (n_pages, Hkv, page_size, dh); k_new/v_new:
    (B, C, Hkv, dh); block_table: (B, max_pages); positions: (B, C)
    absolute token positions; valid: (B, C) bool — False rows (chunk
    padding, inactive slots) are not written."""
    _, hkv, ps, dh = k_pages.shape
    logical = torch.clamp(positions // ps, 0, block_table.shape[1] - 1)
    phys = torch.gather(block_table.long(), 1, logical.long())
    sel = valid.reshape(-1)
    pg = phys.reshape(-1)[sel]
    off = (positions % ps).reshape(-1)[sel].long()
    k_pages[pg, :, off, :] = k_new.reshape(-1, hkv, dh)[sel].to(k_pages.dtype)
    v_pages[pg, :, off, :] = v_new.reshape(-1, hkv, dh)[sel].to(v_pages.dtype)
    return k_pages, v_pages


def _gather_pages(pages, block_table):
    """One sequence's pages as a contiguous (B, Hkv, S, dh) view,
    S = max_pages * page_size."""
    b, max_pages = block_table.shape
    _, hkv, ps, dh = pages.shape
    g = pages[block_table.long()]                  # (B, max_pages, Hkv, ps, dh)
    return g.permute(0, 2, 1, 3, 4).reshape(b, hkv, max_pages * ps, dh)


def _paged_chunk_attention(q, k_pages, v_pages, block_table, positions,
                           attend_len):
    """Attention of a C-token chunk against the full paged context
    (including the chunk itself, already written to the pages). Plain
    tensor code, as in the reference: prefill gathers the pages.

    q: (B, Hq, C, dh); positions: (B, C) absolute query positions;
    attend_len: (B,) total attendable tokens. Returns (B, Hq, C, dh)."""
    b, hq, c, dh = q.shape
    hkv = k_pages.shape[1]
    rep = hq // hkv
    k = _gather_pages(k_pages, block_table).to(torch.float32)
    v = _gather_pages(v_pages, block_table).to(torch.float32)
    if rep > 1:
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32), k) * (dh ** -0.5)
    kv_pos = torch.arange(k.shape[2], device=q.device)
    mask = ((kv_pos[None, None, :] <= positions[:, :, None])
            & (kv_pos[None, None, :] < attend_len[:, None, None]))
    s = torch.where(mask[:, None], s, torch.full_like(s, _NEG))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v)
    return (o / torch.clamp(l, min=1e-30)).to(q.dtype)


def attn_paged_step(p: dict, x: torch.Tensor, ctx_len: torch.Tensor,
                    block_table: torch.Tensor, cache: dict, *, n_heads: int,
                    n_kv_heads: int, head_dim: int, n_valid: torch.Tensor,
                    rope_theta: float = 10000.0, mrope_sections=None,
                    rt: Runtime, fused: bool = False):
    """Attention sublayer over the paged KV cache — chunked prefill (C > 1)
    and decode (C == 1) through one path.

    x: (B, C, D) — the next C tokens of each sequence; ctx_len: (B,) tokens
    already in the pages; n_valid: (B,) valid tokens in this chunk (0 =
    inactive row); cache: {"kp", "vp"} pools of this layer. ``fused``
    routes the attention through the ragged decode kernel
    (``ops.paged_decode_ragged``, n_valid as the per-slot ``q_len``); else
    a one-token chunk goes to ``ops.paged_attention`` and a wider chunk
    gathers the pages. Returns (y (B, C, D), cache)."""
    if isinstance(cache["kp"], dict):
        raise NotImplementedError(
            "quantized KV pools are not ported yet (ROADMAP.md: SPx KV "
            "cache)")
    b, c, _ = x.shape
    q, k, v = _project_qkv(p, x, n_heads, n_kv_heads, head_dim, rt)
    positions = ctx_len[:, None] + torch.arange(c, dtype=ctx_len.dtype,
                                                device=x.device)
    q, k = _apply_positional(q, k, positions, rope_theta, mrope_sections)
    valid = torch.arange(c, device=x.device)[None, :] < n_valid[:, None]
    kp, vp = paged_kv_write(cache["kp"], cache["vp"], k, v, block_table,
                            positions, valid)
    attend_len = ctx_len + n_valid
    if fused:
        out = ops.paged_decode_ragged(q, kp, vp, block_table, ctx_len,
                                      n_valid, impl=rt.impl)
        o = out.reshape(b, c, n_heads * head_dim)
    elif c == 1:
        q1 = q[:, 0].reshape(b, n_heads, head_dim)
        out = ops.paged_attention(q1, kp, vp, block_table, attend_len,
                                  impl=rt.impl)
        o = out.reshape(b, 1, n_heads * head_dim)
    else:
        qh = q.transpose(1, 2)                           # (B, Hq, C, dh)
        o = _paged_chunk_attention(qh, kp, vp, block_table, positions,
                                   attend_len)
        o = o.transpose(1, 2).reshape(b, c, n_heads * head_dim)
    y = dense_apply(p["wo"], o, rt)
    return y, dict(cache, kp=kp, vp=vp)
