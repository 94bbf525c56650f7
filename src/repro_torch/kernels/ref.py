"""Plain PyTorch versions of the ported kernels: the CPU path, and what
each CUDA kernel is held against on the card. Same semantics as
``repro.kernels.ref``."""
from __future__ import annotations

import torch

from repro_torch.core import spx

__all__ = ["spx_matmul_ref", "paged_attention_ref", "paged_decode_ragged_ref"]

_NEG = -1e30


def spx_matmul_ref(x, codes, scale, lut, *, packed: bool, out_dtype=None):
    """x:(..., K) @ (lut[codes:(K,N)] * scale:(1,N)) -> (..., N), with f32
    accumulation and the per-column scale applied after the product."""
    out_dtype = out_dtype or x.dtype
    if packed:
        codes = spx.unpack_int4(codes)
    w = lut[codes.long()]                                  # (K, N) f32
    acc = torch.matmul(x.to(torch.float32), w.to(torch.float32))
    return (acc * scale).to(out_dtype)


def _gather(pages, block_table):
    """(n_pages, Hkv, ps, dh) pool -> (B, Hkv, max_pages * ps, dh) view of
    each row's pages in logical order."""
    b, max_pages = block_table.shape
    _, hkv, ps, dh = pages.shape
    g = pages[block_table.long()]                  # (B, max_pages, Hkv, ps, dh)
    return g.permute(0, 2, 1, 3, 4).reshape(b, hkv, max_pages * ps, dh)


def paged_attention_ref(q, k_pages, v_pages, block_table, ctx_len, *,
                        out_dtype=None):
    """Single-token decode attention over a paged KV cache.

    q: (B, Hkv, rep, dh); k_pages/v_pages: (n_pages, Hkv, page_size, dh);
    block_table: (B, max_pages) int32; ctx_len: (B,) int32 — positions
    < ctx_len are attended; ctx_len == 0 gives zeros. Returns
    (B, Hkv, rep, dh)."""
    out_dtype = out_dtype or q.dtype
    k = _gather(k_pages, block_table).to(torch.float32)
    v = _gather(v_pages, block_table).to(torch.float32)
    dh = q.shape[-1]
    s = torch.einsum("bhrd,bhkd->bhrk", q.to(torch.float32), k) * (dh ** -0.5)
    pos = torch.arange(k.shape[2], device=q.device)
    ctx = ctx_len.to(q.device).long()
    s = torch.where(pos[None, None, None, :] < ctx[:, None, None, None],
                    s, torch.full_like(s, _NEG))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhrk,bhkd->bhrd", p, v) / torch.clamp(l, min=1e-30)
    o = torch.where(ctx[:, None, None, None] > 0, o, torch.zeros_like(o))
    return o.to(out_dtype)


def paged_decode_ragged_ref(q, k_pages, v_pages, block_table, ctx_len,
                            q_len, *, w: int, out_dtype=None):
    """Ragged decode-window attention over a paged KV cache.

    q: (B, Hkv, R, dh), R = rep * w rows, rep-major (row ``r * w + i`` is
    window position i of query head r). Window position i attends
    positions <= ctx_len + i; rows with i >= q_len come back exactly zero.
    Returns (B, Hkv, R, dh)."""
    out_dtype = out_dtype or q.dtype
    k = _gather(k_pages, block_table).to(torch.float32)
    v = _gather(v_pages, block_table).to(torch.float32)
    r_rows, dh = q.shape[2], q.shape[3]
    s = torch.einsum("bhrd,bhkd->bhrk", q.to(torch.float32), k) * (dh ** -0.5)
    win = torch.arange(r_rows, device=q.device) % w
    pos = torch.arange(k.shape[2], device=q.device)
    ctx = ctx_len.to(q.device).long()
    qn = q_len.to(q.device).long()
    row_ok = win[None, None, :, None] < qn[:, None, None, None]
    mask = (pos[None, None, None, :]
            <= ctx[:, None, None, None] + win[None, None, :, None]) & row_ok
    s = torch.where(mask, s, torch.full_like(s, _NEG))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhrk,bhkd->bhrd", p, v) / torch.clamp(l, min=1e-30)
    o = torch.where(row_ok, o, torch.zeros_like(o))
    return o.to(out_dtype)
