"""Plain PyTorch versions of the ported kernels: the CPU path, and what
each CUDA kernel is held against on the card. Same semantics as
``repro.kernels.ref`` (and, for ``flash_attention_ref``, as the chunked
attention of ``repro.nn.attention``)."""
from __future__ import annotations

import torch

from repro_torch.core import spx

from .paged_attention import split_tokens

__all__ = ["spx_matmul_ref", "paged_attention_ref", "paged_decode_ragged_ref",
           "paged_attention_quant_ref", "paged_decode_ragged_quant_ref",
           "paged_decode_split_ref", "flash_attention_ref"]

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
    """(n_pages, Hkv, ps, w) pool -> (B, Hkv, max_pages * ps, w) view of
    each row's pages in logical order."""
    b, max_pages = block_table.shape
    _, hkv, ps, width = pages.shape
    g = pages[block_table.long()]              # (B, max_pages, Hkv, ps, w)
    return g.permute(0, 2, 1, 3, 4).reshape(b, hkv, max_pages * ps, width)


def _gather_dequant(codes, scale, block_table, lut):
    """Code + scale pools -> the gathered f32 values lut[codes] * scale."""
    return lut[_gather(codes, block_table).long()] \
        * _gather(scale, block_table)


def _paged_softmax(q, k, v, ctx_len, out_dtype):
    """Masked-softmax core of the single-token oracles. q: (B,Hkv,rep,dh);
    k/v: (B,Hkv,S,dh) gathered views; positions < ctx_len attended,
    ctx_len == 0 rows come back zero."""
    dh = q.shape[-1]
    s = torch.einsum("bhrd,bhkd->bhrk", q.to(torch.float32),
                     k.to(torch.float32)) * (dh ** -0.5)
    pos = torch.arange(k.shape[2], device=q.device)
    ctx = ctx_len.to(q.device).long()
    s = torch.where(pos[None, None, None, :] < ctx[:, None, None, None],
                    s, torch.full_like(s, _NEG))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhrk,bhkd->bhrd", p, v.to(torch.float32)) \
        / torch.clamp(l, min=1e-30)
    o = torch.where(ctx[:, None, None, None] > 0, o, torch.zeros_like(o))
    return o.to(out_dtype)


def _ragged_softmax(q, k, v, ctx_len, q_len, w: int, out_dtype):
    """Masked-softmax core of the ragged decode-window oracles. q:
    (B, Hkv, R, dh), R = rep * w rows, rep-major (row ``r * w + i`` is
    window position i of query head r). Window position i attends
    positions <= ctx_len + i; rows with i >= q_len come back exactly
    zero."""
    r_rows, dh = q.shape[2], q.shape[3]
    s = torch.einsum("bhrd,bhkd->bhrk", q.to(torch.float32),
                     k.to(torch.float32)) * (dh ** -0.5)
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
    o = torch.einsum("bhrk,bhkd->bhrd", p, v.to(torch.float32)) \
        / torch.clamp(l, min=1e-30)
    o = torch.where(row_ok, o, torch.zeros_like(o))
    return o.to(out_dtype)


def paged_attention_ref(q, k_pages, v_pages, block_table, ctx_len, *,
                        out_dtype=None):
    """Single-token decode attention over a paged KV cache.

    q: (B, Hkv, rep, dh); k_pages/v_pages: (n_pages, Hkv, page_size, dh)
    f32 or bf16 (upcast to f32 after the gather, with the probabilities
    kept in f32, as the reference oracle does); block_table: (B,
    max_pages) int32; ctx_len: (B,) int32 — positions < ctx_len are
    attended; ctx_len == 0 gives zeros. Returns (B, Hkv, rep, dh)."""
    return _paged_softmax(q, _gather(k_pages, block_table),
                          _gather(v_pages, block_table), ctx_len,
                          out_dtype or q.dtype)


def paged_decode_ragged_ref(q, k_pages, v_pages, block_table, ctx_len,
                            q_len, *, w: int, out_dtype=None):
    """Ragged decode-window attention over a paged KV cache.

    q: (B, Hkv, R, dh), R = rep * w rows, rep-major; pools f32 or bf16,
    upcast as in ``paged_attention_ref``. Window position i attends
    positions <= ctx_len + i; rows with i >= q_len come back exactly zero.
    Returns (B, Hkv, R, dh)."""
    return _ragged_softmax(q, _gather(k_pages, block_table),
                           _gather(v_pages, block_table), ctx_len, q_len, w,
                           out_dtype or q.dtype)


def paged_attention_quant_ref(q, k_codes, k_scale, v_codes, v_scale,
                              block_table, ctx_len, lut, *, out_dtype=None):
    """``paged_attention_ref`` over quantized pools: k/v codes (n_pages,
    Hkv, page_size, dh) uint8, k/v scales (n_pages, Hkv, page_size, 1) f32,
    dequantized after the gather (``lut[codes] * scale``)."""
    return _paged_softmax(q, _gather_dequant(k_codes, k_scale, block_table,
                                             lut),
                          _gather_dequant(v_codes, v_scale, block_table,
                                          lut),
                          ctx_len, out_dtype or q.dtype)


def paged_decode_ragged_quant_ref(q, k_codes, k_scale, v_codes, v_scale,
                                  block_table, ctx_len, q_len, lut, *,
                                  w: int, out_dtype=None):
    """``paged_decode_ragged_ref`` over quantized pools (arguments as
    ``paged_attention_quant_ref`` plus q_len and w)."""
    return _ragged_softmax(q, _gather_dequant(k_codes, k_scale, block_table,
                                              lut),
                           _gather_dequant(v_codes, v_scale, block_table,
                                           lut),
                           ctx_len, q_len, w, out_dtype or q.dtype)


def paged_decode_split_ref(q, k_pages, v_pages, block_table, ctx_len,
                           q_len=None, *, w: int = 1, splits: int,
                           quant=None):
    """The CUDA paged-decode kernel's split arithmetic in plain PyTorch:
    ``paged_decode_ragged_ref`` computed per split of the block table and
    merged as the kernel merges, so the formula can be held against the
    reference on the CPU.

    Split z covers positions ``[z * t, (z + 1) * t)``, ``t =
    split_tokens(max_pages * page_size, splits)`` (the kernel's rule:
    ``ceil`` of the even share, rounded up to 16 tokens). Each split keeps
    its running max ``m`` (-1e30 where every position is masked), ``l =
    sum(exp(s - m))`` over its unmasked positions and ``acc = P @ V``; the
    merge takes ``M = max(m)``, ``c = exp(m - M)`` and returns ``sum(c *
    acc) / max(sum(c * l), 1e-30)``. ``q_len`` None is the kernel's single-token
    mode: ``w = 1``, ``ctx = max(ctx_len - 1, 0)``, ``q_len = (ctx_len >
    0)``. ``quant``: None for f32 pools, else (k_scale, v_scale, lut) with
    code pools. Returns (B, Hkv, R, dh) f32."""
    if q_len is None:
        w = 1
        q_len = (ctx_len > 0).to(torch.int32)
        ctx_len = torch.clamp(ctx_len - 1, min=0)
    if quant is None:
        k, v = _gather(k_pages, block_table), _gather(v_pages, block_table)
    else:
        k_scale, v_scale, lut = quant
        k = _gather_dequant(k_pages, k_scale, block_table, lut)
        v = _gather_dequant(v_pages, v_scale, block_table, lut)
    r_rows, dh = q.shape[2], q.shape[3]
    s = torch.einsum("bhrd,bhkd->bhrk", q.to(torch.float32),
                     k.to(torch.float32)) * (dh ** -0.5)
    win = torch.arange(r_rows, device=q.device) % w
    pos = torch.arange(k.shape[2], device=q.device)
    ctx = ctx_len.to(q.device).long()
    row_ok = win[None, None, :, None] < q_len.to(q.device).long()[
        :, None, None, None]
    mask = (pos[None, None, None, :]
            <= ctx[:, None, None, None] + win[None, None, :, None]) & row_ok
    s = torch.where(mask, s, torch.full_like(s, _NEG))
    max_tokens = block_table.shape[1] * k_pages.shape[2]
    span = split_tokens(max_tokens, splits)
    parts = []
    for t0 in range(0, max_tokens, span):
        s_z, mask_z = s[..., t0:t0 + span], mask[..., t0:t0 + span]
        m_z = s_z.amax(dim=-1, keepdim=True)
        p = torch.where(mask_z, torch.exp(s_z - m_z), torch.zeros_like(s_z))
        parts.append((m_z, p.sum(dim=-1, keepdim=True),
                      torch.einsum("bhrk,bhkd->bhrd", p,
                                   v[:, :, t0:t0 + span].to(torch.float32))))
    m_all = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    l_sum = torch.zeros_like(m_all)
    acc = torch.zeros_like(q, dtype=torch.float32)
    for m_z, l_z, a_z in parts:
        c = torch.exp(m_z - m_all)
        l_sum = l_sum + l_z * c
        acc = acc + a_z * c
    return acc / torch.clamp(l_sum, min=1e-30)


def flash_attention_ref(q, k, v, *, causal: bool, q_chunk: int):
    """The flash kernel's function in plain PyTorch: the reference's
    chunked attention (``repro.nn.attention._chunked_attention``), which
    is ``repro.kernels.ref.attention_ref`` computed ``q_chunk`` query rows
    at a time (one chunk when Sq is not a multiple). q: (B, Hq, Sq, dh); k/v:
    (B, Hkv, Skv, dh), GQA repeated here. Returns (B, Hq, Sq, dh)."""
    b, hq, sq, dh = q.shape
    rep = hq // k.shape[1]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    cq = min(q_chunk, sq)
    if sq % cq:
        cq = sq
    kv_pos = torch.arange(k.shape[2], device=q.device)
    outs = []
    for i in range(sq // cq):
        q_i = q[:, :, i * cq:(i + 1) * cq].to(torch.float32)
        s = torch.einsum("bhqd,bhkd->bhqk", q_i,
                         k.to(torch.float32)) * (dh ** -0.5)
        if causal:
            q_pos = i * cq + torch.arange(cq, device=q.device)
            s = torch.where(q_pos[:, None] >= kv_pos[None, :], s,
                            torch.full_like(s, _NEG))
        p = torch.softmax(s, dim=-1)
        outs.append(torch.einsum("bhqk,bhkd->bhqd", p,
                                 v.to(torch.float32)).to(q.dtype))
    return torch.cat(outs, dim=2)
