"""Plain PyTorch versions of the ported kernels: the CPU path, and what
each CUDA kernel is held against on the card. Same semantics as
``repro.kernels.ref`` (and, for ``flash_attention_ref``, as the chunked
attention of ``repro.nn.attention``)."""
from __future__ import annotations

import torch
import torch.utils.checkpoint

from repro_torch.core import spx

from .paged_attention import CHUNK, MMA_WARPS, active_ranks, split_tokens

__all__ = ["spx_matmul_ref", "paged_attention_ref", "paged_decode_ragged_ref",
           "paged_attention_quant_ref", "paged_decode_ragged_quant_ref",
           "paged_decode_split_ref", "paged_decode_cluster_ref",
           "flash_attention_ref"]

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


def _pv_probs(p, v):
    """The probabilities P @ V multiplies V by: f32, or over f16 pages
    each rounded to f16 (nearest even, subnormals kept: ``Tensor.to``),
    as the TPU kernel's ``pv.astype(v.dtype)`` and the CUDA kernel's
    ``F16Mma`` round them. The sum of the f32 probabilities stays the
    denominator. bf16 pages keep the reference oracle's f32
    probabilities."""
    if v.dtype == torch.float16:
        return p.to(torch.float16).to(torch.float32)
    return p


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
    o = torch.einsum("bhrk,bhkd->bhrd", _pv_probs(p, v),
                     v.to(torch.float32)) / torch.clamp(l, min=1e-30)
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
    o = torch.einsum("bhrk,bhkd->bhrd", _pv_probs(p, v),
                     v.to(torch.float32)) / torch.clamp(l, min=1e-30)
    o = torch.where(row_ok, o, torch.zeros_like(o))
    return o.to(out_dtype)


def paged_attention_ref(q, k_pages, v_pages, block_table, ctx_len, *,
                        out_dtype=None):
    """Single-token decode attention over a paged KV cache.

    q: (B, Hkv, rep, dh); k_pages/v_pages: (n_pages, Hkv, page_size, dh)
    f32, bf16 or f16 (upcast to f32 after the gather, with the
    probabilities kept in f32, as the reference oracle does, except that
    over f16 pages they are rounded to f16 before P @ V: ``_pv_probs``);
    block_table: (B, max_pages) int32; ctx_len: (B,) int32 — positions <
    ctx_len are attended; ctx_len == 0 gives zeros. Returns (B, Hkv, rep, dh)."""
    return _paged_softmax(q, _gather(k_pages, block_table),
                          _gather(v_pages, block_table), ctx_len,
                          out_dtype or q.dtype)


def paged_decode_ragged_ref(q, k_pages, v_pages, block_table, ctx_len,
                            q_len, *, w: int, out_dtype=None):
    """Ragged decode-window attention over a paged KV cache.

    q: (B, Hkv, R, dh), R = rep * w rows, rep-major; pools f32, bf16 or
    f16, upcast as in ``paged_attention_ref``. Window position i attends
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
    _, l_sum, acc = _online_merge(parts)
    return acc / torch.clamp(l_sum, min=1e-30)


def _online_merge(parts):
    """(m, l, acc) partials merged in their order: ``M = max(m)``, ``c =
    exp(m - M)``, ``(M, sum(c * l), sum(c * acc))``."""
    m_all = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    l_sum, acc = torch.zeros_like(m_all), torch.zeros_like(parts[0][2])
    for m_z, l_z, a_z in parts:
        c = torch.exp(m_z - m_all)
        l_sum = l_sum + l_z * c
        acc = acc + a_z * c
    return m_all, l_sum, acc


def paged_decode_cluster_ref(q, k_pages, v_pages, block_table, ctx_len,
                             q_len=None, *, w: int = 1, cluster: int,
                             round_p: bool = True):
    """The 16-bit CUDA kernel's (``paged_decode_mma_kernel``) work split in
    plain PyTorch: ``paged_decode_ragged_ref`` over bf16 or f16 pools,
    computed per 16-token chunk and merged as the kernel merges, so the
    formula can be held against the reference on the CPU.

    A slot of ``n`` live chunks (positions ``< min(ctx + q_len, table)``)
    keeps ``A = active_ranks(n, cluster)`` ranks busy; chunk c (positions
    ``[16 c, 16 c + 16)``) goes to warp ``c mod 4`` of rank ``(c // 4) mod
    A``. Each warp runs the online softmax over its chunks in order: ``m``
    the running max (-1e30 where every position so far is masked), ``l =
    l * exp(m_old - m) + sum(p)`` over the f32 probabilities, ``acc = acc
    * exp(m_old - m) + p' @ V`` where ``p'`` is ``p`` rounded to the pool's
    dtype (``round_p``; f32 with ``round_p`` False). Then each rank merges
    its 4 warps in warp order, the slot merges its ranks in rank order
    (``_online_merge``), and the output is ``acc / max(l, 1e-30)``.
    ``q_len`` None is the single-token mode (as ``paged_decode_split_ref``).
    Returns (B, Hkv, R, dh) f32."""
    if q_len is None:
        w = 1
        q_len = (ctx_len > 0).to(torch.int32)
        ctx_len = torch.clamp(ctx_len - 1, min=0)
    k, v = _gather(k_pages, block_table), _gather(v_pages, block_table)
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
    vf = v.to(torch.float32)
    outs = []
    for b in range(q.shape[0]):
        attend = min(int(ctx[b] + qn[b]), k.shape[2])
        n_chunks = -(-attend // CHUNK)
        a = active_ranks(n_chunks, cluster)
        warps = {}
        for c in range(n_chunks):
            warps.setdefault(((c // MMA_WARPS) % a, c % MMA_WARPS),
                             []).append(c)
        ranks = []
        for rank in range(a):
            parts = []
            for warp in range(MMA_WARPS):
                m = torch.full(s.shape[1:3] + (1,), _NEG, dtype=torch.float32,
                               device=q.device)
                l = torch.zeros_like(m)
                acc = torch.zeros(q.shape[1:], dtype=torch.float32,
                                  device=q.device)
                for c in warps.get((rank, warp), []):
                    span = slice(c * CHUNK, (c + 1) * CHUNK)
                    s_c, mask_c = s[b, ..., span], mask[b, ..., span]
                    m_new = torch.maximum(m, s_c.amax(dim=-1, keepdim=True))
                    corr = torch.exp(m - m_new)
                    p = torch.where(mask_c, torch.exp(s_c - m_new),
                                    torch.zeros_like(s_c))
                    l = l * corr + p.sum(dim=-1, keepdim=True)
                    pv = p.to(v.dtype).to(torch.float32) if round_p else p
                    acc = acc * corr + torch.einsum("hrk,hkd->hrd", pv,
                                                    vf[b, :, span])
                    m = m_new
                parts.append((m, l, acc))
            ranks.append(_online_merge(parts))
        _, l, acc = _online_merge(ranks)
        outs.append(acc / torch.clamp(l, min=1e-30))
    return torch.stack(outs)


def flash_attention_ref(q, k, v, *, causal: bool, q_chunk: int,
                        q_offset: int = 0, remat: bool = False):
    """The flash kernel's function in plain PyTorch: the reference's
    chunked attention (``repro.nn.attention._chunked_attention``), which
    is ``repro.kernels.ref.attention_ref`` computed ``q_chunk`` query rows
    at a time (one chunk when Sq is not a multiple). q: (B, Hq, Sq, dh); k/v:
    (B, Hkv, Skv, dh), GQA repeated here; query row i sits at position
    ``q_offset + i`` under the causal mask. Returns (B, Hq, Sq, dh).
    ``remat`` (training): each chunk checkpointed as the reference's
    ``jax.checkpoint`` chunk, its scores and probabilities recomputed in
    the backward and its output product kept (``_keep_output_product``),
    never the (B, Hq, cq, Skv) probabilities of every chunk at once."""
    b, hq, sq, dh = q.shape
    rep = hq // k.shape[1]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    cq = min(q_chunk, sq)
    if sq % cq:
        cq = sq
    kv_pos = torch.arange(k.shape[2], device=q.device)

    def chunk(q_i, k, v, i):
        s = torch.einsum("bhqd,bhkd->bhqk", q_i.to(torch.float32),
                         k.to(torch.float32)) * (dh ** -0.5)
        if causal:
            q_pos = q_offset + i * cq + torch.arange(cq, device=q.device)
            s = torch.where(q_pos[:, None] >= kv_pos[None, :], s,
                            torch.full_like(s, _NEG))
        p = torch.softmax(s, dim=-1)
        return torch.einsum("bhqk,bhkd->bhqd", p,
                            v.to(torch.float32)).to(q.dtype)

    outs = []
    for i in range(sq // cq):
        args = (q[:, :, i * cq:(i + 1) * cq], k, v, i)
        if remat:
            outs.append(torch.utils.checkpoint.checkpoint(
                chunk, *args, use_reentrant=False,
                context_fn=_keep_output_product))
        else:
            outs.append(chunk(*args))
    return torch.cat(outs, dim=2)


def _keep_output_product():
    """The selective checkpoint of one attention chunk: the second product
    (probabilities by V) saved, the rest recomputed in the backward (JAX
    drops that product's recompute: nothing reads it)."""
    from torch.utils.checkpoint import (CheckpointPolicy,
                                        create_selective_checkpoint_contexts)
    seen = {False: 0, True: 0}

    def policy(ctx, op, *args, **kwargs):
        if op in (torch.ops.aten.bmm.default, torch.ops.aten.mm.default):
            seen[ctx.is_recompute] += 1
            if seen[ctx.is_recompute] % 2 == 0:
                return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE
    return create_selective_checkpoint_contexts(policy)
