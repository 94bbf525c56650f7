"""GQA attention: the dense forward (training-mode apply and whole-prompt
prefill, through ``ops.flash_attention``), the one-token decode against a
dense per-slot cache, and the paged KV cache of serving (chunked prefill
and the fused decode tick). K/V caches and page pools hold f32 values, or
SPx codebook codes (uint8) with one f32 scale per token when quantized
(``Runtime.kv_quant``; ``Runtime.kv_scheme`` picks the level set). The
dense forward and the one-token decode also take ``cross_kv``: the
encoder-decoder's cross-attention over precomputed, unroped encoder K/V,
non-causal. ``attn_paged_step_sharded`` and ``attn_apply_dense_sharded``
are the tensor-parallel paged sublayer and encoder sublayer of a sharded
serving engine (``Runtime.mesh``): each shard attends its own heads.
Context-parallel attention and the mesh hints of ``repro.nn.attention``
are not in this port.

Caches and page pools are updated **in place** (indexed assignment) where
the reference rebuilds them functionally; the functions still return them
so callers read like the reference.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core import spx
from repro_torch.kernels import ops
from repro_torch.runtime import Runtime

from .layers import dense_apply, dense_init, shard_sum
from .rotary import apply_mrope, apply_rope

__all__ = ["attn_init", "attn_apply_dense", "attention_core",
           "decode_attention", "attn_decode_step", "paged_kv_write",
           "attn_paged_step", "attn_paged_step_sharded",
           "attn_apply_dense_sharded", "quantize_kv",
           "dequantize_kv", "kv_lut"]

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


def _rotate(t, positions, rope_theta, mrope_sections):
    """RoPE over (B, S) positions, or M-RoPE over (B, 3, S) streams."""
    if mrope_sections is not None:
        return apply_mrope(t, positions, sections=mrope_sections,
                           theta=rope_theta)
    return apply_rope(t, positions, theta=rope_theta)


def _apply_positional(q, k, positions, rope_theta, mrope_sections):
    return (_rotate(q, positions, rope_theta, mrope_sections),
            _rotate(k, positions, rope_theta, mrope_sections))


def _text_positions(positions, mrope_sections):
    """(B, S) token positions, or for M-RoPE the three streams of a text
    token, each the token index: (B, 3, S)."""
    if mrope_sections is None:
        return positions
    b, s = positions.shape
    return positions[:, None, :].expand(b, 3, s)


# -- dense forward (train / prefill) ------------------------------------------

def attention_core(q, k, v, *, causal: bool, rt: Runtime):
    """q: (B, Hq, Sq, dh); k, v: (B, Hkv, Skv, dh) -> (B, Hq, Sq, dh),
    through the flash kernel on the card (its plain version, the chunked
    attention of ``rt.q_chunk`` query rows, on the CPU)."""
    return ops.flash_attention(q, k, v, causal=causal, q_chunk=rt.q_chunk,
                               impl=rt.impl)


def _cross_attention(q, cross_kv, rt: Runtime):
    """Non-causal attention of q (B, Sq, Hq, dh) over the encoder K/V
    ``cross_kv`` (each (B, S_enc, Hkv, dh), in any cache dtype). Returns
    (B, Hq, Sq, dh)."""
    k, v = (t.transpose(1, 2).to(q.dtype) for t in cross_kv)
    return attention_core(q.transpose(1, 2), k, v, causal=False, rt=rt)


def attn_apply_dense(p: dict, x: torch.Tensor, positions, *, n_heads: int,
                     n_kv_heads: int, head_dim: int, causal: bool = True,
                     rope_theta: float = 10000.0, mrope_sections=None,
                     rt: Runtime, kv_out: bool = False, cross_kv=None):
    """Full attention sublayer (projections, rope, core, output
    projection). Returns y, or (y, (k, v)) with k/v (B, S, Hkv, dh) roped
    when ``kv_out``. ``cross_kv``: (k, v) each (B, S_enc, Hkv, dh), the
    enc-dec decoder's cross-attention: q alone is projected and roped
    (M-RoPE leaves it unroped, as the reference does), K/V are taken as
    given and the attention is not causal."""
    b, s, _ = x.shape
    if cross_kv is not None:
        q = dense_apply(p["wq"], x, rt).reshape(b, s, n_heads, head_dim)
        if mrope_sections is None:
            q = apply_rope(q, positions, theta=rope_theta)
        o = _cross_attention(q, cross_kv, rt)
        return dense_apply(p["wo"], o.transpose(1, 2).reshape(
            b, s, n_heads * head_dim), rt)
    q, k, v = _project_qkv(p, x, n_heads, n_kv_heads, head_dim, rt)
    if positions is not None:
        q, k = _apply_positional(q, k, positions, rope_theta, mrope_sections)
    o = attention_core(q.transpose(1, 2), k.transpose(1, 2),
                       v.transpose(1, 2), causal=causal, rt=rt)
    y = dense_apply(p["wo"], o.transpose(1, 2).reshape(b, s,
                                                       n_heads * head_dim),
                    rt)
    if kv_out:
        return y, (k, v)
    return y


def attn_apply_dense_sharded(ps: list, x: torch.Tensor, positions, *,
                             n_heads: int, n_kv_heads: int, head_dim: int,
                             rt: Runtime, **kw) -> torch.Tensor:
    """``attn_apply_dense`` split over the shards of ``rt.mesh`` by heads
    (the tensor-parallel encoder of an enc-dec model): shard s projects
    and attends its own heads through the same kernel route as one device
    does, and the partial products of its ``wo`` rows are summed in shard
    order (``shard_sum``). ``n_heads``, ``n_kv_heads``: the model's
    (unsharded) counts; a shard's KV heads are those its ``wk`` holds."""
    n = len(ps)
    return shard_sum([
        attn_apply_dense(p, x.to(dev), positions.to(dev),
                         n_heads=n_heads // n,
                         n_kv_heads=p["wk"]["w"].shape[-1] // head_dim,
                         head_dim=head_dim, rt=rt, **kw)
        for p, dev in zip(ps, rt.mesh.devices)])


# -- SPx KV quantization ------------------------------------------------------

def kv_lut(scheme: str, device="cpu") -> torch.Tensor:
    """f32 codebook LUT of a KV-cache scheme (pow2-padded; codes index it),
    on ``device``. Only 8-bit-code schemes are legal for the KV cache: it
    stores one uint8 code per element."""
    return _kv_lut(scheme, str(torch.device(device)))


@functools.lru_cache(maxsize=None)
def _kv_lut(scheme: str, device: str) -> torch.Tensor:
    levels = spx.scheme_levels(scheme)
    if spx.code_width(levels) > 8:
        raise ValueError(f"KV scheme {scheme!r} needs >8-bit codes")
    return spx.codebook(levels, device=device)


def quantize_kv(x: torch.Tensor, scheme: str = "uniform8", axis: int = -1):
    """Per-position quantization of K/V over a ``core/spx`` codebook:
    ``uniform8`` is the symmetric-int8 baseline (255 uniform levels, not
    SPx); ``sp2_8`` / ``spx_8_x3`` are the paper's non-uniform level sets
    at the same 1-byte code width. x: (..., dh) -> (codes uint8, scale f32
    (..., 1))."""
    scale = torch.amax(torch.abs(x.to(torch.float32)), dim=axis,
                       keepdim=True)
    scale = torch.clamp(scale, min=1e-8)
    return spx.quantize_to_codes(x, spx.scheme_levels(scheme), scale), scale


def dequantize_kv(codes, scale, scheme: str = "uniform8",
                  dtype=torch.float32) -> torch.Tensor:
    """codes (uint8) + per-position scale -> values: lut[codes] * scale."""
    return spx.dequantize_codes(codes, kv_lut(scheme, codes.device), scale,
                                dtype=dtype)


# -- decode against the dense per-slot cache ----------------------------------

def _local_flash_decode(q, k_cache, v_cache, k_new, v_new, pos, *,
                        kv_scheme: str = "uniform8"):
    """One-token decode against one device's whole cache (the reference's
    ``_local_flash_decode`` with ``axis=None``). Plain tensor code, as in
    the reference. q: (B, Hq, dh); caches: (B, Hkv, S, dh) tensors, or
    {"codes" uint8 (B, Hkv, S, dh), "scale" f32 (B, Hkv, S, 1)} dicts for
    the quantized cache; k_new/v_new: (B, Hkv, dh); pos: (B,) write and
    attend position per row. Writes the new token in place and returns
    (out (B, Hq, dh), k_cache, v_cache)."""
    quantized = isinstance(k_cache, dict)
    b, hq, dh = q.shape
    hkv, s_loc = (k_cache["codes"] if quantized else k_cache).shape[1:3]
    rep = hq // hkv
    in_range = (pos >= 0) & (pos < s_loc)
    idx = torch.clamp(pos, 0, s_loc - 1).long()
    rows = torch.arange(b, device=q.device)

    def upd(cache, new):
        # single-slot write per row; out-of-range rows keep the old slot
        old = cache[rows, :, idx, :]
        cache[rows, :, idx, :] = torch.where(in_range[:, None, None],
                                             new.to(cache.dtype), old)

    if quantized:
        lut = kv_lut(kv_scheme, q.device)
        kc_new, ks_new = quantize_kv(k_new, kv_scheme)
        vc_new, vs_new = quantize_kv(v_new, kv_scheme)
        upd(k_cache["codes"], kc_new)
        upd(k_cache["scale"], ks_new)
        upd(v_cache["codes"], vc_new)
        upd(v_cache["scale"], vs_new)
        # q . (lut[codes] * scale) == (q . lut[codes]) * scale: the scale
        # folds out of the dh sum, as in the reference
        kd = lut[k_cache["codes"].repeat_interleave(rep, dim=1).long()]
        ksc = k_cache["scale"].repeat_interleave(rep, dim=1)
        s = torch.einsum("bhd,bhkd->bhk", q.to(torch.float32), kd)
        s = s * ksc[..., 0] * (dh ** -0.5)
    else:
        upd(k_cache, k_new)
        upd(v_cache, v_new)
        kr = k_cache.repeat_interleave(rep, dim=1)
        s = torch.einsum("bhd,bhkd->bhk", q.to(torch.float32),
                         kr.to(torch.float32)) * (dh ** -0.5)

    gpos = torch.arange(s_loc, device=q.device)
    s = torch.where(gpos[None, None, :] <= pos[:, None, None], s,
                    torch.full_like(s, _NEG))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    if quantized:
        vd = lut[v_cache["codes"].repeat_interleave(rep, dim=1).long()]
        vsc = v_cache["scale"].repeat_interleave(rep, dim=1)
        o = torch.einsum("bhk,bhkd->bhd", p * vsc[..., 0], vd)
    else:
        vr = v_cache.repeat_interleave(rep, dim=1)
        o = torch.einsum("bhk,bhkd->bhd", p, vr.to(torch.float32))
    out = o / torch.clamp(l, min=1e-30)
    return out.to(q.dtype), k_cache, v_cache


def decode_attention(q, k_cache, v_cache, k_new, v_new, pos, *, rt: Runtime):
    """One-token attention against the dense cache, updating it in place.
    q: (B, Hq, dh); caches (B, Hkv, S, dh) or quantized dicts; k_new/v_new:
    (B, Hkv, dh); pos: scalar or (B,) per-row position. Returns (out,
    k_cache, v_cache)."""
    pos = torch.broadcast_to(torch.as_tensor(pos, device=q.device),
                             (q.shape[0],)).long()
    return _local_flash_decode(q, k_cache, v_cache, k_new, v_new, pos,
                               kv_scheme=rt.kv_scheme)


def attn_decode_step(p: dict, x: torch.Tensor, pos, kv_cache: tuple, *,
                     n_heads: int, n_kv_heads: int, head_dim: int,
                     rope_theta: float = 10000.0, mrope_sections=None,
                     rt: Runtime, cross_kv=None):
    """One-token attention sublayer. x: (B, 1, D); kv_cache: (k, v) each
    (B, Hkv, S, dh) or quantized dicts. Returns (y (B, 1, D), cache).
    ``cross_kv``: (k, v) each (B, S_enc, Hkv, dh), static encoder K/V for
    cross-attention: q is roped at ``pos``, nothing is cached, and
    ``kv_cache`` comes back untouched."""
    b = x.shape[0]
    pos_b = torch.broadcast_to(torch.as_tensor(pos, device=x.device),
                               (b,)).long()
    if cross_kv is not None:
        q = dense_apply(p["wq"], x, rt).reshape(b, 1, n_heads, head_dim)
        q = _rotate(q, _text_positions(pos_b[:, None], mrope_sections),
                    rope_theta, mrope_sections)
        o = _cross_attention(q, cross_kv, rt)
        y = o.transpose(1, 2).reshape(b, 1, n_heads * head_dim)
        return dense_apply(p["wo"], y, rt), kv_cache
    q, k, v = _project_qkv(p, x, n_heads, n_kv_heads, head_dim, rt)
    q, k = _apply_positional(q, k,
                             _text_positions(pos_b[:, None], mrope_sections),
                             rope_theta, mrope_sections)
    k_cache, v_cache = kv_cache
    out, k_cache, v_cache = decode_attention(
        q[:, 0], k_cache, v_cache, k[:, 0], v[:, 0], pos_b, rt=rt)
    y = dense_apply(p["wo"], out.reshape(b, 1, n_heads * head_dim), rt)
    return y, (k_cache, v_cache)


# -- paged KV cache: chunked prefill and the fused decode tick ----------------

def paged_kv_write(k_pages, v_pages, k_new, v_new, block_table, positions,
                   valid, kv_scheme: str = "uniform8"):
    """Scatter a chunk of new K/V rows into the physical page pools, in
    place. k_pages/v_pages: (n_pages, Hkv, page_size, dh) tensors, or
    {"codes" uint8 (n_pages, Hkv, page_size, dh), "scale" f32 (n_pages,
    Hkv, page_size, 1)} dicts for the quantized pool (codes under
    ``kv_scheme``); k_new/v_new: (B, C, Hkv, dh); block_table:
    (B, max_pages); positions: (B, C) absolute token positions; valid:
    (B, C) bool — False rows (chunk padding, inactive slots) are not
    written."""
    quantized = isinstance(k_pages, dict)
    ps = (k_pages["codes"] if quantized else k_pages).shape[2]
    logical = torch.clamp(positions // ps, 0, block_table.shape[1] - 1)
    phys = torch.gather(block_table.long(), 1, logical.long())
    sel = valid.reshape(-1)
    pg = phys.reshape(-1)[sel]
    off = (positions % ps).reshape(-1)[sel].long()

    def scatter(pages, new):
        flat = new.reshape(-1, *new.shape[2:])[sel]
        pages[pg, :, off, :] = flat.to(pages.dtype)

    if quantized:
        kc, ks = quantize_kv(k_new, kv_scheme)   # (B,C,Hkv,dh), (B,C,Hkv,1)
        vc, vs = quantize_kv(v_new, kv_scheme)
        scatter(k_pages["codes"], kc)
        scatter(k_pages["scale"], ks)
        scatter(v_pages["codes"], vc)
        scatter(v_pages["scale"], vs)
    else:
        scatter(k_pages, k_new)
        scatter(v_pages, v_new)
    return k_pages, v_pages


def _gather_rows(pages, block_table):
    """(n_pages, Hkv, ps, w) pool -> (B, Hkv, max_pages * ps, w): each
    row's pages in logical order."""
    b, max_pages = block_table.shape
    _, hkv, ps, width = pages.shape
    g = pages[block_table.long()]              # (B, max_pages, Hkv, ps, w)
    return g.permute(0, 2, 1, 3, 4).reshape(b, hkv, max_pages * ps, width)


def _gather_pages(pages, block_table, kv_scheme: str):
    """Each row's pages as a contiguous (B, Hkv, S, dh) tensor, S =
    max_pages * page_size. Quantized pools are dequantized after the
    gather, so only the context a chunk attends is expanded to f32."""
    if isinstance(pages, dict):
        return dequantize_kv(_gather_rows(pages["codes"], block_table),
                             _gather_rows(pages["scale"], block_table),
                             kv_scheme)
    return _gather_rows(pages, block_table)


def _paged_chunk_attention(q, k_pages, v_pages, block_table, positions,
                           attend_len, kv_scheme: str = "uniform8"):
    """Attention of a C-token chunk against the full paged context
    (including the chunk itself, already written to the pages). Plain
    tensor code, as in the reference: prefill gathers the pages.

    q: (B, Hq, C, dh); positions: (B, C) absolute query positions;
    attend_len: (B,) total attendable tokens. Returns (B, Hq, C, dh)."""
    b, hq, c, dh = q.shape
    k = _gather_pages(k_pages, block_table, kv_scheme).to(torch.float32)
    v = _gather_pages(v_pages, block_table, kv_scheme).to(torch.float32)
    rep = hq // k.shape[1]
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
    inactive row); cache: {"kp", "vp"} pools of this layer, tensors or
    quantized {"codes", "scale"} dicts (``rt.kv_scheme``). ``fused``
    routes the attention through the ragged decode kernel
    (``ops.paged_decode_ragged``, n_valid as the per-slot ``q_len``); else
    a one-token chunk goes to ``ops.paged_attention`` (or
    ``ops.paged_attention_quant``) and a wider chunk gathers the pages.
    Returns (y (B, C, D), cache)."""
    b, c, _ = x.shape
    quantized = isinstance(cache["kp"], dict)
    q, k, v = _project_qkv(p, x, n_heads, n_kv_heads, head_dim, rt)
    positions = ctx_len[:, None] + torch.arange(c, dtype=ctx_len.dtype,
                                                device=x.device)
    # rotated before the page write, so the kernels need no positions
    q, k = _apply_positional(q, k, _text_positions(positions, mrope_sections),
                             rope_theta, mrope_sections)
    valid = torch.arange(c, device=x.device)[None, :] < n_valid[:, None]
    kp, vp = paged_kv_write(cache["kp"], cache["vp"], k, v, block_table,
                            positions, valid, kv_scheme=rt.kv_scheme)
    attend_len = ctx_len + n_valid
    if fused:
        out = ops.paged_decode_ragged(
            q, kp, vp, block_table, ctx_len, n_valid,
            kv_scheme=rt.kv_scheme if quantized else None, impl=rt.impl)
        o = out.reshape(b, c, n_heads * head_dim)
    elif c == 1:
        q1 = q[:, 0].reshape(b, n_heads, head_dim)
        if quantized:
            out = ops.paged_attention_quant(q1, kp, vp, block_table,
                                            attend_len,
                                            kv_scheme=rt.kv_scheme,
                                            impl=rt.impl)
        else:
            out = ops.paged_attention(q1, kp, vp, block_table, attend_len,
                                      impl=rt.impl)
        o = out.reshape(b, 1, n_heads * head_dim)
    else:
        qh = q.transpose(1, 2)                           # (B, Hq, C, dh)
        o = _paged_chunk_attention(qh, kp, vp, block_table, positions,
                                   attend_len, kv_scheme=rt.kv_scheme)
        o = o.transpose(1, 2).reshape(b, c, n_heads * head_dim)
    y = dense_apply(p["wo"], o, rt)
    return y, dict(cache, kp=kp, vp=vp)


def attn_paged_step_sharded(ps: list, x: torch.Tensor, ctx_len: list,
                            block_table: list, caches: list, *,
                            n_heads: int, n_kv_heads: int, head_dim: int,
                            n_valid: list, rope_theta: float = 10000.0,
                            mrope_sections=None, rt: Runtime,
                            fused: bool = False):
    """``attn_paged_step`` split over the shards of ``rt.mesh`` by heads.
    Shard s holds the ``wq`` columns of its query heads, the ``wk``/``wv``
    columns of its KV heads (all of them where they replicate) and the
    ``wo`` rows of its query heads (``sharding.shard_params``): it
    projects, writes its own pool and attends its heads through the same
    kernel routes as one device does, and its ``wo`` product is a partial
    sum. The partials are summed in shard order on the first shard's
    device (``shard_sum``).

    ps, caches: per shard, this layer's params and {"kp", "vp"} pools;
    ctx_len, block_table, n_valid: per shard, on its device; n_heads,
    n_kv_heads: the model's (unsharded) counts; x: the normed input
    (B, C, D). Writes the pools in place and returns (y (B, C, D) on the
    first shard's device, caches)."""
    parts = []
    for p, ctx, bt, nv, cache, dev in zip(ps, ctx_len, block_table, n_valid,
                                          caches, rt.mesh.devices):
        y, _ = attn_paged_step(
            p, x.to(dev), ctx, bt, cache, n_heads=n_heads // len(ps),
            n_kv_heads=p["wk"]["w"].shape[-1] // head_dim,
            head_dim=head_dim, n_valid=nv, rope_theta=rope_theta,
            mrope_sections=mrope_sections, rt=rt, fused=fused)
        parts.append(y)
    return shard_sum(parts), caches
