"""GQA attention: the dense forward (training-mode apply and whole-prompt
prefill, through ``ops.flash_attention``), the one-token decode against a
dense per-slot cache, and the paged KV cache of serving (chunked prefill
and the fused decode tick). K/V caches and page pools hold f32 values, or
SPx codebook codes (uint8) with one f32 scale per token when quantized
(``Runtime.kv_quant``; ``Runtime.kv_scheme`` picks the level set). The
dense forward and the one-token decode also take ``cross_kv``: the
encoder-decoder's cross-attention over precomputed, unroped encoder K/V,
non-causal. ``attn_paged_step_sharded`` and ``attn_apply_dense_sharded``
are the tensor-parallel paged sublayer and dense sublayer of a sharded
serving engine or serve step (``Runtime.mesh``): each shard attends its
own head group (``head_segments``; uneven where the heads do not divide,
through a view of a replicated pool where its queries read some of its
KV heads). The serve steps of ``launch.steps`` add the reference's mesh
paths: the decode over a sequence-sharded cache, partials merged in
shard order (``decode_attention_sharded``, ``attn_decode_step_sharded``),
and the context-parallel prefill (``attn_apply_dense_cp``: the flash
kernel with a causal ``q_offset``). GSPMD's sharding hints have no
counterpart: one process runs every shard.

Caches and page pools are updated **in place** (indexed assignment) where
the reference rebuilds them functionally; the functions still return them
so callers read like the reference.
"""
from __future__ import annotations

import functools

import torch

from repro_torch import collectives
from repro_torch.core import spx
from repro_torch.kernels import ops
from repro_torch.runtime import Runtime, planner

from .layers import dense_apply, dense_init, shard_sum
from .rotary import apply_mrope, apply_rope

__all__ = ["attn_init", "attn_apply_dense", "attention_core",
           "decode_attention", "attn_decode_step", "paged_kv_write",
           "attn_paged_step", "attn_paged_step_sharded",
           "attn_apply_dense_sharded", "attn_apply_dense_cp",
           "attn_decode_step_sharded", "decode_attention_sharded",
           "head_segments", "own_cols", "gather_kv", "pool_view",
           "table_view",
           "quantize_kv", "dequantize_kv", "kv_lut"]

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

def attention_core(q, k, v, *, causal: bool, rt: Runtime, q_offset: int = 0,
                   segments=None):
    """q: (B, Hq, Sq, dh); k, v: (B, Hkv, Skv, dh) -> (B, Hq, Sq, dh),
    through the flash kernel on the card (its plain version, the chunked
    attention of ``rt.q_chunk`` query rows, on the CPU). ``q_offset``: the
    absolute position of query row 0 under the causal mask (a
    context-parallel shard's rows). ``segments``: a tensor-parallel
    shard's pieces (``head_segments``), attended one by one and put side
    by side in head order."""
    if segments is not None:
        return torch.cat([attention_core(q[:, qa:qa + qn], k[:, ka:ka + g],
                                         v[:, ka:ka + g], causal=causal,
                                         rt=rt, q_offset=q_offset)
                          for qa, qn, ka, g in segments], dim=1)
    return ops.flash_attention(q, k, v, causal=causal, q_chunk=rt.q_chunk,
                               impl=rt.impl, q_offset=q_offset)


def head_segments(n_heads: int, n_kv_heads: int, shards: int, s: int):
    """How shard ``s`` of a tensor-parallel forward attends: ``(qa, qn, ka,
    g)`` pieces, each its query heads ``[qa, qa + qn)`` (counted within the
    shard's) over the KV heads ``[ka, ka + g)`` of the K/V it holds (its
    cut where the KV heads split, else all of them), ``qn / g`` query
    heads to a KV head. One piece where the shard's query heads fill
    whole KV heads (or read one) and, for K/V held whole, ``g`` divides
    the KV heads at ``ka`` (so a page pool's heads [ka, ka + g) are a
    view, ``pool_view``); else one piece per KV head."""
    grp = planner.shard_heads(n_heads, n_kv_heads, shards)[s]
    rep = n_heads // n_kv_heads
    split = planner.kv_heads_split(n_kv_heads, shards)
    n_pool = grp.nkv if split else n_kv_heads
    ka = 0 if split else grp.kv0
    whole = grp.nkv == 1 or (grp.q0 % rep == 0 and grp.nq == grp.nkv * rep)
    if whole and n_pool % grp.nkv == 0 and ka % grp.nkv == 0:
        return ((0, grp.nq, ka, grp.nkv),)
    out = []
    for h in range(grp.kv0, grp.kv0 + grp.nkv):
        a, b = max(grp.q0, h * rep), min(grp.q0 + grp.nq, (h + 1) * rep)
        out.append((a - grp.q0, b - a, h - (grp.kv0 - ka), 1))
    return tuple(out)


def _cross_attention(q, cross_kv, rt: Runtime, segments=None):
    """Non-causal attention of q (B, Sq, Hq, dh) over the encoder K/V
    ``cross_kv`` (each (B, S_enc, Hkv, dh), in any cache dtype). Returns
    (B, Hq, Sq, dh)."""
    k, v = (t.transpose(1, 2).to(q.dtype) for t in cross_kv)
    return attention_core(q.transpose(1, 2), k, v, causal=False, rt=rt,
                          segments=segments)


def attn_apply_dense(p: dict, x: torch.Tensor, positions, *, n_heads: int,
                     n_kv_heads: int, head_dim: int, causal: bool = True,
                     rope_theta: float = 10000.0, mrope_sections=None,
                     rt: Runtime, kv_out: bool = False, cross_kv=None,
                     segments=None, out_cols=None):
    """Full attention sublayer (projections, rope, core, output
    projection). Returns y, or (y, (k, v)) with k/v (B, S, Hkv, dh) roped
    when ``kv_out``. ``cross_kv``: (k, v) each (B, S_enc, Hkv, dh), the
    enc-dec decoder's cross-attention: q alone is projected and roped
    (M-RoPE leaves it unroped, as the reference does), K/V are taken as
    given and the attention is not causal. ``segments``: a tensor-parallel
    shard's pieces (``head_segments``); ``out_cols``: the (start, size) of
    the attention output's columns its ``wo`` rows take (``own_cols``),
    every column when None."""
    b, s, _ = x.shape
    if cross_kv is not None:
        q = dense_apply(p["wq"], x, rt).reshape(b, s, n_heads, head_dim)
        if mrope_sections is None:
            q = apply_rope(q, positions, theta=rope_theta)
        o = _cross_attention(q, cross_kv, rt, segments)
        return dense_apply(p["wo"], _take_cols(o.transpose(1, 2).reshape(
            b, s, n_heads * head_dim), out_cols), rt)
    q, k, v = _project_qkv(p, x, n_heads, n_kv_heads, head_dim, rt)
    if positions is not None:
        q, k = _apply_positional(q, k, positions, rope_theta, mrope_sections)
    o = attention_core(q.transpose(1, 2), k.transpose(1, 2),
                       v.transpose(1, 2), causal=causal, rt=rt,
                       segments=segments)
    y = dense_apply(p["wo"], _take_cols(
        o.transpose(1, 2).reshape(b, s, n_heads * head_dim), out_cols), rt)
    if kv_out:
        return y, (k, v)
    return y


def _take_cols(o, cols):
    """``o``'s last-dim columns ``cols`` = (start, size), all when None."""
    return o if cols is None else o[..., cols[0]:cols[0] + cols[1]]


def own_cols(n_heads: int, n_kv_heads: int, shards: int, s: int,
             head_dim: int):
    """The (start, size) of shard ``s``'s attention output (its query
    heads' ``nq * head_dim`` columns) that its ``wo`` rows take: None (all
    of them) unless the shard shares its head with others
    (``planner.HeadGroup.out_rows``)."""
    grp = planner.shard_heads(n_heads, n_kv_heads, shards)[s]
    if grp.parts == 1:
        return None
    lo, size = grp.out_rows(head_dim)
    return lo - grp.q0 * head_dim, size


def gather_kv(parts: list, n_kv_heads: int, mesh):
    """All KV heads of a tensor-parallel projection on the first shard's
    device of ``mesh``: the shards' head cuts (..., Hkv_s, dh) side by
    side in shard order (an all-gather over its shards), or the first
    shard's where every shard computed them whole."""
    if parts[0].shape[-2] == n_kv_heads:
        return parts[0]
    return collectives.all_gather(parts, -2, mesh.devices[0], mesh.ids)


def attn_apply_dense_sharded(ps: list, x: torch.Tensor, positions, *,
                             n_heads: int, n_kv_heads: int, head_dim: int,
                             rt: Runtime, kv_out: bool = False,
                             cross_kv=None, **kw):
    """``attn_apply_dense`` split over the shards of ``rt.mesh`` by heads
    (the tensor-parallel encoder of an enc-dec model and the serve steps'
    prefill): shard s projects and attends its head group
    (``planner.shard_heads``, ``head_segments``) through the same kernel
    route as one device does, and the partial products of its ``wo`` rows
    are summed in shard order (``shard_sum``). ``n_heads``, ``n_kv_heads``:
    the model's (unsharded) counts. ``cross_kv``: one (k, v) per shard, of
    the KV heads its ``wk`` holds. ``kv_out``: also every KV head's roped
    (k, v), each (B, S, Hkv, dh), on the first shard's device
    (``gather_kv``)."""
    n = len(ps)
    parts, ks, vs = [], [], []
    for s, (p, dev) in enumerate(zip(ps, rt.mesh.devices)):
        out = attn_apply_dense(
            p, x.to(dev), None if positions is None else positions.to(dev),
            n_heads=planner.shard_heads(n_heads, n_kv_heads, n)[s].nq,
            n_kv_heads=p["wk"]["w"].shape[-1] // head_dim,
            head_dim=head_dim, rt=rt, kv_out=kv_out,
            cross_kv=None if cross_kv is None else cross_kv[s],
            segments=head_segments(n_heads, n_kv_heads, n, s),
            out_cols=own_cols(n_heads, n_kv_heads, n, s, head_dim), **kw)
        if kv_out:
            out, (k, v) = out
            ks.append(k)
            vs.append(v)
        parts.append(out)
    y = shard_sum(parts, rt.mesh)
    if kv_out:
        return y, (gather_kv(ks, n_kv_heads, rt.mesh),
                   gather_kv(vs, n_kv_heads, rt.mesh))
    return y


def attn_apply_dense_cp(ps: list, xs: list, positions: list, *,
                        n_heads: int, n_kv_heads: int, head_dim: int,
                        rt: Runtime, rope_theta: float = 10000.0,
                        mrope_sections=None, causal: bool = True):
    """The attention sublayer context-parallel over the shards of
    ``rt.mesh`` (the reference's ``_attention_core_cp`` under
    ``rt.attn_cp``): shard m holds the whole weights (``ps[m]``) and the
    rows [m S/n, (m + 1) S/n) of the sequence (``xs[m]`` (B, S/n, D),
    ``positions[m]``); it projects and ropes its rows, the K/V of every
    shard are joined in shard order (the gather), and its queries attend
    them with the causal offset ``m S/n`` through the flash kernel. Returns
    (each shard's y (B, S/n, D), each shard's roped (k, v), (B, S/n, Hkv,
    dh))."""
    qs, ks, vs = [], [], []
    for p, x, pos in zip(ps, xs, positions):
        q, k, v = _project_qkv(p, x, n_heads, n_kv_heads, head_dim, rt)
        q, k = _apply_positional(q, k, pos, rope_theta, mrope_sections)
        qs.append(q)
        ks.append(k)
        vs.append(v)
    ys, ids = [], rt.mesh.ids
    for m, (p, q, dev) in enumerate(zip(ps, qs, rt.mesh.devices)):
        # every shard gathers the K/V rows of all of them: one all-gather
        # of each, counted on every shard once (at shard 0's)
        members = ids if m == 0 else ()
        k = collectives.all_gather(ks, 1, dev, members).transpose(1, 2)
        v = collectives.all_gather(vs, 1, dev, members).transpose(1, 2)
        b, s_loc = q.shape[:2]
        o = attention_core(q.transpose(1, 2), k, v, causal=causal, rt=rt,
                           q_offset=m * s_loc)
        ys.append(dense_apply(p["wo"], o.transpose(1, 2).reshape(
            b, s_loc, n_heads * head_dim), rt))
    return ys, list(zip(ks, vs))


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

def _write_token(k_cache, v_cache, k_new, v_new, pos, start: int,
                 kv_scheme: str) -> None:
    """Write each row's new K/V (B, Hkv, dh) at position ``pos`` (B,) into
    a cache block (B, Hkv, S_loc, dh) holding positions [start, start +
    S_loc), in place: the reference's clamped single-slot write, where a
    row whose position lies outside the block keeps the old slot. Dict
    caches take the codes and scales of ``quantize_kv``."""
    cache0 = k_cache["codes"] if isinstance(k_cache, dict) else k_cache
    s_loc = cache0.shape[2]
    local = pos - start
    in_range = (local >= 0) & (local < s_loc)
    idx = torch.clamp(local, 0, s_loc - 1).long()
    rows = torch.arange(pos.shape[0], device=pos.device)

    def upd(cache, new):
        old = cache[rows, :, idx, :]
        cache[rows, :, idx, :] = torch.where(in_range[:, None, None],
                                             new.to(cache.dtype), old)

    if isinstance(k_cache, dict):
        for cache, new in ((k_cache, k_new), (v_cache, v_new)):
            codes, scale = quantize_kv(new, kv_scheme)
            upd(cache["codes"], codes)
            upd(cache["scale"], scale)
    else:
        upd(k_cache, k_new)
        upd(v_cache, v_new)


def _decode_stats(q, k_cache, v_cache, pos, start: int, kv_scheme: str,
                  causal: bool = True):
    """The online-softmax partials of q (B, Hq, dh) over one cache block
    (B, Hkv, S_loc, dh) of positions [start, start + S_loc), those <= pos
    (B,) attended (every one when not ``causal``): (m (B, Hq, 1), l
    (B, Hq, 1), o (B, Hq, dh)), o unnormalised. Plain tensor code, as in
    the reference."""
    quantized = isinstance(k_cache, dict)
    b, hq, dh = q.shape
    hkv, s_loc = (k_cache["codes"] if quantized else k_cache).shape[1:3]
    rep = hq // hkv
    if quantized:
        lut = kv_lut(kv_scheme, q.device)
        # q . (lut[codes] * scale) == (q . lut[codes]) * scale: the scale
        # folds out of the dh sum, as in the reference
        kd = lut[k_cache["codes"].repeat_interleave(rep, dim=1).long()]
        ksc = k_cache["scale"].repeat_interleave(rep, dim=1)
        s = torch.einsum("bhd,bhkd->bhk", q.to(torch.float32), kd)
        s = s * ksc[..., 0] * (dh ** -0.5)
    else:
        kr = k_cache.repeat_interleave(rep, dim=1)
        s = torch.einsum("bhd,bhkd->bhk", q.to(torch.float32),
                         kr.to(torch.float32)) * (dh ** -0.5)
    if causal:
        gpos = start + torch.arange(s_loc, device=q.device)
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
    return m, l, o


def _local_flash_decode(q, k_cache, v_cache, k_new, v_new, pos, *,
                        kv_scheme: str = "uniform8"):
    """One-token decode against one device's whole cache (the reference's
    ``_local_flash_decode`` with ``axis=None``). q: (B, Hq, dh); caches:
    (B, Hkv, S, dh) tensors, or {"codes" uint8 (B, Hkv, S, dh), "scale"
    f32 (B, Hkv, S, 1)} dicts for the quantized cache; k_new/v_new:
    (B, Hkv, dh); pos: (B,) write and attend position per row. Writes the
    new token in place and returns (out (B, Hq, dh), k_cache, v_cache)."""
    _write_token(k_cache, v_cache, k_new, v_new, pos, 0, kv_scheme)
    m, l, o = _decode_stats(q, k_cache, v_cache, pos, 0, kv_scheme)
    out = o / torch.clamp(l, min=1e-30)
    return out.to(q.dtype), k_cache, v_cache


def merge_decode_stats(parts: list, mesh) -> torch.Tensor:
    """The sequence shards' partials ``(m, l, o)`` merged in shard order
    on the first shard's device of ``mesh``: the reference's
    ``pmax``/``psum`` merge (``m_g`` the largest ``m``, each part rescaled
    by ``exp(m - m_g)``, ``o / max(l, 1e-30)``), its sums added in a fixed
    order; counted as its three all-reduces over the shards."""
    dev0 = mesh.devices[0]
    parts = [tuple(t.to(dev0) for t in part) for part in parts]
    m_g = parts[0][0]
    for m, _, _ in parts[1:]:
        m_g = torch.maximum(m_g, m)
    l_g = o_g = None
    for m, l, o in parts:
        corr = torch.exp(m - m_g)
        l_g = l * corr if l_g is None else l_g + l * corr
        o_g = o * corr if o_g is None else o_g + o * corr
    for t in (m_g, l_g, o_g):
        collectives.note("all-reduce", mesh.ids, collectives.nbytes(t))
    return o_g / torch.clamp(l_g, min=1e-30)


def decode_attention_sharded(q, k_caches: list, v_caches: list, k_new,
                             v_new, pos, *, rt: Runtime):
    """``decode_attention`` over a cache cut on its sequence: block ``m``
    (B, Hkv, S/n, dh) of ``k_caches``/``v_caches`` holds positions [m S/n,
    (m + 1) S/n) on shard m of ``rt.mesh``. The new token is written only
    into the block that holds ``pos``; each block computes its partials
    for every query head (``_decode_stats``), merged in shard order
    (``merge_decode_stats``). q, k_new, v_new, pos on the first shard's
    device. Returns out (B, Hq, dh) there."""
    devices = rt.mesh.devices
    first = k_caches[0]["codes"] if isinstance(k_caches[0], dict) \
        else k_caches[0]
    s_loc = first.shape[2]
    parts = []
    for m, (kc, vc, dev) in enumerate(zip(k_caches, v_caches, devices)):
        qd, pd = q.to(dev), pos.to(dev)
        _write_token(kc, vc, k_new.to(dev), v_new.to(dev), pd, m * s_loc,
                     rt.kv_scheme)
        parts.append(_decode_stats(qd, kc, vc, pd, m * s_loc, rt.kv_scheme))
    return merge_decode_stats(parts, rt.mesh).to(q.dtype)


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


def attn_decode_step_sharded(ps: list, x: torch.Tensor, pos, k_blocks: list,
                             v_blocks: list, *, n_heads: int,
                             n_kv_heads: int, head_dim: int,
                             rope_theta: float = 10000.0,
                             mrope_sections=None, rt: Runtime):
    """``attn_decode_step`` tensor-parallel over the shards of ``rt.mesh``
    (the serve steps' decode) against a dense cache held as one block per
    shard: cut on its sequence when ``rt.decode_seq_axis`` is set, whole
    on every shard otherwise. Each shard projects and ropes its head
    group; the queries of every head and the new K/V of every KV head
    (``gather_kv``) go to every block, each block takes the token where
    it lands and its partials merge in shard order
    (``decode_attention_sharded``; over whole copies every copy takes the
    token and the first one attends); each shard's ``wo`` rows take its
    heads' output, summed in shard order. x: (B, 1, D) on the first
    shard's device; pos: scalar or (B,). Returns y (B, 1, D) there."""
    n, devs, ids = len(ps), rt.mesh.devices, rt.mesh.ids
    groups = planner.shard_heads(n_heads, n_kv_heads, n)
    b = x.shape[0]
    pos_b = torch.broadcast_to(torch.as_tensor(pos, device=x.device),
                               (b,)).long()
    qs, ks, vs = [], [], []
    for g, p, dev in zip(groups, ps, devs):
        q, k, v = _project_qkv(p, x.to(dev), g.nq,
                               p["wk"]["w"].shape[-1] // head_dim, head_dim,
                               rt)
        q, k = _apply_positional(
            q, k, _text_positions(pos_b.to(dev)[:, None], mrope_sections),
            rope_theta, mrope_sections)
        if g.part == 0:     # a shared head's queries from its first shard
            qs.append(q[:, 0])
        ks.append(k[:, 0])
        vs.append(v[:, 0])
    q = collectives.all_gather(qs, 1, devs[0], ids)
    k = gather_kv(ks, n_kv_heads, rt.mesh)
    v = gather_kv(vs, n_kv_heads, rt.mesh)
    if rt.decode_seq_axis is not None:
        out = decode_attention_sharded(q, k_blocks, v_blocks, k, v, pos_b,
                                       rt=rt)
    else:
        for kb, vb, dev in zip(k_blocks, v_blocks, devs):
            _write_token(kb, vb, k.to(dev), v.to(dev), pos_b.to(dev), 0,
                         rt.kv_scheme)
        m, l, o = _decode_stats(q, k_blocks[0], v_blocks[0], pos_b, 0,
                                rt.kv_scheme)
        out = (o / torch.clamp(l, min=1e-30)).to(q.dtype)
    return shard_sum([
        dense_apply(p["wo"], _take_cols(
            out[:, g.q0:g.q0 + g.nq].to(dev).reshape(b, 1, g.nq * head_dim),
            own_cols(n_heads, n_kv_heads, n, s, head_dim)), rt)
        for s, (g, p, dev) in enumerate(zip(groups, ps, devs))], rt.mesh)


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


def pool_view(pool, ka: int, g: int):
    """A page pool's KV heads [ka, ka + g) as a pool of their own: a
    (n_pages, Hkv, ps, w) tensor (or codes/scale dict) seen as
    (n_pages * Hkv / g, g, ps, w), whose physical page ``p * Hkv / g +
    ka / g`` holds page ``p``'s heads (``table_view`` maps a block table
    onto it). No copy: the kernels read it as they read any pool."""
    if isinstance(pool, dict):
        return {k: pool_view(v, ka, g) for k, v in pool.items()}
    n_pages, hkv = pool.shape[:2]
    if g == hkv:
        return pool
    return pool.view(n_pages * (hkv // g), g, *pool.shape[2:])


def table_view(block_table, hkv: int, ka: int, g: int):
    """``block_table`` over ``pool_view(pool, ka, g)`` of an ``hkv``-head
    pool."""
    if g == hkv:
        return block_table
    return block_table * (hkv // g) + ka // g


def _paged_project_write(p: dict, x, ctx_len, block_table, cache: dict, *,
                         n_heads: int, n_kv_heads: int, head_dim: int,
                         n_valid, rope_theta: float, mrope_sections,
                         rt: Runtime):
    """Project a chunk, rope q and k at each row's absolute positions and
    write K/V into the pools (before any attention reads them, so the
    kernels need no positions). Returns (q (B, C, Hq, dh), kp, vp,
    positions (B, C))."""
    c = x.shape[1]
    q, k, v = _project_qkv(p, x, n_heads, n_kv_heads, head_dim, rt)
    positions = ctx_len[:, None] + torch.arange(c, dtype=ctx_len.dtype,
                                                device=x.device)
    q, k = _apply_positional(q, k, _text_positions(positions, mrope_sections),
                             rope_theta, mrope_sections)
    valid = torch.arange(c, device=x.device)[None, :] < n_valid[:, None]
    kp, vp = paged_kv_write(cache["kp"], cache["vp"], k, v, block_table,
                            positions, valid, kv_scheme=rt.kv_scheme)
    return q, kp, vp, positions


def _paged_attend(q, kp, vp, block_table, ctx_len, n_valid, positions, *,
                  rt: Runtime, fused: bool):
    """Attention of a chunk's q (B, C, Hq, dh) over the pools: the ragged
    decode kernel (``fused``), the one-token kernel (C == 1) or the page
    gather. Returns (B, C, Hq * dh)."""
    b, c, hq, dh = q.shape
    quantized = isinstance(kp, dict)
    attend_len = ctx_len + n_valid
    if fused:
        out = ops.paged_decode_ragged(
            q, kp, vp, block_table, ctx_len, n_valid,
            kv_scheme=rt.kv_scheme if quantized else None, impl=rt.impl)
        return out.reshape(b, c, hq * dh)
    if c == 1:
        q1 = q[:, 0].reshape(b, hq, dh)
        if quantized:
            out = ops.paged_attention_quant(q1, kp, vp, block_table,
                                            attend_len,
                                            kv_scheme=rt.kv_scheme,
                                            impl=rt.impl)
        else:
            out = ops.paged_attention(q1, kp, vp, block_table, attend_len,
                                      impl=rt.impl)
        return out.reshape(b, 1, hq * dh)
    o = _paged_chunk_attention(q.transpose(1, 2), kp, vp, block_table,
                               positions, attend_len,
                               kv_scheme=rt.kv_scheme)
    return o.transpose(1, 2).reshape(b, c, hq * dh)


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
    q, kp, vp, positions = _paged_project_write(
        p, x, ctx_len, block_table, cache, n_heads=n_heads,
        n_kv_heads=n_kv_heads, head_dim=head_dim, n_valid=n_valid,
        rope_theta=rope_theta, mrope_sections=mrope_sections, rt=rt)
    o = _paged_attend(q, kp, vp, block_table, ctx_len, n_valid, positions,
                      rt=rt, fused=fused)
    return dense_apply(p["wo"], o, rt), dict(cache, kp=kp, vp=vp)


def attn_paged_step_sharded(ps: list, x: torch.Tensor, ctx_len: list,
                            block_table: list, caches: list, *,
                            n_heads: int, n_kv_heads: int, head_dim: int,
                            n_valid: list, rope_theta: float = 10000.0,
                            mrope_sections=None, rt: Runtime,
                            fused: bool = False):
    """``attn_paged_step`` split over the shards of ``rt.mesh`` by heads.
    Shard s holds the ``wq`` columns of its head group
    (``planner.shard_heads``: uneven where the heads do not divide), the
    ``wk``/``wv`` columns of its KV heads (all of them where they do not
    split, the pools then replicating) and the ``wo`` rows of its query
    heads (``sharding.shard_params``): it projects, writes its own pool
    and attends its heads piece by piece (``head_segments``: one piece
    unless its queries straddle KV heads unevenly; a piece over some of a
    replicated pool's heads reads them through ``pool_view``) through the
    same kernel routes as one device does, and its ``wo`` product is a
    partial sum. The partials are summed in shard order on the first
    shard's device (``shard_sum``).

    ps, caches: per shard, this layer's params and {"kp", "vp"} pools;
    ctx_len, block_table, n_valid: per shard, on its device; n_heads,
    n_kv_heads: the model's (unsharded) counts; x: the normed input
    (B, C, D). Writes the pools in place and returns (y (B, C, D) on the
    first shard's device, caches)."""
    n, parts = len(ps), []
    for s, (p, ctx, bt, nv, cache, dev) in enumerate(zip(
            ps, ctx_len, block_table, n_valid, caches, rt.mesh.devices)):
        hkv = p["wk"]["w"].shape[-1] // head_dim
        q, kp, vp, positions = _paged_project_write(
            p, x.to(dev), ctx, bt, cache,
            n_heads=planner.shard_heads(n_heads, n_kv_heads, n)[s].nq,
            n_kv_heads=hkv, head_dim=head_dim, n_valid=nv,
            rope_theta=rope_theta, mrope_sections=mrope_sections, rt=rt)
        o = torch.cat([
            _paged_attend(q[:, :, qa:qa + qn], pool_view(kp, ka, g),
                          pool_view(vp, ka, g), table_view(bt, hkv, ka, g),
                          ctx, nv, positions, rt=rt, fused=fused)
            for qa, qn, ka, g in head_segments(n_heads, n_kv_heads, n, s)],
            dim=-1)
        parts.append(dense_apply(p["wo"], _take_cols(o, own_cols(
            n_heads, n_kv_heads, n, s, head_dim)), rt))
    return shard_sum(parts, rt.mesh), caches
