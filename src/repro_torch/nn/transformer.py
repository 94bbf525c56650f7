"""Block assembly and the loop over periods.

An architecture is a repeating *pattern* of slots (ArchConfig.pattern):
a mixer (``attn``, ``mamba``, ``mlstm`` or ``slstm``), optionally with an
FFN (``+dense`` or ``+moe``). Parameters for each slot are stacked over
periods (leading P dim), as in the reference; the reference's ``lax.scan``
over periods becomes a Python loop that slices period ``i`` out of every
leaf (caches included: their slices are views, written in place). One
slot dispatcher serves four modes: ``train`` (full-sequence forward),
``prefill`` (the forward that also writes each slot's serving state: the
prompt's K/V into a dense per-slot cache, a recurrent mixer's final
state), ``decode`` (one token against that state) and ``paged`` (serving
over the state cache: attention slots read and write token pages,
recurrent slots their row of the slab region). The enc-dec decoder slot
``xdec`` (whisper) is self-attention followed by cross-attention over the
encoder's output: projected from ``enc_out`` in the train and prefill
modes (prefill also writes it into the dense cache's ``xk``/``xv``), read
from that cache in decode, and read from the shared cross region of the
state cache in paged mode. Under ``Runtime.mesh`` the paged mode of
every pattern (and the train mode of an enc-dec model's encoder) runs
tensor-parallel over the mesh's shards: attention by heads, the dense FFN
by its columns, the MoE by experts, and each recurrent mixer whole on
every shard (``stack_paged``); so do the prefill and decode modes of the
serve steps (``launch.steps``, one data group's model shards), against
dense caches held as one block per shard, and ``stack_prefill_cp`` runs
the context-parallel prefill (an LM's prompt, an encoder's frames, a
decoder's prompt with its cross-attention: each sequence cut over the
shards where its length divides them, else whole on the first shard).
The train mode runs one data group of the
train step's ``tp`` the same way, and ``stack_apply_rows`` its ``fsdp``
(each device's rows, a MoE's rows joined); both checkpoint each period,
and each slot of a longer pattern, under ``Runtime.remat``.
"""
from __future__ import annotations

import functools

import torch
import torch.utils.checkpoint

from repro_torch import collectives
from repro_torch.configs.base import ArchConfig
from repro_torch.runtime import Runtime, planner

from . import ssm
from .attention import (attention_core, attn_apply_dense,
                        attn_apply_dense_cp, attn_apply_dense_sharded,
                        attn_decode_step, attn_decode_step_sharded,
                        attn_init, attn_paged_step, attn_paged_step_sharded,
                        gather_kv, head_segments, own_cols, quantize_kv)
from .layers import dense_apply, norm_apply, norm_init, shard_sum, tree_index
from .mlp import mlp_apply, mlp_apply_sharded, mlp_init
from .moe import moe_apply, moe_apply_sharded, moe_init
from .rotary import apply_rope

__all__ = ["stack_init", "stack_apply", "stack_apply_rows", "stack_prefill",
           "stack_prefill_cp", "cp_blocks", "stack_decode",
           "stack_paged", "slot_init_cache", "slot_init_paged_cache",
           "SLOT_KINDS"]

SLOT_KINDS = ("attn", "xdec", "mamba", "mlstm", "slstm")
#: mixers whose serving state is a per-sequence slab
SLAB_MIXERS = ("mamba", "mlstm", "slstm")
#: a slot's replicated norms: under ``rt.mesh`` shard 0's copy serves the
#: residual stream on its device
_NORMS = ("norm1", "norm2", "norm_x")


def _parse_slot(slot: str):
    parts = slot.split("+")
    mixer = parts[0]
    ffn = parts[1] if len(parts) > 1 else None
    if mixer not in SLOT_KINDS:
        raise ValueError(f"unknown slot {slot!r}")
    return mixer, ffn


def _slot_init(gen: torch.Generator, slot: str, cfg: ArchConfig, dtype,
               device) -> dict:
    mixer, ffn = _parse_slot(slot)
    d = cfg.d_model
    kw = dict(dtype=dtype, device=device)
    p = {"norm1": norm_init(cfg.norm, d, dtype, device)}
    if mixer in ("attn", "xdec"):
        p["attn"] = attn_init(gen, d, cfg.n_heads, cfg.n_kv_heads, cfg.dh,
                              qkv_bias=cfg.qkv_bias, **kw)
        if mixer == "xdec":
            p["xattn"] = attn_init(gen, d, cfg.n_heads, cfg.n_kv_heads,
                                   cfg.dh, qkv_bias=cfg.qkv_bias, **kw)
            p["norm_x"] = norm_init(cfg.norm, d, dtype, device)
    elif mixer == "mamba":
        p["mamba"] = ssm.mamba_init(
            gen, d, d_state=cfg.ssm_d_state, d_conv=cfg.ssm_d_conv,
            expand=cfg.ssm_expand, dt_rank=cfg.ssm_dt_rank or None, **kw)
    elif mixer == "mlstm":
        p["mlstm"] = ssm.mlstm_init(gen, d, n_heads=cfg.lstm_heads,
                                    expand=cfg.ssm_expand,
                                    d_conv=cfg.ssm_d_conv, **kw)
    elif mixer == "slstm":
        p["slstm"] = ssm.slstm_init(gen, d, n_heads=cfg.lstm_heads, **kw)
    if ffn == "dense":
        p["norm2"] = norm_init(cfg.norm, d, dtype, device)
        # d_ff = 0 (xLSTM): the sLSTM slot's FFN takes a 4/3 expansion,
        # rounded up to a multiple of 128
        d_ff = cfg.d_ff or ((4 * d // 3 + 127) // 128 * 128)
        p["mlp"] = mlp_init(gen, d, d_ff, variant=cfg.mlp_variant,
                            act=cfg.act, **kw)
    elif ffn == "moe":
        p["norm2"] = norm_init(cfg.norm, d, dtype, device)
        p["moe"] = moe_init(gen, d, cfg.d_ff, cfg.n_experts,
                            n_shared=cfg.n_shared_experts, **kw)
    return p


def _stack(trees: list):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def stack_init(gen: torch.Generator, cfg: ArchConfig, dtype=torch.float32,
               device="cpu") -> dict:
    """Stacked params: {'slots': [slot params with a leading P dim, ...]}.
    Random, from ``gen``: the reference's ``jax.random`` draws cannot be
    reproduced, so tests carry JAX-made weights over (``interop``)."""
    slots = []
    for slot in cfg.pattern:
        per_period = [_slot_init(gen, slot, cfg, dtype, device)
                      for _ in range(cfg.n_periods)]
        slots.append(_stack(per_period))
    return {"slots": slots}


def _cross_kv(p_attn: dict, enc_out: torch.Tensor, n_kv_heads: int,
              head_dim: int, rt: Runtime):
    """Cross-attention K/V of one layer: the encoder output (B, S_enc, D)
    through ``wk`` and ``wv`` (``spx_matmul`` for SPx weights), each
    (B, S_enc, Hkv, dh), unroped."""
    b, s, _ = enc_out.shape
    k = dense_apply(p_attn["wk"], enc_out, rt).reshape(b, s, n_kv_heads,
                                                       head_dim)
    v = dense_apply(p_attn["wv"], enc_out, rt).reshape(b, s, n_kv_heads,
                                                       head_dim)
    return k, v


def _paged_cross(p_x: dict, hx, cache: dict, ctx_len, state_idx,
                 cfg: ArchConfig, rt: Runtime, n_heads: int, segments=None,
                 out_cols=None):
    """Cross-attention of a paged chunk against the shared cross region:
    row b reads entry ``state_idx[b, 1]`` (clamped where it is the
    sentinel: such a row's output is never read), q is roped at the
    row's absolute positions ``ctx_len + i``, K/V are unroped and the
    attention spans every encoder frame. Entries are only read here.
    ``n_heads``: the query heads ``p_x`` projects (one shard's under
    ``rt.mesh``, attending its ``segments``, its ``wo`` rows taking the
    output's ``out_cols``)."""
    b, c, _ = hx.shape
    n_cross = cache["xk"].shape[0]
    idx = torch.clamp(state_idx[:, 1].long(), 0, max(n_cross - 1, 0))
    q = dense_apply(p_x["wq"], hx, rt).reshape(b, c, n_heads, cfg.dh)
    positions = ctx_len[:, None] + torch.arange(c, dtype=ctx_len.dtype,
                                                device=hx.device)
    q = apply_rope(q, positions, theta=cfg.rope_theta)
    o = attention_core(q.transpose(1, 2), cache["xk"][idx].to(q.dtype),
                       cache["xv"][idx].to(q.dtype), causal=False, rt=rt,
                       segments=segments)
    o = o.transpose(1, 2).reshape(b, c, n_heads * cfg.dh)
    if out_cols is not None:
        o = o[..., out_cols[0]:out_cols[0] + out_cols[1]]
    return dense_apply(p_x["wo"], o, rt)


def _paged_cross_sharded(ps: list, hx, caches: list, ctx_len: list,
                         state_idx: list, cfg: ArchConfig, rt: Runtime):
    """``_paged_cross`` split over the shards of ``rt.mesh`` by heads:
    shard s attends its head group (``planner.shard_heads``) over its
    cross region (head-sharded, or replicated where the KV heads do not
    split), and its ``wo`` rows' partial products are summed in shard
    order (``shard_sum``)."""
    n = len(ps)
    groups = planner.shard_heads(cfg.n_heads, cfg.n_kv_heads, n)
    return shard_sum([
        _paged_cross(p, hx.to(dev), c, cl, si, cfg, rt, groups[s].nq,
                     head_segments(cfg.n_heads, cfg.n_kv_heads, n, s),
                     own_cols(cfg.n_heads, cfg.n_kv_heads, n, s, cfg.dh))
        for s, (p, c, cl, si, dev) in enumerate(zip(
            ps, caches, ctx_len, state_idx, rt.mesh.devices))], rt.mesh)


def _cross_sublayer(p: dict, x, positions, cfg: ArchConfig, rt: Runtime, *,
                    mode: str, cache, pos, enc_out, paged_ctx,
                    tp: bool = False):
    """The xdec slot's cross-attention in one of the four modes (paged
    mode tensor-parallel under ``tp``). Returns its output y (B, S, D);
    prefill writes the projected encoder K/V into the dense cache's
    ``xk``/``xv`` in place."""
    hx = norm_apply(cfg.norm, p["norm_x"], x)
    heads = dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                 head_dim=cfg.dh, rope_theta=cfg.rope_theta, rt=rt)
    if mode == "paged":
        ctx_len, _, _, state_idx = paged_ctx[:4]
        if tp:
            return _paged_cross_sharded(p["xattn"], hx, cache, ctx_len,
                                        state_idx, cfg, rt)
        return _paged_cross(p["xattn"], hx, cache, ctx_len, state_idx, cfg,
                            rt, cfg.n_heads)
    if tp:
        return _cross_mesh(p["xattn"], hx, positions, cfg, rt, mode=mode,
                           caches=cache, pos=pos, enc_out=enc_out)
    if mode == "decode":
        y, _ = attn_decode_step(
            p["xattn"], hx, pos, None,
            cross_kv=(cache["xk"].transpose(1, 2),
                      cache["xv"].transpose(1, 2)), **heads)
        return y
    xk, xv = _cross_kv(p["xattn"], enc_out, cfg.n_kv_heads, cfg.dh, rt)
    if mode == "prefill":
        cache["xk"].copy_(xk.transpose(1, 2))
        cache["xv"].copy_(xv.transpose(1, 2))
    return attn_apply_dense(p["xattn"], hx, positions, causal=False,
                            cross_kv=(xk, xv), **heads)


def _write_prefix(cache, val, rt: Runtime) -> None:
    """Write a prompt's K or V, (B, Hkv, S, dh), into positions [0, S) of
    a dense cache in place: values, or codes and scales (``rt.kv_scheme``)
    for a quantized cache."""
    s = val.shape[2]
    if isinstance(cache, dict):
        codes, scale = quantize_kv(val, rt.kv_scheme)
        cache["codes"][:, :, :s] = codes
        cache["scale"][:, :, :s] = scale
    else:
        cache[:, :, :s] = val.to(cache.dtype)


def _write_state(cache: dict, state: dict) -> None:
    """Copy a recurrent mixer's new state into its dense cache, in place."""
    for k, leaf in cache.items():
        leaf.copy_(state[k].to(leaf.dtype))


def _slab_step(cache: dict, state_idx, rows, step_fn):
    """Run a recurrent mixer's paged step against the slab region: gather
    each row's slab (``state_idx[:, 0]``, clamped where it is the sentinel),
    step, and write the new state back for ``rows`` only — the rows with
    ``n_valid > 0`` and a real slab. Every other slab stays bit-identical.
    ``cache``: the slot's slab leaves, (n_slabs, ...) views."""
    slab_idx = state_idx[:, 0].long()
    n_slabs = next(iter(cache.values())).shape[0]
    safe = torch.clamp(slab_idx, 0, max(n_slabs - 1, 0))
    y, new = step_fn({k: leaf[safe] for k, leaf in cache.items()})
    dst = slab_idx[rows]
    for k, leaf in cache.items():
        leaf[dst] = new[k][rows].to(leaf.dtype)
    return y, cache


_PAGED_STEPS = {"mamba": ssm.mamba_paged_step, "mlstm": ssm.mlstm_paged_step,
                "slstm": ssm.slstm_paged_step}
_DECODE_STEPS = {"mamba": ssm.mamba_decode_step,
                 "mlstm": ssm.mlstm_decode_step,
                 "slstm": ssm.slstm_decode_step}
_APPLIES = {"mamba": ssm.mamba_apply, "mlstm": ssm.mlstm_apply,
            "slstm": ssm.slstm_apply}


def _recurrent(slot_p, h, cfg: ArchConfig, rt: Runtime, mixer: str, *,
               mode: str, cache, paged_ctx):
    """A recurrent mixer in one of the four modes. Returns (y, cache)."""
    kw = dict(rt=rt)
    if mixer == "mlstm":
        kw["n_heads"] = cfg.lstm_heads
    if mode == "paged":
        _, _, n_valid, state_idx, rows = paged_ctx
        return _slab_step(cache, state_idx, rows,
                          lambda st: _PAGED_STEPS[mixer](slot_p, h, st,
                                                         n_valid, **kw))
    if mode == "decode":
        y, new = _DECODE_STEPS[mixer](slot_p, h, cache, **kw)
        _write_state(cache, new)
        return y, cache
    if mode == "prefill":
        # from the zero state, as the reference's prefill
        y, new = _APPLIES[mixer](slot_p, h, return_state=True, **kw)
        _write_state(cache, new)
        return y, cache
    return _APPLIES[mixer](slot_p, h, **kw), cache


def _recurrent_sharded(ps: list, h, cfg: ArchConfig, rt: Runtime,
                       mixer: str, *, mode: str, cache: list, paged_ctx):
    """A recurrent mixer under ``rt.mesh``, whole on every shard (its
    leaves replicate). Paged mode: its slabs replicate too, as the
    reference's pool spec keeps them, each shard stepping its own copy of
    the slab region the same way, so the copies stay identical, and shard
    0's output joins the residual stream (``paged_ctx``: per-shard
    lists). Train mode (the train step's ``tp``): the mixer runs once,
    from shard 0's copy. The serve steps' prefill and decode: the state,
    cut over the
    shards as ``sharding.cache_spec`` lays it out, is joined on the first
    shard's device, the mixer runs there once, and each shard keeps its
    block of the new state."""
    if mode == "train":
        # once, from shard 0's copy: the copies take one gradient (the
        # train step sums it over the devices that hold a copy)
        return _recurrent(ps[0], h, cfg, rt, mixer, mode=mode, cache=None,
                          paged_ctx=None)
    if mode in ("prefill", "decode"):
        state = _join_state(cache, mixer, cfg, rt.mesh)
        y, _ = _recurrent(ps[0], h, cfg, rt, mixer, mode=mode, cache=state,
                          paged_ctx=None)
        _split_state(cache, state, mixer, cfg)
        return y, cache
    ys = [_recurrent(p, h.to(dev), cfg, rt, mixer, mode=mode, cache=c,
                     paged_ctx=tuple(t[s] for t in paged_ctx))[0]
          for s, (p, c, dev) in enumerate(zip(ps, cache, rt.mesh.devices))]
    return ys[0], cache


# -- the serve steps under a mesh (``launch.steps``) -------------------------

def _state_dims(blocks: list, mixer: str, cfg: ArchConfig) -> dict:
    """The dim of each of a recurrent mixer's state leaves (a period's,
    (B, ...)) that the shards' ``blocks`` cut (``sharding.cache_spec``:
    the largest trailing dim the policy's model shards divide, unevenly
    under the context-parallel prefill's), or None: the dim where a block
    is not the whole leaf."""
    b = next(iter(blocks[0].values())).shape[0]
    leaves = _state_leaves(mixer, cfg, (b,), torch.float32, "meta")
    return {k: next((i for i, n in enumerate(v.shape)
                     if any(c[k].shape[i] != n for c in blocks)), None)
            for k, v in leaves.items()}


def _join_state(blocks: list, mixer: str, cfg: ArchConfig, mesh) -> dict:
    """A recurrent state whole on the first block's device, from each
    shard's block of it (an all-gather over the shards of ``mesh`` where
    it is cut)."""
    dev0 = next(iter(blocks[0].values())).device
    out = {}
    for k, d in _state_dims(blocks, mixer, cfg).items():
        out[k] = (blocks[0][k].clone() if d is None else
                  collectives.all_gather([c[k] for c in blocks], d, dev0,
                                         mesh.ids))
    return out


def _split_state(blocks: list, state: dict, mixer: str,
                 cfg: ArchConfig) -> None:
    """Write each shard's block of ``state`` back, in place."""
    for k, d in _state_dims(blocks, mixer, cfg).items():
        lo = 0
        for c in blocks:
            part = state[k]
            if d is not None:
                part = part.narrow(d, lo, c[k].shape[d])
                lo += c[k].shape[d]
            c[k].copy_(part.to(c[k].device))


def _write_blocks(blocks: list, val, rt: Runtime, seq_sharded: bool) -> None:
    """Write a prompt's K or V (B, Hkv, S, dh) into positions [0, S) of a
    dense cache held as one block per shard, in place: where the cache is
    cut on its sequence each block holds the positions after the blocks
    before it (as many as it is long: uneven where the shards do not
    divide the cache), else every position."""
    s, lo = val.shape[2], 0
    for blk in blocks:
        leaf = blk["codes"] if isinstance(blk, dict) else blk
        start = lo if seq_sharded else 0
        part = val[:, :, start:min(s, start + leaf.shape[2])]
        if part.shape[2]:
            _write_prefix(blk, part.to(leaf.device), rt)
        lo += leaf.shape[2]


def _attn_mesh(ps: list, h, positions, pos, caches: list, cfg: ArchConfig,
               rt: Runtime, *, mode: str):
    """A self-attention sublayer of the serve steps, tensor-parallel over
    the shards of ``rt.mesh`` (one data group's model shards) against
    dense caches held as one block per shard (``caches``), cut on their
    sequence when ``rt.decode_seq_axis`` is set: the sharded dense
    forward with its K/V of every KV head written into the blocks
    (prefill), or ``attn_decode_step_sharded`` (decode)."""
    heads = dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                 head_dim=cfg.dh, rope_theta=cfg.rope_theta,
                 mrope_sections=cfg.mrope_sections, rt=rt)
    if mode == "decode":
        return attn_decode_step_sharded(ps, h, pos, [c["k"] for c in caches],
                                        [c["v"] for c in caches], **heads)
    y, (k, v) = attn_apply_dense_sharded(ps, h, positions, kv_out=True,
                                         **heads)
    seq = rt.decode_seq_axis is not None
    _write_blocks([c["k"] for c in caches], k.transpose(1, 2), rt, seq)
    _write_blocks([c["v"] for c in caches], v.transpose(1, 2), rt, seq)
    return y


def _cross_mesh(ps: list, hx, positions, cfg: ArchConfig, rt: Runtime, *,
                mode: str, caches: list, pos, enc_out):
    """The xdec slot's cross-attention tensor-parallel by heads (the serve
    steps, and the train step's ``tp``): train and prefill project each
    shard's KV heads of the encoder output and attend them, prefill also
    writes every KV head into the cross blocks (cut on the encoder's
    sequence where ``cache_specs`` cut them: a block shorter than
    ``enc_seq_len``); decode joins each shard's KV heads
    from the blocks and attends them at ``pos``. Each shard's ``wo``
    partial summed in shard order."""
    devs, dh, n = rt.mesh.devices, cfg.dh, len(ps)
    heads = dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                 head_dim=dh, rope_theta=cfg.rope_theta, rt=rt)
    if mode in ("prefill", "train"):
        kvs = [_cross_kv(p, enc_out.to(dev), p["wk"]["w"].shape[-1] // dh,
                         dh, rt) for p, dev in zip(ps, devs)]
        if mode == "prefill":
            seq = caches[0]["xk"].shape[2] < cfg.enc_seq_len
            for key, i in (("xk", 0), ("xv", 1)):
                whole = gather_kv([kv[i] for kv in kvs], cfg.n_kv_heads,
                                  rt.mesh)
                _write_blocks([c[key] for c in caches],
                              whole.transpose(1, 2), rt, seq)
        return attn_apply_dense_sharded(ps, hx, positions, causal=False,
                                        cross_kv=kvs, **heads)
    seq = caches[0]["xk"].shape[2] < cfg.enc_seq_len
    b = hx.shape[0]
    pos_b = torch.broadcast_to(torch.as_tensor(pos, device=hx.device),
                               (b,)).long()
    split = planner.kv_heads_split(cfg.n_kv_heads, n)
    kvs = []
    for s, dev in enumerate(devs):
        kv = []
        for key in ("xk", "xv"):
            # each shard joins the blocks where they are cut on the
            # encoder's sequence (an all-gather): counted on every shard
            # once, at shard 0's
            t = (collectives.all_gather([c[key] for c in caches], 2, dev,
                                        rt.mesh.ids if s == 0 else ())
                 if seq else caches[0][key].to(dev))
            if split:
                g = t.shape[1] // n
                t = t[:, s * g:(s + 1) * g]
            kv.append(t.transpose(1, 2))
        kvs.append(tuple(kv))
    return attn_apply_dense_sharded(ps, hx, pos_b[:, None], causal=False,
                                    cross_kv=kvs, **heads)


def _cp_periods(params: list, cfg: ArchConfig, caches: list | None):
    """(slot kind, each shard's whole slot params, each shard's cache
    blocks, or Nones without caches) of every (period, slot): the
    context-parallel prefill's walk, every shard holding every weight."""
    caches = caches if caches is not None else [None] * len(params)
    for per_shard in zip(*(_periods(p, cfg, c)
                           for p, c in zip(params, caches))):
        yield (per_shard[0][0], [sp for _, sp, _ in per_shard],
               [c for _, _, c in per_shard])


def cp_blocks(t: torch.Tensor, positions: torch.Tensor, devs) -> tuple:
    """``t`` (B, S, ...) and its ``positions`` (..., S) cut into the row
    blocks of the context-parallel prefill over the shards on ``devs``:
    [m S/n, (m + 1) S/n) on shard m where the n shards divide S (the
    reference's ``attention_core`` rule), else one block, the whole
    sequence on the first shard. Returns (t's blocks, the positions'
    blocks), each on its shard's device."""
    s, n = t.shape[1], len(devs)
    size = s // n if s % n == 0 else s
    spans = [slice(lo, lo + size) for lo in range(0, s, size)]
    return ([t[:, sp].to(dev) for sp, dev in zip(spans, devs)],
            [positions[..., sp].to(dev) for sp, dev in zip(spans, devs)])


def stack_prefill_cp(params: list, xs: list, positions: list,
                     cfg: ArchConfig, rt: Runtime, caches: list | None = None,
                     *, causal: bool = True, enc_outs: list | None = None
                     ) -> list:
    """The context-parallel prefill (``rt.attn_cp``) over the shards of
    ``rt.mesh``, every shard holding the whole stack (the ``replicated``
    policy). ``xs`` and ``positions`` hold the row blocks of
    ``cp_blocks``: one per shard, shard m's rows [m S/n, (m + 1) S/n), or
    one, the whole sequence on the first shard. Each block runs through
    norms, projections and the dense FFN on its shard. A self-attention
    over blocks cut on the shards gathers K/V and offsets shard m's
    causal mask by m S/n (``attn_apply_dense_cp``; ``causal`` False: an
    encoder), over one whole block attends on the first shard; its K/V go
    into the cache blocks (``caches`` None: an encoder, which keeps
    none). An xdec slot's cross-attention projects the cross K/V of each
    block of ``enc_outs`` (the encoder's rows, cut or whole), writes them
    into the cross blocks and lets every query block attend all of them
    (``_cross_cp``). A MoE or a recurrent mixer, whose result depends on
    the whole sequence, runs once on the rows joined on the first shard's
    device. Returns each row block."""
    devs = rt.mesh.devices
    seq = rt.decode_seq_axis is not None
    for slot, sps, blocks in _cp_periods(params, cfg, caches):
        mixer, ffn = _parse_slot(slot)
        hs = [norm_apply(cfg.norm, sp["norm1"], x) for sp, x in zip(sps, xs)]
        if mixer in ("attn", "xdec"):
            ys, kvs = _attn_cp(sps, hs, positions, cfg, rt, causal)
            if blocks[0] is not None:
                for key, i in (("k", 0), ("v", 1)):
                    # no collective: each cache block (cut as the rows
                    # are) takes back its own shard's rows, or, whole,
                    # the rows every shard already gathered or computed
                    whole = torch.cat([kv[i].to(devs[0]) for kv in kvs],
                                      dim=1)
                    _write_blocks([c[key] for c in blocks],
                                  whole.transpose(1, 2), rt, seq)
        else:
            state = _join_state(blocks, mixer, cfg, rt.mesh)
            y, _ = _recurrent(sps[0][mixer], _rows_on_first(hs, rt.mesh),
                              cfg, rt, mixer, mode="prefill", cache=state,
                              paged_ctx=None)
            _split_state(blocks, state, mixer, cfg)
            ys = _split_rows(y, xs)
        xs = [x + y for x, y in zip(xs, ys)]
        if mixer == "xdec":
            ys = _cross_cp(sps, xs, positions, cfg, rt, blocks, enc_outs)
            xs = [x + y for x, y in zip(xs, ys)]
        if ffn is None:
            continue
        hs = [norm_apply(cfg.norm, sp["norm2"], x) for sp, x in zip(sps, xs)]
        if ffn == "dense":
            ys = [mlp_apply(sp["mlp"], h, variant=cfg.mlp_variant,
                            act=cfg.act, rt=rt) for sp, h in zip(sps, hs)]
        else:
            y, _ = moe_apply(sps[0]["moe"], _rows_on_first(hs, rt.mesh),
                             top_k=cfg.top_k, n_experts=cfg.n_experts,
                             capacity_factor=cfg.capacity_factor, rt=rt)
            ys = _split_rows(y, xs)
        xs = [x + y for x, y in zip(xs, ys)]
    return xs


def _attn_cp(sps: list, hs: list, positions: list, cfg: ArchConfig,
             rt: Runtime, causal: bool):
    """A self-attention sublayer of ``stack_prefill_cp``: (each row
    block's y, each block's roped (k, v), (B, S_block, Hkv, dh))."""
    heads = dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                 head_dim=cfg.dh, rope_theta=cfg.rope_theta,
                 mrope_sections=cfg.mrope_sections, rt=rt)
    if len(hs) == len(sps):
        return attn_apply_dense_cp([sp["attn"] for sp in sps], hs,
                                   positions, causal=causal, **heads)
    y, kv = attn_apply_dense(sps[0]["attn"], hs[0], positions[0],
                             causal=causal, kv_out=True, **heads)
    return [y], [kv]


def _cross_cp(sps: list, xs: list, positions: list, cfg: ArchConfig,
              rt: Runtime, blocks: list, enc_outs: list) -> list:
    """An xdec slot's cross-attention in ``stack_prefill_cp``: each block
    of the encoder's rows (``enc_outs``, on its shard) projects its
    cross K/V, which go into the cross cache blocks (cut on the encoder's
    sequence where ``cache_specs`` cut them: then each block takes back
    its own shard's rows); every query block attends the whole of them,
    not causal, on its shard: one all-gather of the K and one of the V
    (counted on every shard once, at shard 0's) where the encoder's rows
    are cut, else the first shard's. Returns each query block's y."""
    devs, ids = rt.mesh.devices, rt.mesh.ids
    kvs = [_cross_kv(sp["xattn"], e, cfg.n_kv_heads, cfg.dh, rt)
           for sp, e in zip(sps, enc_outs)]
    seq = blocks[0]["xk"].shape[2] < cfg.enc_seq_len
    for key, i in (("xk", 0), ("xv", 1)):
        whole = torch.cat([kv[i].to(devs[0]) for kv in kvs], dim=1)
        _write_blocks([c[key] for c in blocks], whole.transpose(1, 2), rt,
                      seq)
    ys = []
    for m, (sp, x, pos) in enumerate(zip(sps, xs, positions)):
        dev = devs[m]
        if len(kvs) > 1:
            kv = tuple(collectives.all_gather([t[i] for t in kvs], 1, dev,
                                              ids if m == 0 else ())
                       for i in (0, 1))
        else:
            kv = tuple(t.to(dev) for t in kvs[0])
        hx = norm_apply(cfg.norm, sp["norm_x"], x)
        ys.append(attn_apply_dense(
            sp["xattn"], hx, pos, n_heads=cfg.n_heads,
            n_kv_heads=cfg.n_kv_heads, head_dim=cfg.dh,
            rope_theta=cfg.rope_theta, rt=rt, causal=False, cross_kv=kv))
    return ys


def _rows_on_first(parts: list, mesh):
    """The row blocks (B, S_m, D) whole on the first shard's device: one
    block as it is, several joined (``_join_rows``)."""
    return parts[0] if len(parts) == 1 else _join_rows(parts, mesh)


def _join_rows(parts: list, mesh):
    """The shards' rows (B, S_m, D) joined on the first shard's device of
    ``mesh``: an all-gather over its shards."""
    return collectives.all_gather(parts, 1, mesh.devices[0], mesh.ids)


def _split_rows(y, like: list) -> list:
    """``y`` (B, S, D) cut back into the shards' row blocks, each on the
    device of its block in ``like``."""
    out, lo = [], 0
    for x in like:
        out.append(y[:, lo:lo + x.shape[1]].to(x.device))
        lo += x.shape[1]
    return out


def _slot_apply(slot: str, p: dict, x, positions, cfg: ArchConfig,
                rt: Runtime, *, mode: str, cache=None, pos=None,
                enc_out=None, causal: bool = True, paged_ctx=None,
                fused: bool = False, tp: bool = False):
    """One slot (the reference's ``_slot_apply``). mode: 'train' |
    'prefill' | 'decode' | 'paged'. Paged mode takes ``paged_ctx =
    (ctx_len, block_table, n_valid, state_idx, slab_rows)``; an xdec slot
    takes ``enc_out`` in the train and prefill modes. ``tp`` runs the
    slot tensor-parallel over ``rt.mesh``: ``p`` is then a shard view
    (``_shard_view``), ``cache`` and each entry of ``paged_ctx``
    per-shard lists. Returns (x, cache, aux) with aux the MoE
    load-balance loss (0 elsewhere)."""
    mixer, ffn = _parse_slot(slot)
    x, cache = _mixer_apply(mixer, p, x, positions, cfg, rt, mode=mode,
                            cache=cache, pos=pos, enc_out=enc_out,
                            causal=causal, paged_ctx=paged_ctx, fused=fused,
                            tp=tp)
    x, aux = _ffn_apply(ffn, p, x, cfg, rt, tp=tp)
    return x, cache, aux


def _mixer_apply(mixer: str, p: dict, x, positions, cfg: ArchConfig,
                 rt: Runtime, *, mode: str, cache, pos, enc_out, causal,
                 paged_ctx, fused, tp):
    """A slot's mixer sublayer (and an xdec slot's cross-attention) with
    its residual: (x, cache)."""
    h = norm_apply(cfg.norm, p["norm1"], x)
    if mixer in ("attn", "xdec"):
        heads = dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                     head_dim=cfg.dh, rope_theta=cfg.rope_theta,
                     mrope_sections=cfg.mrope_sections, rt=rt)
        if mode == "paged":
            ctx_len, block_table, n_valid = paged_ctx[:3]
            step = attn_paged_step_sharded if tp else attn_paged_step
            y, cache = step(p["attn"], h, ctx_len, block_table, cache,
                            n_valid=n_valid, fused=fused, **heads)
        elif tp and mode in ("prefill", "decode"):
            y = _attn_mesh(p["attn"], h, positions, pos, cache, cfg, rt,
                           mode=mode)
        elif mode == "decode":
            y, (k, v) = attn_decode_step(p["attn"], h, pos,
                                         (cache["k"], cache["v"]), **heads)
            cache = dict(cache, k=k, v=v)
        elif mode == "prefill":
            y, (k, v) = attn_apply_dense(p["attn"], h, positions,
                                         causal=causal, kv_out=True, **heads)
            # (B, S, Hkv, dh) -> the cache's (B, Hkv, S, dh) layout
            _write_prefix(cache["k"], k.transpose(1, 2), rt)
            _write_prefix(cache["v"], v.transpose(1, 2), rt)
        else:
            dense = attn_apply_dense_sharded if tp else attn_apply_dense
            y = dense(p["attn"], h, positions, causal=causal, **heads)
        if mixer == "xdec":
            x = x + y
            y = _cross_sublayer(p, x, positions, cfg, rt, mode=mode,
                                cache=cache, pos=pos, enc_out=enc_out,
                                paged_ctx=paged_ctx, tp=tp)
    else:
        recurrent = _recurrent_sharded if tp else _recurrent
        y, cache = recurrent(p[mixer], h, cfg, rt, mixer, mode=mode,
                             cache=cache, paged_ctx=paged_ctx)
    return x + y, cache


def _ffn_apply(ffn, p: dict, x, cfg: ArchConfig, rt: Runtime, *,
               tp: bool = False):
    """A slot's FFN sublayer with its residual: (x, aux), aux the MoE's
    load-balance loss (0 elsewhere)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if ffn == "dense":
        h = norm_apply(cfg.norm, p["norm2"], x)
        mlp = mlp_apply_sharded if tp else mlp_apply
        x = x + mlp(p["mlp"], h, variant=cfg.mlp_variant, act=cfg.act, rt=rt)
    elif ffn == "moe":
        h = norm_apply(cfg.norm, p["norm2"], x)
        moe = moe_apply_sharded if tp else moe_apply
        y, aux = moe(p["moe"], h, top_k=cfg.top_k, n_experts=cfg.n_experts,
                     capacity_factor=cfg.capacity_factor, rt=rt)
        x = x + y
    return x, aux


def _periods(params: dict, cfg: ArchConfig, caches=None):
    """(slot kind, params, cache) of every (period, slot) in execution
    order; the cache slices are views of ``caches``."""
    for i in range(cfg.n_periods):
        for j, slot in enumerate(cfg.pattern):
            yield (slot, tree_index(params["slots"][j], i),
                   None if caches is None else tree_index(caches[j], i))


def _shard_view(per_shard: list) -> dict:
    """One (period, slot)'s params as ``_slot_apply`` takes them under
    ``rt.mesh``: the replicated norms from shard 0, every sublayer's
    params a list over the shards."""
    return {k: v if k in _NORMS else [sp[k] for sp in per_shard]
            for k, v in per_shard[0].items()}


def _tp_periods(params: list, cfg: ArchConfig, caches=None):
    """``_periods`` over the shards' stacks: (slot kind, shard view, the
    shards' cache slices or None) of every (period, slot)."""
    caches = caches if caches is not None else [None] * len(params)
    for per_shard in zip(*(_periods(p, cfg, c)
                           for p, c in zip(params, caches))):
        yield (per_shard[0][0], _shard_view([sp for _, sp, _ in per_shard]),
               [c for _, _, c in per_shard])


def _save_dots(ctx, op, *args, **kwargs):
    """The ``dots`` remat policy: save the outputs of plain matmuls (no
    batch dims, the reference's ``dots_with_no_batch_dims_saveable``),
    recompute everything else."""
    from torch.utils.checkpoint import CheckpointPolicy
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, rt: Runtime, *, policy: bool = True):
    """``fn`` under ``rt.remat`` where autograd records: ``full``
    checkpoints it (its inputs saved, its forward recomputed in the
    backward), ``dots`` also saves its matmul outputs (with ``policy``:
    the period level, as the reference's policy applies there)."""
    if rt.remat == "none" or not torch.is_grad_enabled():
        return fn
    kw = {}
    if rt.remat == "dots" and policy:
        kw["context_fn"] = functools.partial(
            torch.utils.checkpoint.create_selective_checkpoint_contexts,
            _save_dots)
    return functools.partial(torch.utils.checkpoint.checkpoint, fn,
                             use_reentrant=False, **kw)


def _train_periods(cfg: ArchConfig, rt: Runtime, run_slot, x):
    """x through every (period, slot) of the train-mode stack:
    ``run_slot(j, i, x)`` -> (x, aux) runs slot j of period i (and reads
    its params there, so a gather in that read runs inside the
    checkpointed region). Under ``rt.remat`` each period is checkpointed,
    and each slot too where the pattern has more than one (the
    reference's hierarchical remat: the backward's recompute keeps one
    slot live). Returns (x, the sum of the aux losses)."""
    aux = None
    n_slots = len(cfg.pattern)
    for i in range(cfg.n_periods):
        def period(x, i=i):
            total = None
            for j in range(n_slots):
                slot = functools.partial(run_slot, j, i)
                if n_slots > 1:
                    slot = _remat(slot, rt, policy=False)
                x, a = slot(x)
                total = a if total is None else total + a
            return x, total
        x, a = _remat(period, rt)(x)
        aux = a if aux is None else aux + a.to(aux.device)
    return x, aux


def stack_apply(params, x: torch.Tensor, positions, cfg: ArchConfig,
                rt: Runtime, enc_out=None, causal: bool = True):
    """Train-mode stack (differentiable under autograd), checkpointed
    under ``rt.remat``. Returns (x, aux) with aux the sum of the MoE
    load-balance losses. ``enc_out``: the encoder output an xdec slot
    cross-attends. Under ``rt.mesh`` (a ``ServingMesh``: an enc-dec
    model's encoder in a sharded serving engine, one data group of the
    train step's ``tp``) ``params`` holds one stack per shard and every
    slot runs tensor-parallel; x and the result stay on the first shard's
    device. A stack's leaves may be ``sharding.GatheredLeaf``s (the train
    step's FSDP): each period's weights are gathered where they are read,
    inside the period's checkpoint."""
    tp = rt.mesh is not None

    def run(j, i, x):
        if tp:
            sp = _shard_view([tree_index(p["slots"][j], i) for p in params])
        else:
            sp = tree_index(params["slots"][j], i)
        x, _, a = _slot_apply(cfg.pattern[j], sp, x, positions, cfg, rt,
                              mode="train", enc_out=enc_out, causal=causal,
                              tp=tp)
        return x, a
    return _train_periods(cfg, rt, run, x)


def stack_apply_rows(stacks: list, xs: list, positions: list,
                     cfg: ArchConfig, rt: Runtime, enc_outs=None,
                     causal: bool = True, members=None):
    """The train-mode stack over the rows of several devices (the train
    step's ``fsdp``): device k runs its rows ``xs[k]`` through its own
    copy of the weights (``stacks[k]``, ``GatheredLeaf``s that gather
    each period where it is read) and ``positions[k]`` (and
    ``enc_outs[k]``); a MoE layer, whose routing, capacity and aux loss
    the reference takes over every token of the global batch, joins the
    rows of every device in device order on the first, dispatches them
    once and hands each device its rows back. Checkpointed under
    ``rt.remat`` as ``stack_apply``. ``members``: the mesh devices that
    run rows, one per entry of ``xs`` by default; under ``rt.live`` the
    entries are the live members' only, the MoE's join takes stand-ins
    of the others' rows, and the MoE runs where the first member is
    live. Returns (each device's rows, aux) with aux on the first
    device."""
    members = list(range(len(xs)) if members is None else members)
    ids = [k for k in members if rt.live is None or k in rt.live]
    first = ids[0] == members[0]

    def run(j, i, xs):
        mixer, ffn = _parse_slot(cfg.pattern[j])
        sps = [_index_slot(s["slots"][j], i, moe=k == 0 and first)
               for k, s in enumerate(stacks)]
        xs = [_mixer_apply(mixer, sp, x, pos, cfg, rt, mode="train",
                           cache=None, pos=None, causal=causal,
                           enc_out=None if enc_outs is None else enc_outs[k],
                           paged_ctx=None, fused=False, tp=False)[0]
              for k, (sp, x, pos) in enumerate(zip(sps, xs, positions))]
        if ffn != "moe":
            outs = [_ffn_apply(ffn, sp, x, cfg, rt) for sp, x in zip(sps, xs)]
            return [o[0] for o in outs], outs[0][1]
        dev0 = xs[0].device
        hs = dict(zip(ids, (norm_apply(cfg.norm, sp["norm2"], x)
                            for sp, x in zip(sps, xs))))
        like = hs[ids[0]]
        parts = [hs[k] if k in hs else collectives.stand_in(like)
                 for k in members]
        h = collectives.all_gather(parts, 0, dev0, members, rt.live)
        if first:
            y, aux = moe_apply(sps[0]["moe"], h, top_k=cfg.top_k,
                               n_experts=cfg.n_experts,
                               capacity_factor=cfg.capacity_factor, rt=rt)
        else:
            # the first member's MoE: run in its own class
            y = collectives.StandInOf.apply(h)
            aux = collectives.stand_in(h.new_empty((), dtype=torch.float32))
        out, lo, xs_by = [], 0, dict(zip(ids, xs))
        for k, part in zip(members, parts):
            if k in xs_by:
                x = xs_by[k]
                out.append(x + y[lo:lo + x.shape[0]].to(x.device))
            lo += part.shape[0]
        return out, aux
    return _train_periods(cfg, rt, run, xs)


def _index_slot(slot_params: dict, i: int, *, moe: bool) -> dict:
    """Period ``i`` of one slot's params; the MoE's only with ``moe``
    (the rows' MoE runs on the first device)."""
    return {k: tree_index(v, i) for k, v in slot_params.items()
            if moe or k != "moe"}


def stack_prefill(params, x: torch.Tensor, positions, cfg: ArchConfig,
                  rt: Runtime, caches, enc_out=None):
    """Prefill: the train-mode forward that also writes each slot's
    serving state into the pre-allocated dense ``caches`` (in place): the
    K/V prefix of attention slots, the final state of recurrent ones, the
    projected encoder K/V of xdec slots. Under ``rt.mesh`` (one data
    group of the serve steps) ``params`` and ``caches`` hold one stack and
    one cache block tree per model shard and every slot runs
    tensor-parallel (``_attn_mesh``, ``_cross_mesh``, the sharded FFN and
    MoE, recurrent mixers whole); x stays on the first shard's device.
    Returns (x, caches, aux)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    tp = rt.mesh is not None
    periods = (_tp_periods(params, cfg, caches) if tp
               else _periods(params, cfg, caches))
    for slot, sp, cache in periods:
        x, _, a = _slot_apply(slot, sp, x, positions, cfg, rt,
                              mode="prefill", cache=cache, enc_out=enc_out,
                              tp=tp)
        aux = aux + a
    return x, caches, aux


def stack_decode(params, x: torch.Tensor, pos, cfg: ArchConfig,
                 rt: Runtime, caches):
    """One-token decode through all periods, writing the caches in place
    (tensor-parallel over ``rt.mesh`` as ``stack_prefill``). Returns (x,
    caches)."""
    tp = rt.mesh is not None
    periods = (_tp_periods(params, cfg, caches) if tp
               else _periods(params, cfg, caches))
    for slot, sp, cache in periods:
        x, _, _ = _slot_apply(slot, sp, x, None, cfg, rt, mode="decode",
                              cache=cache, pos=pos, tp=tp)
    return x, caches


def _slab_rows(cfg: ArchConfig, caches, n_valid, state_idx):
    """Rows whose slab a paged step writes: n_valid > 0 and a slab index
    below the sentinel. None for patterns without a slab region."""
    for slot, cache in zip(cfg.pattern, caches):
        if _parse_slot(slot)[0] in SLAB_MIXERS:
            n_slabs = next(iter(cache.values())).shape[1]
            live = (n_valid > 0) & (state_idx[:, 0] < n_slabs)
            return torch.nonzero(live).squeeze(1)
    return None


def stack_paged(params, x: torch.Tensor, ctx_len, block_table, n_valid,
                state_idx, cfg: ArchConfig, rt: Runtime, caches, *,
                fused: bool = False):
    """C-token step through every period against the state cache —
    chunked prefill (C > 1) and decode (C == 1) share this path. x:
    (B, C, D); ctx_len/n_valid: (B,); block_table: (B, max_pages);
    state_idx: (B, 2) — column 0 each row's slab (the out-of-range
    sentinel ``n_slabs`` for rows without one), column 1 its cross entry
    (the sentinel ``n_cross`` for rows without one; all-sentinel for
    decoder-only patterns). ``caches``: per slot, {"kp", "vp"} pools of
    attention slots (tensors or quantized {"codes", "scale"} dicts), plus
    the read-only {"xk", "xv"} cross region of xdec slots, or the slab
    leaves of recurrent ones, stacked over periods, written in place.
    ``fused`` routes every attention through the ragged decode kernel.

    Under ``rt.mesh`` (tensor-parallel) ``params`` and ``caches`` hold one
    stack and one paged state cache per shard (``sharding.shard_params``,
    ``shard_paged_state``). The residual stream stays on the first shard's
    device; each sublayer's normed input is handed to every shard and the
    shards' partial outputs come back summed in shard order: attention
    and cross-attention by heads (``attn_paged_step_sharded``), the dense
    FFN by columns (``mlp_apply_sharded``), the MoE by experts
    (``moe_apply_sharded``); a recurrent mixer runs whole on every shard
    against its own copy of the slabs, and shard 0's output joins the
    stream (``_recurrent_sharded``). The block table, the token batch and
    the state indices are replicated: each shard gets its own copy once
    per call. Returns (x, caches)."""
    if rt.mesh is None:
        ctx = (ctx_len, block_table, n_valid, state_idx,
               _slab_rows(cfg, caches, n_valid, state_idx))
        for slot, sp, cache in _periods(params, cfg, caches):
            x, _, _ = _slot_apply(slot, sp, x, None, cfg, rt, mode="paged",
                                  cache=cache, paged_ctx=ctx, fused=fused)
        return x, caches
    ctx = tuple([t.to(d) for d in rt.mesh.devices]
                for t in (ctx_len, block_table, n_valid, state_idx))
    ctx += ([_slab_rows(cfg, c, nv, si)
             for c, nv, si in zip(caches, ctx[2], ctx[3])],)
    for slot, sp, cache in _tp_periods(params, cfg, caches):
        x, _, _ = _slot_apply(slot, sp, x, None, cfg, rt, mode="paged",
                              cache=cache, paged_ctx=ctx, fused=fused,
                              tp=True)
    return x, caches


def _kv_leaf(shape, kv_quant: bool, dtype, device):
    """One K or V cache leaf of ``shape`` (..., dh): zeros, or uint8 zero
    codes with f32 unit scales (..., 1) when quantized."""
    if kv_quant:
        return {"codes": torch.zeros(shape, dtype=torch.uint8, device=device),
                "scale": torch.ones(shape[:-1] + (1,), dtype=torch.float32,
                                    device=device)}
    return torch.zeros(shape, dtype=dtype, device=device)


def _state_leaves(mixer: str, cfg: ArchConfig, lead: tuple, dtype,
                  device) -> dict:
    """Zero recurrent state of one mixer with leading dims ``lead``: the
    scan and cell states in f32, the conv windows in ``dtype``."""
    f32 = dict(dtype=torch.float32, device=device)
    di = cfg.ssm_expand * cfg.d_model
    conv = (cfg.ssm_d_conv - 1, di)
    if mixer == "mamba":
        return {"h": torch.zeros(lead + (di, cfg.ssm_d_state), **f32),
                "conv": torch.zeros(lead + conv, dtype=dtype, device=device)}
    nh = cfg.lstm_heads
    if mixer == "mlstm":
        dh = di // nh
        return {"C": torch.zeros(lead + (nh, dh, dh), **f32),
                "n": torch.zeros(lead + (nh, dh), **f32),
                "m": torch.zeros(lead + (nh,), **f32),
                "conv": torch.zeros(lead + conv, dtype=dtype, device=device)}
    dh = cfg.d_model // nh
    return {k: torch.zeros(lead + (nh, dh), **f32)
            for k in ("c", "n", "m", "h")}


def slot_init_cache(slot: str, cfg: ArchConfig, batch: int, max_seq: int,
                    dtype=torch.float32, kv_quant: bool = False,
                    device="cpu") -> dict:
    """Dense serving state of one slot, stacked over periods: for
    attention {"k", "v"} each (P, batch, Hkv, max_seq, dh), or, when
    ``kv_quant``, {"codes" uint8, "scale" f32 (..., 1)} dicts (codes under
    ``Runtime.kv_scheme``); an xdec slot adds the cross K/V {"xk", "xv"}
    each (P, batch, Hkv, enc_seq_len, dh) in ``dtype``; for a recurrent
    mixer its state leaves (P, batch, ...)."""
    mixer, _ = _parse_slot(slot)
    if mixer in SLAB_MIXERS:
        return _state_leaves(mixer, cfg, (cfg.n_periods, batch), dtype,
                             device)
    shape = (cfg.n_periods, batch, cfg.n_kv_heads, max_seq, cfg.dh)
    cache = {"k": _kv_leaf(shape, kv_quant, dtype, device),
             "v": _kv_leaf(shape, kv_quant, dtype, device)}
    if mixer == "xdec":
        cache.update(_cross_leaves(cfg, batch, dtype, device))
    return cache


def _cross_leaves(cfg: ArchConfig, n: int, dtype, device) -> dict:
    """Zero cross K/V {"xk", "xv"}, each (P, n, Hkv, enc_seq_len, dh)."""
    shape = (cfg.n_periods, n, cfg.n_kv_heads, cfg.enc_seq_len, cfg.dh)
    return {k: torch.zeros(shape, dtype=dtype, device=device)
            for k in ("xk", "xv")}


def slot_init_paged_cache(slot: str, cfg: ArchConfig, n_pages: int,
                          page_size: int, dtype=torch.float32,
                          kv_quant: bool = False, n_slabs: int = 0,
                          n_cross: int = 0, device="cpu") -> dict:
    """One slot's state-cache region, stacked over periods (axis 0) with
    the shared pool axis at axis 1: K/V page pools {"kp", "vp"} each
    (P, n_pages, Hkv, page_size, dh) for attention (quantized dicts as in
    ``slot_init_cache``); an xdec slot adds the read-only cross region
    {"xk", "xv"} each (P, n_cross, Hkv, enc_seq_len, dh) in ``dtype``, one
    entry per distinct encoder input, shared across sequences; a
    recurrent mixer has the slab region, its state leaves (P, n_slabs,
    ...)."""
    mixer, _ = _parse_slot(slot)
    if mixer in SLAB_MIXERS:
        return _state_leaves(mixer, cfg, (cfg.n_periods, n_slabs), dtype,
                             device)
    shape = (cfg.n_periods, n_pages, cfg.n_kv_heads, page_size, cfg.dh)
    cache = {"kp": _kv_leaf(shape, kv_quant, dtype, device),
             "vp": _kv_leaf(shape, kv_quant, dtype, device)}
    if mixer == "xdec":
        cache.update(_cross_leaves(cfg, n_cross, dtype, device))
    return cache
