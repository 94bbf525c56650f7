"""Encoder-decoder backbone (whisper-small). The audio frontend is a stub,
as in the reference: inputs are precomputed frame embeddings (B,
enc_seq_len, D). The encoder is an ``attn+dense`` stack run non-causally;
the decoder an ``xdec+dense`` stack whose cross-attention reads the
encoder's output, projected per layer.

Serving keeps the encoder out of the decoder's state: the dense layout
caches each slot's projected cross K/V at prefill (``xk``/``xv`` of the
dense caches), the paged layout projects the encoder output once per
distinct input (``encdec_cross_kv``) into an entry of the state cache's
shared cross region (``models.lm.paged_fill_cross``), which every paged
step reads through ``state_idx[:, 1]``. Caches are updated in place; the
step functions still return them so callers read like the reference.

Under ``Runtime.mesh`` the paged functions take one param tree and one
state cache per shard, as ``models.lm``'s do: the encoder runs
tensor-parallel, each shard projects the cross K/V of its own KV heads
into its head-sharded cross region, and the decoder's paged step is
``lm._paged_forward`` over ``dec_stack``, with the head over the shards'
slices of it. The serve steps' context-parallel prefill
(``_cp_prefill``) cuts the frames and the prompt into row blocks, one a
shard, each sequence apart (whole on the first shard where its length
does not divide the shards), and gathers the cross K/V of the encoder's
blocks for every decoder block.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.nn.layers import (dense_init, embedding_apply,
                                   embedding_init, norm_apply, norm_init,
                                   sharded_embedding_apply, tree_index)
from repro_torch.nn.transformer import (_cross_kv, cp_blocks,
                                        slot_init_cache,
                                        slot_init_paged_cache, stack_apply,
                                        stack_apply_rows,
                                        stack_decode, stack_init,
                                        stack_prefill, stack_prefill_cp)
from repro_torch.runtime import Runtime, resolve_device
from repro_torch.sharding import whole

from .lm import (Z_WEIGHT, _default_positions, _paged_forward, _paged_head,
                 chunked_ce, mesh_apply, mesh_embed, mesh_head_w, mesh_loss)

__all__ = ["encdec_init", "encdec_loss", "encdec_encode", "encdec_prefill",
           "encdec_decode_step", "encdec_init_caches", "enc_cfg", "dec_cfg",
           "encdec_paged_init_caches", "encdec_cross_kv",
           "encdec_paged_step", "encdec_paged_verify",
           "encdec_paged_fused_step"]


def enc_cfg(cfg: ArchConfig) -> ArchConfig:
    return dataclasses.replace(cfg, pattern=("attn+dense",),
                               n_layers=cfg.n_enc_layers)


def dec_cfg(cfg: ArchConfig) -> ArchConfig:
    return dataclasses.replace(cfg, pattern=("xdec+dense",))


def encdec_init(gen: torch.Generator, cfg: ArchConfig, dtype=torch.float32,
                device=None) -> dict:
    """Random params drawn from ``gen``, on ``device`` (``cuda`` unless the
    caller asks for another; raises without a card). ``gen`` must live on
    that device. The reference's ``jax.random`` draws cannot be
    reproduced: tests carry JAX-made weights over (``interop``)."""
    device = resolve_device(device)
    return {
        "embed": embedding_init(gen, cfg.vocab_size, cfg.d_model,
                                dtype=dtype, device=device),
        "enc_stack": stack_init(gen, enc_cfg(cfg), dtype=dtype,
                                device=device),
        "enc_norm": norm_init(cfg.norm, cfg.d_model, dtype, device),
        "dec_stack": stack_init(gen, dec_cfg(cfg), dtype=dtype,
                                device=device),
        "final_norm": norm_init(cfg.norm, cfg.d_model, dtype, device),
        "head": dense_init(gen, cfg.d_model, cfg.vocab_size, dtype=dtype,
                           device=device),
    }


def _logits(params, h: torch.Tensor) -> torch.Tensor:
    """The untied head: a plain product outside any kernel."""
    return torch.matmul(h, params["head"]["w"].to(h.dtype))


def encdec_encode(params, frames: torch.Tensor, cfg: ArchConfig,
                  rt: Runtime) -> torch.Tensor:
    """frames (B, S_enc, D) -> the encoder output (B, S_enc, D): roped
    self-attention over every frame, not causal. Under ``rt.mesh``
    ``params`` holds one tree per shard and the encoder stack runs
    tensor-parallel (``stack_apply``); the output is on the first
    shard's device."""
    b, s, _ = frames.shape
    pos = torch.arange(s, device=frames.device).expand(b, s)
    if rt.mesh is None:
        stack, norm = params["enc_stack"], params["enc_norm"]
    else:
        stack = [p["enc_stack"] for p in params]
        norm = whole(params[0]["enc_norm"])
        frames = frames.to(rt.mesh.devices[0])
        pos = pos.to(frames.device)
    h, _ = stack_apply(stack, frames, pos, enc_cfg(cfg), rt, causal=False)
    return norm_apply(cfg.norm, norm, h)


def encdec_loss(params, batch: dict, cfg: ArchConfig, rt: Runtime):
    """batch: {"frames": (B, S_enc, D), "tokens": (B, S), "labels":
    (B, S)}. Returns (scalar loss, {"ce", "z"}): cross-entropy plus
    ``Z_WEIGHT`` x the z-loss. Under ``rt.mesh`` as ``lm.lm_loss``: a
    ``ServingMesh`` runs encoder and decoder tensor-parallel over its
    shards, a ``HostMesh`` is the train step's (``lm.mesh_loss``)."""
    if rt.mesh is not None and hasattr(rt.mesh, "grid"):
        return mesh_loss(params, batch, cfg, rt, rows=_encdec_rows,
                         group_loss=encdec_loss)
    enc_out = encdec_encode(params, batch["frames"], cfg, rt)
    tokens = batch["tokens"].to(enc_out.device)
    pos = _default_positions(cfg, *tokens.shape, tokens.device)
    if rt.mesh is None:
        x = embedding_apply(params["embed"], tokens)
        stack, norm, w = (params["dec_stack"], params["final_norm"],
                          params["head"]["w"])
    else:
        x = sharded_embedding_apply([whole(p["embed"]) for p in params],
                                    tokens, rt.mesh, cfg.vocab_size)
        stack = [p["dec_stack"] for p in params]
        norm = whole(params[0]["final_norm"])
        w = mesh_head_w([whole(p["head"]["w"]) for p in params], rt.mesh,
                        cfg.d_model)
    h, _ = stack_apply(stack, x, pos, dec_cfg(cfg), rt, enc_out=enc_out)
    h = norm_apply(cfg.norm, norm, h)
    ce, z = chunked_ce(h, w, batch["labels"].to(h.device))
    return ce + Z_WEIGHT * z, {"ce": ce, "z": z}


def _encdec_rows(views: list, batches: list, cfg: ArchConfig, rt: Runtime,
                 members=None):
    """The encoder-decoder's rows over several devices (``mesh_loss``'s
    fsdp): each device encodes its rows' frames and decodes its rows;
    each device's (ce, z) means, and no aux loss (``members``:
    ``stack_apply_rows``')."""
    def pos(t):
        b, s = t.shape[:2]
        return torch.arange(s, device=t.device).expand(b, s)
    frames = [b["frames"] for b in batches]
    hs, _ = stack_apply_rows([v["enc_stack"] for v in views], frames,
                             [pos(f) for f in frames], enc_cfg(cfg), rt,
                             causal=False, members=members)
    enc_outs = [norm_apply(cfg.norm, whole(v["enc_norm"]), h)
                for v, h in zip(views, hs)]
    xs = [embedding_apply(whole(v["embed"]), b["tokens"])
          for v, b in zip(views, batches)]
    hs, _ = stack_apply_rows([v["dec_stack"] for v in views], xs,
                             [pos(b["tokens"]) for b in batches],
                             dec_cfg(cfg), rt, enc_outs=enc_outs,
                             members=members)
    return [chunked_ce(norm_apply(cfg.norm, whole(v["final_norm"]), h),
                       whole(v["head"]["w"]), b["labels"])
            for v, h, b in zip(views, hs, batches)], None


# -- dense serving ------------------------------------------------------------

def encdec_init_caches(cfg: ArchConfig, batch: int, max_seq: int,
                       dtype=torch.bfloat16, kv_quant: bool = False,
                       device=None) -> list:
    """The decoder's dense per-slot caches: self-attention K/V and the
    cross K/V of every xdec slot, on ``device`` (``cuda`` unless the
    caller asks for another)."""
    device = resolve_device(device)
    dcfg = dec_cfg(cfg)
    return [slot_init_cache(slot, dcfg, batch, max_seq, dtype,
                            kv_quant=kv_quant, device=device)
            for slot in dcfg.pattern]


def encdec_prefill(params, frames, tokens, caches, cfg: ArchConfig,
                   rt: Runtime):
    """Encode ``frames`` and run the decoder prompt ``tokens`` (B, S),
    writing the self-attention prefix and the cross K/V into ``caches``
    in place. Returns the last position's logits (B, V) and the caches.
    Under ``rt.mesh`` (a ``HostMesh``, ``launch.steps``) per data group
    (``lm.mesh_apply``), encoder and decoder tensor-parallel over its
    model shards, or context-parallel under ``rt.attn_cp``
    (``_cp_prefill``), ``params``/``caches`` ``grid[d][m]`` trees."""
    if rt.mesh is not None:
        return _mesh_step(params, tokens, caches, cfg, rt, frames=frames)
    enc_out = encdec_encode(params, frames, cfg, rt)
    pos = _default_positions(cfg, *tokens.shape, tokens.device)
    x = embedding_apply(params["embed"], tokens)
    h, caches, _ = stack_prefill(params["dec_stack"], x, pos, dec_cfg(cfg),
                                 rt, caches, enc_out=enc_out)
    h = norm_apply(cfg.norm, params["final_norm"], h[:, -1:])
    return _logits(params, h[:, 0]), caches


def encdec_decode_step(params, token, pos, caches, cfg: ArchConfig,
                       rt: Runtime):
    """One decode step of the decoder against the dense caches (cross K/V
    read from them). token: (B,); pos: scalar or (B,). Returns (logits
    (B, V), caches). Under ``rt.mesh`` as ``encdec_prefill``."""
    if rt.mesh is not None:
        return _mesh_step(params, token[:, None], caches, cfg, rt, pos=pos)
    x = embedding_apply(params["embed"], token[:, None])
    h, caches = stack_decode(params["dec_stack"], x, pos, dec_cfg(cfg), rt,
                             caches)
    h = norm_apply(cfg.norm, params["final_norm"], h)
    return _logits(params, h[:, 0]), caches


def _mesh_step(params, tokens, caches, cfg: ArchConfig, rt: Runtime, *,
               frames=None, pos=None):
    """The serve steps' prefill (``frames`` given) or decode (``pos``)
    over each data group's model shards."""
    dcfg = dec_cfg(cfg)
    pos = None if pos is None else torch.as_tensor(pos)

    def body(ps, tok, rows, rt_d, c):
        if frames is not None and rt_d.attn_cp:
            return _cp_prefill(ps, tok, frames[rows], c, cfg, rt_d)
        x = mesh_embed(ps, tok, cfg, rt_d)
        stack = [p["dec_stack"] for p in ps]
        if frames is None:
            h, _ = stack_decode(stack, x, (pos[rows] if pos.ndim else pos)
                                .to(x.device), dcfg, rt_d, c)
            return h, slice(None)
        enc_out = encdec_encode(ps, frames[rows].to(x.device), cfg, rt_d)
        h, _, _ = stack_prefill(
            stack, x, _default_positions(cfg, *tok.shape, x.device), dcfg,
            rt_d, c, enc_out=enc_out)
        return h[:, -1:], slice(None)
    return mesh_apply(params, tokens, caches, cfg, rt, body,
                      head_w=lambda p: p["head"]["w"])


def _cp_prefill(ps, tokens, frames, caches, cfg: ArchConfig, rt: Runtime):
    """One data group's context-parallel prefill (``rt.attn_cp``: every
    shard holds the whole weights). Shard m takes the frames of its row
    block of the encoder's sequence and the tokens of its block of the
    prompt (``cp_blocks``: [m S/n, (m + 1) S/n), or the whole sequence on
    the first shard where its length does not divide the shards), each
    with its positions; the encoder runs its blocks not causal, without
    a cache, and ``enc_norm`` each block; the decoder runs its blocks
    with the cross-attention over every encoder block
    (``stack_prefill_cp``). Returns (the last position's hidden rows
    (B, 1, D), the shard holding them, a slice)."""
    devs = rt.mesh.devices
    b, s_enc = frames.shape[:2]
    xs, pos = cp_blocks(frames, torch.arange(s_enc).expand(b, s_enc), devs)
    hs = stack_prefill_cp([p["enc_stack"] for p in ps], xs, pos,
                          enc_cfg(cfg), rt, causal=False)
    enc_outs = [norm_apply(cfg.norm, whole(p["enc_norm"]), h)
                for p, h in zip(ps, hs)]
    toks, pos = cp_blocks(tokens, _default_positions(
        cfg, *tokens.shape, tokens.device), devs)
    xs = [embedding_apply(whole(p["embed"]), t) for p, t in zip(ps, toks)]
    xs = stack_prefill_cp([p["dec_stack"] for p in ps], xs, pos,
                          dec_cfg(cfg), rt, caches, enc_outs=enc_outs)
    return xs[-1][:, -1:], slice(len(xs) - 1, len(xs))


# -- paged serving (the state cache) ------------------------------------------

def encdec_paged_init_caches(cfg: ArchConfig, n_pages: int, page_size: int,
                             dtype=torch.bfloat16, kv_quant: bool = False,
                             n_slabs: int = 0, n_cross: int = 0,
                             device=None) -> list:
    """The decoder's state-cache regions: token-paged self-attention K/V
    pools and ``n_cross`` read-only encoder-output entries per xdec slot
    (the encoder holds no serving state: its output is projected once per
    distinct input by ``encdec_cross_kv`` and shared)."""
    device = resolve_device(device)
    dcfg = dec_cfg(cfg)
    return [slot_init_paged_cache(slot, dcfg, n_pages, page_size, dtype,
                                  kv_quant=kv_quant, n_slabs=n_slabs,
                                  n_cross=n_cross, device=device)
            for slot in dcfg.pattern]


def _cross_entries(params, enc_out: torch.Tensor, cfg: ArchConfig,
                   rt: Runtime) -> list:
    """One tree's cross K/V of ``enc_out``: per decoder slot ``None`` or
    {"xk", "xv"} of the KV heads its ``wk``/``wv`` project."""
    dcfg = dec_cfg(cfg)
    out = []
    for j, slot in enumerate(dcfg.pattern):
        if slot.split("+")[0] != "xdec":
            out.append(None)
            continue
        p_x = params["dec_stack"]["slots"][j]["xattn"]
        hkv = p_x["wk"]["w"].shape[-1] // dcfg.dh
        ks, vs = [], []
        for i in range(dcfg.n_periods):
            k, v = _cross_kv(tree_index(p_x, i), enc_out, hkv, dcfg.dh, rt)
            # (B, S_enc, Hkv, dh) -> the cache layout (B, Hkv, S_enc, dh)
            ks.append(k.transpose(1, 2))
            vs.append(v.transpose(1, 2))
        out.append({"xk": torch.stack(ks), "xv": torch.stack(vs)})
    return out


def encdec_cross_kv(params, frames: torch.Tensor, cfg: ArchConfig,
                    rt: Runtime) -> list:
    """Run the encoder once and project its output through every decoder
    slot and period's cross-attention K/V: frames (B, S_enc, D) -> per
    slot ``None`` (not xdec) or {"xk", "xv"} each (P, B, Hkv, S_enc, dh),
    what ``lm.paged_fill_cross`` writes into a cross entry (B = 1 there).
    The reference's vmap over the stacked periods is a loop over them;
    every projection goes through ``dense_apply`` (``spx_matmul`` for SPx
    weights). Under ``rt.mesh``: one such list per shard, on its device,
    of the KV heads its cut of ``wk``/``wv`` holds (what its head-sharded
    cross region keeps)."""
    enc_out = encdec_encode(params, frames, cfg, rt)
    if rt.mesh is None:
        return _cross_entries(params, enc_out, cfg, rt)
    return [_cross_entries(p, enc_out.to(dev), cfg, rt)
            for p, dev in zip(params, rt.mesh.devices)]


def _paged(params, tokens, ctx_len, block_table, n_valid, state_idx, caches,
           cfg: ArchConfig, rt: Runtime, *, fused: bool = False):
    """The decoder over a paged chunk: (final-normed h (B, C, D),
    caches); one device, or the shards of ``rt.mesh``
    (``lm._paged_forward`` over ``dec_stack``)."""
    return _paged_forward(params, tokens, ctx_len, block_table, n_valid,
                          state_idx, caches, dec_cfg(cfg), rt, fused=fused,
                          stack="dec_stack")


def encdec_paged_step(params, tokens, ctx_len, block_table, n_valid,
                      state_idx, caches, cfg: ArchConfig, rt: Runtime):
    """Decoder twin of ``lm.lm_paged_step``: same contract, cross-attention
    reading the shared cross region through ``state_idx[:, 1]``. Returns
    (logits (B, V) at each row's last valid position, caches)."""
    h, caches = _paged(params, tokens, ctx_len, block_table, n_valid,
                       state_idx, caches, cfg, rt)
    last = torch.clamp(n_valid.long() - 1, 0, tokens.shape[1] - 1)
    h_last = h[torch.arange(h.shape[0], device=h.device), last.to(h.device)]
    return _paged_head(params, cfg, h_last, rt), caches


def encdec_paged_verify(params, tokens, ctx_len, block_table, n_valid,
                        state_idx, caches, cfg: ArchConfig, rt: Runtime):
    """Decoder twin of ``lm.lm_paged_verify``: logits at every window
    position, (B, C, V)."""
    h, caches = _paged(params, tokens, ctx_len, block_table, n_valid,
                       state_idx, caches, cfg, rt)
    return _paged_head(params, cfg, h, rt), caches


def encdec_paged_fused_step(params, tokens, ctx_len, block_table, n_valid,
                            state_idx, caches, cfg: ArchConfig,
                            rt: Runtime):
    """Decoder twin of ``lm.lm_paged_fused_step``: the self-attention of
    every layer is one ``paged_decode_ragged`` launch; the cross-attention
    runs the flash kernel over each row's cross entry (a dense per-entry
    block, not pages). Logits at every window position, (B, W, V)."""
    h, caches = _paged(params, tokens, ctx_len, block_table, n_valid,
                       state_idx, caches, cfg, rt, fused=True)
    return _paged_head(params, cfg, h, rt), caches
