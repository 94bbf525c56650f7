"""Block assembly and the loop over periods, for the paged serving path.

An architecture is a repeating *pattern* of slots (ArchConfig.pattern).
Parameters for each slot are stacked over periods (leading P dim), as in
the reference; the reference's ``lax.scan`` over periods becomes a Python
loop that slices period ``i`` out of every leaf. This port serves the
``attn+dense`` slot; other slot kinds raise.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.runtime import Runtime

from .attention import attn_init, attn_paged_step
from .layers import norm_apply, norm_init, tree_index
from .mlp import mlp_apply, mlp_init

__all__ = ["stack_init", "stack_paged", "slot_init_paged_cache",
           "SUPPORTED_SLOTS"]

#: slot kinds this port serves
SUPPORTED_SLOTS = ("attn+dense",)


def _check_slot(slot: str) -> None:
    if slot not in SUPPORTED_SLOTS:
        raise NotImplementedError(
            f"slot {slot!r} is not ported yet (this port serves "
            f"{SUPPORTED_SLOTS}; ROADMAP.md: the other architecture "
            "families)")


def _slot_init(gen: torch.Generator, slot: str, cfg: ArchConfig, dtype,
               device) -> dict:
    _check_slot(slot)
    d = cfg.d_model
    return {
        "norm1": norm_init(cfg.norm, d, dtype, device),
        "attn": attn_init(gen, d, cfg.n_heads, cfg.n_kv_heads, cfg.dh,
                          qkv_bias=cfg.qkv_bias, dtype=dtype, device=device),
        "norm2": norm_init(cfg.norm, d, dtype, device),
        "mlp": mlp_init(gen, d, cfg.d_ff, variant=cfg.mlp_variant,
                        act=cfg.act, dtype=dtype, device=device),
    }


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


def _slot_apply(slot: str, p: dict, x, cfg: ArchConfig, rt: Runtime,
                cache: dict, paged_ctx, fused: bool):
    """One slot in paged mode (the reference's ``_slot_apply`` with
    ``mode='paged'``). paged_ctx = (ctx_len, block_table, n_valid)."""
    _check_slot(slot)
    ctx_len, block_table, n_valid = paged_ctx
    h = norm_apply(cfg.norm, p["norm1"], x)
    y, new_cache = attn_paged_step(
        p["attn"], h, ctx_len, block_table, cache, n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads, head_dim=cfg.dh, n_valid=n_valid,
        rope_theta=cfg.rope_theta, mrope_sections=cfg.mrope_sections, rt=rt,
        fused=fused)
    x = x + y
    h = norm_apply(cfg.norm, p["norm2"], x)
    x = x + mlp_apply(p["mlp"], h, variant=cfg.mlp_variant, act=cfg.act,
                      rt=rt)
    return x, new_cache


def stack_paged(params: dict, x: torch.Tensor, ctx_len, block_table,
                n_valid, cfg: ArchConfig, rt: Runtime, caches, *,
                fused: bool = False):
    """C-token step through every period against the paged pools —
    chunked prefill (C > 1) and decode (C == 1) share this path. x:
    (B, C, D); ctx_len/n_valid: (B,); block_table: (B, max_pages).
    ``caches``: per-slot {"kp", "vp"} pools stacked over periods, written
    in place. ``fused`` routes every attention through the ragged decode
    kernel. Returns (x, caches)."""
    for i in range(cfg.n_periods):
        for j, slot in enumerate(cfg.pattern):
            layer_cache = {k: caches[j][k][i] for k in ("kp", "vp")}
            x, _ = _slot_apply(slot, tree_index(params["slots"][j], i), x,
                               cfg, rt, layer_cache,
                               (ctx_len, block_table, n_valid), fused)
    return x, caches


def slot_init_paged_cache(slot: str, cfg: ArchConfig, n_pages: int,
                          page_size: int, dtype=torch.float32,
                          device="cpu") -> dict:
    """K/V page pools for one slot, stacked over periods:
    {"kp", "vp"} each (P, n_pages, Hkv, page_size, dh)."""
    _check_slot(slot)
    shape = (cfg.n_periods, n_pages, cfg.n_kv_heads, page_size, cfg.dh)
    return {"kp": torch.zeros(shape, dtype=dtype, device=device),
            "vp": torch.zeros(shape, dtype=dtype, device=device)}
