"""Block assembly and the loop over periods.

An architecture is a repeating *pattern* of slots (ArchConfig.pattern).
Parameters for each slot are stacked over periods (leading P dim), as in
the reference; the reference's ``lax.scan`` over periods becomes a Python
loop that slices period ``i`` out of every leaf (caches included: their
slices are views, written in place). One slot dispatcher serves four
modes: ``train`` (full-sequence forward), ``prefill`` (forward that writes
the prompt's K/V into a dense per-slot cache), ``decode`` (one token
against that cache) and ``paged`` (serving over the page pools). This port
runs the ``attn+dense`` slot; other slot kinds raise.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.runtime import Runtime

from .attention import (attn_apply_dense, attn_decode_step, attn_init,
                        attn_paged_step, quantize_kv)
from .layers import norm_apply, norm_init, tree_index
from .mlp import mlp_apply, mlp_init

__all__ = ["stack_init", "stack_apply", "stack_prefill", "stack_decode",
           "stack_paged", "slot_init_cache", "slot_init_paged_cache",
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


def _slot_apply(slot: str, p: dict, x, positions, cfg: ArchConfig,
                rt: Runtime, *, mode: str, cache=None, pos=None,
                causal: bool = True, paged_ctx=None, fused: bool = False):
    """One slot (the reference's ``_slot_apply``). mode: 'train' |
    'prefill' | 'decode' | 'paged'. Paged mode takes ``paged_ctx =
    (ctx_len, block_table, n_valid)``. Returns (x, cache)."""
    _check_slot(slot)
    heads = dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                 head_dim=cfg.dh, rope_theta=cfg.rope_theta,
                 mrope_sections=cfg.mrope_sections, rt=rt)
    h = norm_apply(cfg.norm, p["norm1"], x)
    if mode == "paged":
        ctx_len, block_table, n_valid = paged_ctx
        y, cache = attn_paged_step(p["attn"], h, ctx_len, block_table, cache,
                                   n_valid=n_valid, fused=fused, **heads)
    elif mode == "decode":
        y, (k, v) = attn_decode_step(p["attn"], h, pos,
                                     (cache["k"], cache["v"]), **heads)
        cache = dict(cache, k=k, v=v)
    elif mode == "prefill":
        y, (k, v) = attn_apply_dense(p["attn"], h, positions, causal=causal,
                                     kv_out=True, **heads)
        # (B, S, Hkv, dh) -> the cache's (B, Hkv, S, dh) layout
        _write_prefix(cache["k"], k.transpose(1, 2), rt)
        _write_prefix(cache["v"], v.transpose(1, 2), rt)
    else:
        y = attn_apply_dense(p["attn"], h, positions, causal=causal, **heads)
    x = x + y
    h = norm_apply(cfg.norm, p["norm2"], x)
    x = x + mlp_apply(p["mlp"], h, variant=cfg.mlp_variant, act=cfg.act,
                      rt=rt)
    return x, cache


def _periods(params: dict, cfg: ArchConfig, caches=None):
    """(slot kind, params, cache) of every (period, slot) in execution
    order; the cache slices are views of ``caches``."""
    for i in range(cfg.n_periods):
        for j, slot in enumerate(cfg.pattern):
            yield (slot, tree_index(params["slots"][j], i),
                   None if caches is None else tree_index(caches[j], i))


def stack_apply(params: dict, x: torch.Tensor, positions, cfg: ArchConfig,
                rt: Runtime, causal: bool = True):
    """Train-mode stack (forward only). Returns (x, aux) with aux the
    reference's auxiliary-loss sum, 0 for ``attn+dense``."""
    for slot, sp, _ in _periods(params, cfg):
        x, _ = _slot_apply(slot, sp, x, positions, cfg, rt, mode="train",
                           causal=causal)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def stack_prefill(params: dict, x: torch.Tensor, positions, cfg: ArchConfig,
                  rt: Runtime, caches):
    """Prefill: the train-mode forward that also writes each layer's K/V
    prefix into the pre-allocated dense ``caches`` (in place). Returns
    (x, caches, aux)."""
    for slot, sp, cache in _periods(params, cfg, caches):
        x, _ = _slot_apply(slot, sp, x, positions, cfg, rt, mode="prefill",
                           cache=cache)
    return x, caches, torch.zeros((), dtype=torch.float32, device=x.device)


def stack_decode(params: dict, x: torch.Tensor, pos, cfg: ArchConfig,
                 rt: Runtime, caches):
    """One-token decode through all periods, writing the caches in place.
    Returns (x, caches)."""
    for slot, sp, cache in _periods(params, cfg, caches):
        x, _ = _slot_apply(slot, sp, x, None, cfg, rt, mode="decode",
                           cache=cache, pos=pos)
    return x, caches


def stack_paged(params: dict, x: torch.Tensor, ctx_len, block_table,
                n_valid, cfg: ArchConfig, rt: Runtime, caches, *,
                fused: bool = False):
    """C-token step through every period against the paged pools —
    chunked prefill (C > 1) and decode (C == 1) share this path. x:
    (B, C, D); ctx_len/n_valid: (B,); block_table: (B, max_pages).
    ``caches``: per-slot {"kp", "vp"} pools (tensors or quantized
    {"codes", "scale"} dicts) stacked over periods, written in place.
    ``fused`` routes every attention through the ragged decode kernel.
    Returns (x, caches)."""
    for slot, sp, cache in _periods(params, cfg, caches):
        x, _ = _slot_apply(slot, sp, x, None, cfg, rt, mode="paged",
                           cache=cache, paged_ctx=(ctx_len, block_table,
                                                   n_valid), fused=fused)
    return x, caches


def _kv_leaf(shape, kv_quant: bool, dtype, device):
    """One K or V cache leaf of ``shape`` (..., dh): zeros, or uint8 zero
    codes with f32 unit scales (..., 1) when quantized."""
    if kv_quant:
        return {"codes": torch.zeros(shape, dtype=torch.uint8, device=device),
                "scale": torch.ones(shape[:-1] + (1,), dtype=torch.float32,
                                    device=device)}
    return torch.zeros(shape, dtype=dtype, device=device)


def slot_init_cache(slot: str, cfg: ArchConfig, batch: int, max_seq: int,
                    dtype=torch.float32, kv_quant: bool = False,
                    device="cpu") -> dict:
    """Dense per-slot K/V cache for one slot, stacked over periods:
    {"k", "v"} each (P, batch, Hkv, max_seq, dh), or, when ``kv_quant``,
    {"codes" uint8, "scale" f32 (..., 1)} dicts (codes interpreted under
    ``Runtime.kv_scheme``; ``dtype`` is ignored for them)."""
    _check_slot(slot)
    shape = (cfg.n_periods, batch, cfg.n_kv_heads, max_seq, cfg.dh)
    return {"k": _kv_leaf(shape, kv_quant, dtype, device),
            "v": _kv_leaf(shape, kv_quant, dtype, device)}


def slot_init_paged_cache(slot: str, cfg: ArchConfig, n_pages: int,
                          page_size: int, dtype=torch.float32,
                          kv_quant: bool = False, device="cpu") -> dict:
    """K/V page pools for one slot, stacked over periods: {"kp", "vp"}
    each (P, n_pages, Hkv, page_size, dh), or quantized dicts as in
    ``slot_init_cache``."""
    _check_slot(slot)
    shape = (cfg.n_periods, n_pages, cfg.n_kv_heads, page_size, cfg.dh)
    return {"kp": _kv_leaf(shape, kv_quant, dtype, device),
            "vp": _kv_leaf(shape, kv_quant, dtype, device)}
