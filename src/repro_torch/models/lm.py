"""Decoder-only language model: init, the full-sequence forward
(``lm_logits``), the dense serving path (``lm_prefill`` of a whole prompt
into per-slot caches, ``lm_decode_step``), the paged prefill/decode step,
the speculative verify window, the fused decode tick, and the page copies
the serving engine's copy-on-write and preemption use. Dense
(``attn+dense``) patterns only.

Caches and page pools (bf16 by default as in the reference, f32 when asked
for, or SPx codes + f32 scales when quantized) are updated in place; the
step functions still return ``(logits, caches)`` so callers read like the
reference.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.nn.layers import (dense_init, embedding_apply,
                                   embedding_init, norm_apply, norm_init,
                                   tree_leaves, tree_map)
from repro_torch.nn.transformer import (slot_init_cache,
                                        slot_init_paged_cache, stack_apply,
                                        stack_decode, stack_init,
                                        stack_paged, stack_prefill)
from repro_torch.runtime import Runtime, resolve_device

__all__ = ["lm_init", "lm_logits", "init_caches", "lm_prefill",
           "lm_decode_step", "paged_init_caches", "lm_paged_step",
           "lm_paged_verify", "lm_paged_fused_step", "paged_copy_page",
           "paged_gather_pages", "paged_scatter_pages"]

_PAGE_KEYS = ("kp", "vp")


def lm_init(gen: torch.Generator, cfg: ArchConfig, dtype=torch.float32,
            device=None) -> dict:
    """Random params drawn from ``gen``, on ``device`` (``cuda`` unless
    the caller asks for another; raises without a card). ``gen`` must
    live on that device."""
    device = resolve_device(device)
    p = {
        "embed": embedding_init(gen, cfg.vocab_size, cfg.d_model,
                                dtype=dtype, device=device),
        "stack": stack_init(gen, cfg, dtype=dtype, device=device),
        "final_norm": norm_init(cfg.norm, cfg.d_model, dtype, device),
    }
    if not cfg.tie_embeddings:
        p["head"] = dense_init(gen, cfg.d_model, cfg.vocab_size, dtype=dtype,
                               device=device)
    return p


def _head(params: dict, cfg: ArchConfig, h: torch.Tensor) -> torch.Tensor:
    """Vocabulary logits: the tied ``h @ table.T`` (or the untied head) —
    a plain product outside any kernel."""
    if cfg.tie_embeddings:
        return torch.matmul(h, params["embed"]["table"].to(h.dtype).T)
    return torch.matmul(h, params["head"]["w"].to(h.dtype))


def _default_positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, device=device).expand(b, s)


def _backbone(params, cfg: ArchConfig, tokens, positions, rt: Runtime):
    x = embedding_apply(params["embed"], tokens)
    h, aux = stack_apply(params["stack"], x, positions, cfg, rt)
    return norm_apply(cfg.norm, params["final_norm"], h), aux


def lm_logits(params, tokens, cfg: ArchConfig, rt: Runtime, positions=None):
    """Full-sequence logits (B, S, V) of tokens (B, S) (small-model and
    test use)."""
    if positions is None:
        positions = _default_positions(*tokens.shape, tokens.device)
    h, _ = _backbone(params, cfg, tokens, positions, rt)
    return _head(params, cfg, h)


# -- dense serving ------------------------------------------------------------

def init_caches(cfg: ArchConfig, batch: int, max_seq: int,
                dtype=torch.bfloat16, kv_quant: bool = False,
                device=None) -> list:
    """Dense per-slot K/V caches for every slot in the pattern, on
    ``device`` (``cuda`` unless the caller asks for another)."""
    device = resolve_device(device)
    return [slot_init_cache(slot, cfg, batch, max_seq, dtype,
                            kv_quant=kv_quant, device=device)
            for slot in cfg.pattern]


def lm_prefill(params, tokens, caches, cfg: ArchConfig, rt: Runtime,
               positions=None):
    """Run the prompt tokens (B, S) through the stack, write its K/V into
    positions [0, S) of ``caches`` (in place), and return the last
    position's logits (B, V) and the caches."""
    if positions is None:
        positions = _default_positions(*tokens.shape[:2], tokens.device)
    x = embedding_apply(params["embed"], tokens)
    h, caches, _ = stack_prefill(params["stack"], x, positions, cfg, rt,
                                 caches)
    h = norm_apply(cfg.norm, params["final_norm"], h[:, -1:])
    return _head(params, cfg, h[:, 0]), caches


def lm_decode_step(params, token, pos, caches, cfg: ArchConfig,
                   rt: Runtime):
    """One decode step. token: (B,) int; pos: scalar or (B,) write position
    (tokens already in each row's cache). Returns (logits (B, V),
    caches)."""
    x = embedding_apply(params["embed"], token[:, None])
    h, caches = stack_decode(params["stack"], x, pos, cfg, rt, caches)
    h = norm_apply(cfg.norm, params["final_norm"], h)
    return _head(params, cfg, h[:, 0]), caches


# -- paged serving ------------------------------------------------------------

def paged_init_caches(cfg: ArchConfig, n_pages: int, page_size: int,
                      dtype=torch.bfloat16, kv_quant: bool = False,
                      device=None) -> list:
    """K/V page pools for every slot in the pattern, on ``device``
    (``cuda`` unless the caller asks for another): values of ``dtype``
    (bf16 unless asked for f32), or codes + scale dicts when ``kv_quant``
    (scheme from ``Runtime.kv_scheme`` at step time)."""
    device = resolve_device(device)
    return [slot_init_paged_cache(slot, cfg, n_pages, page_size, dtype,
                                  kv_quant=kv_quant, device=device)
            for slot in cfg.pattern]


def lm_paged_step(params, tokens, ctx_len, block_table, n_valid, caches,
                  cfg: ArchConfig, rt: Runtime):
    """One paged engine step: the next C tokens of each sequence — a
    prefill chunk (C > 1) or a decode step (C == 1).

    tokens: (B, C) int (rows may be padded past ``n_valid``); ctx_len:
    (B,) tokens already in the pages; block_table: (B, max_pages);
    n_valid: (B,) valid tokens in this chunk (0 = inactive row). Returns
    (logits (B, V) at each row's last valid position, caches)."""
    x = embedding_apply(params["embed"], tokens)
    h, caches = stack_paged(params["stack"], x, ctx_len, block_table,
                            n_valid, cfg, rt, caches)
    h = norm_apply(cfg.norm, params["final_norm"], h)
    last = torch.clamp(n_valid.long() - 1, 0, tokens.shape[1] - 1)
    h_last = h[torch.arange(h.shape[0], device=h.device), last]
    return _head(params, cfg, h_last), caches


def lm_paged_verify(params, tokens, ctx_len, block_table, n_valid, caches,
                    cfg: ArchConfig, rt: Runtime):
    """Score a speculation window in one paged forward pass (the unfused
    verify step; serving/spec.py has the drafter). Same contract as
    ``lm_paged_step`` — tokens (B, C) is the pending token plus up to C-1
    drafts, padded past ``n_valid``, written to the pages and attended
    causally through the chunked page-gather path (or, at C == 1, through
    ``ops.paged_attention``: the unfused decode tick) — but logits come
    back at every window position, (B, C, V): position j scores the token
    after window token j. Rows past ``n_valid`` carry garbage logits —
    never read."""
    x = embedding_apply(params["embed"], tokens)
    h, caches = stack_paged(params["stack"], x, ctx_len, block_table,
                            n_valid, cfg, rt, caches)
    h = norm_apply(cfg.norm, params["final_norm"], h)
    return _head(params, cfg, h), caches


def lm_paged_fused_step(params, tokens, ctx_len, block_table, n_valid,
                        caches, cfg: ArchConfig, rt: Runtime):
    """One fused decode tick, plain decode (W == 1) and the speculative
    verify window (W == spec_k + 1) alike: every layer's attention is ONE
    ``paged_decode_ragged`` launch over the batch's ragged (slot,
    attend_len) grid. tokens (B, W) is each row's window, padded past
    ``n_valid``; logits come back at every window position, (B, W, V), as
    from ``lm_paged_verify``. Rows past ``n_valid`` carry garbage logits —
    never read."""
    x = embedding_apply(params["embed"], tokens)
    h, caches = stack_paged(params["stack"], x, ctx_len, block_table,
                            n_valid, cfg, rt, caches, fused=True)
    h = norm_apply(cfg.norm, params["final_norm"], h)
    return _head(params, cfg, h), caches


def paged_copy_page(caches, src: int, dst: int):
    """Copy physical page ``src`` -> ``dst`` across every layer, head and
    pool leaf (codes and scales of a quantized pool), in place."""
    for slot_cache in caches:
        for k in _PAGE_KEYS:
            for leaf in tree_leaves(slot_cache[k]):
                leaf[:, dst] = leaf[:, src]
    return caches


def paged_gather_pages(caches, pages: torch.Tensor) -> list:
    """Whole physical pages across every pool leaf: the preemption
    snapshot. Each (P, n_pages, Hkv, ps, w) leaf yields (P, n, Hkv, ps,
    w); quantized pools keep their codes + scale structure."""
    idx = pages.long()
    return [{k: tree_map(lambda _, leaf: leaf[:, idx], slot_cache[k])
             for k in _PAGE_KEYS}
            for slot_cache in caches]


def paged_scatter_pages(caches, pages: torch.Tensor, payload):
    """Write snapshotted pages back into the pools, in place — the inverse
    of ``paged_gather_pages``."""
    idx = pages.long()
    for slot_cache, pay in zip(caches, payload):
        for k in _PAGE_KEYS:
            for leaf, val in zip(tree_leaves(slot_cache[k]),
                                 tree_leaves(pay[k])):
                leaf[:, idx] = torch.as_tensor(val).to(leaf.device,
                                                       leaf.dtype)
    return caches
