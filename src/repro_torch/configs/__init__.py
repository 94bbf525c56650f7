"""Config registry: ``get_config(name)`` / ``list_configs()`` / per-arch
modules. Each assigned architecture has its own module with the exact
published dimensions; ``reduced()`` builds the family-preserving small config
used by CPU smoke tests."""
from __future__ import annotations

import dataclasses
import importlib

from .base import ArchConfig, LM_SHAPES, ShapeConfig

_ARCH_MODULES = [
    "granite_3_8b", "gemma_2b", "qwen2_5_14b", "minitron_4b", "xlstm_350m",
    "kimi_k2_1t_a32b", "olmoe_1b_7b", "whisper_small", "jamba_1_5_large_398b",
    "qwen2_vl_2b", "paper_mlp",
]

_REGISTRY: dict[str, ArchConfig] = {}


def _load():
    if _REGISTRY:
        return
    for m in _ARCH_MODULES:
        mod = importlib.import_module(f"repro_torch.configs.{m}")
        cfg = mod.CONFIG
        _REGISTRY[cfg.name] = cfg


def get_config(name: str) -> ArchConfig:
    _load()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> list[str]:
    _load()
    return sorted(_REGISTRY)


def assigned_archs() -> list[str]:
    """The 10 assigned architectures (excludes the paper's own MLP)."""
    _load()
    return sorted(n for n in _REGISTRY if n != "paper-mlp")


def reduced(cfg: ArchConfig, *, n_layers: int | None = None,
            d_model: int = 64, vocab: int = 512) -> ArchConfig:
    """Family-preserving shrink for CPU smoke tests: same pattern / mixer /
    ffn kinds / gqa ratio, tiny dims."""
    n_per_pattern = len(cfg.pattern)
    layers = n_layers or n_per_pattern
    layers = max(layers, n_per_pattern)
    layers -= layers % n_per_pattern
    heads = max(2, min(4, cfg.n_heads))
    kv = max(1, heads * cfg.n_kv_heads // cfg.n_heads)
    while heads % kv:
        kv += 1
    head_dim = d_model // heads if cfg.head_dim == 0 else 32
    mrope = cfg.mrope_sections
    if mrope is not None:
        half = head_dim // 2
        tot = sum(mrope)
        scaled = [max(1, half * s // tot) for s in mrope]
        scaled[-1] += half - sum(scaled)
        mrope = tuple(scaled)
    return dataclasses.replace(
        cfg,
        n_layers=layers,
        d_model=d_model,
        n_heads=heads,
        n_kv_heads=kv,
        head_dim=head_dim,
        mrope_sections=mrope,
        d_ff=d_model * 2,
        vocab_size=vocab,
        n_experts=min(cfg.n_experts, 8) if cfg.is_moe else 0,
        top_k=min(cfg.top_k, 2) if cfg.is_moe else 0,
        n_shared_experts=min(cfg.n_shared_experts, 1),
        # no token dropping at smoke scale: capacity drops make train-vs-
        # decode comparisons nondeterministic (prod keeps 1.25)
        capacity_factor=64.0 if cfg.is_moe else cfg.capacity_factor,
        ssm_d_state=8,
        ssm_dt_rank=8,
        lstm_heads=2,
        n_enc_layers=n_per_pattern if cfg.enc_dec else 0,
        enc_seq_len=16 if cfg.enc_dec else cfg.enc_seq_len,
    )


__all__ = ["ArchConfig", "ShapeConfig", "LM_SHAPES", "get_config",
           "list_configs", "assigned_archs", "reduced"]
