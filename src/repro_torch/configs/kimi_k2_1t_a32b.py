"""Kimi K2: 1T-param MoE, 384 experts top-8 + 1 shared, 61 layers.
All layers MoE here (real K2 has one dense first layer; scan homogeneity —
see DESIGN.md §8). [arXiv:2501 Kimi K2 report; paper-table]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=2048, vocab_size=163840,
    mlp_variant="swiglu", norm="rmsnorm",
    n_experts=384, top_k=8, n_shared_experts=1,
    pattern=("attn+moe",),
    source="arXiv:2501.kimi2",
)
