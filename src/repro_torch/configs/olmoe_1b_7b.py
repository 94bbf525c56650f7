"""OLMoE-1B-7B: 64 experts top-8, 16 layers. [arXiv:2409.02060; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="olmoe-1b-7b", family="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1024, vocab_size=50304,
    mlp_variant="swiglu", norm="rmsnorm",
    n_experts=64, top_k=8,
    pattern=("attn+moe",),
    source="arXiv:2409.02060",
)
