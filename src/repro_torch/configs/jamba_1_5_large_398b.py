"""Jamba-1.5-Large (398B): Mamba+attention 1:7 interleave, MoE 16e top-2 on
every other layer. Period of 8 = [attn, 7x mamba], MoE on odd in-period
slots; 72 layers = 9 periods. [arXiv:2403.19887; hf]"""
from .base import ArchConfig

_PERIOD = (
    "attn+dense", "mamba+moe", "mamba+dense", "mamba+moe",
    "mamba+dense", "mamba+moe", "mamba+dense", "mamba+moe",
)

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=24576, vocab_size=65536,
    mlp_variant="swiglu", norm="rmsnorm",
    n_experts=16, top_k=2,
    pattern=_PERIOD,
    ssm_d_state=16, ssm_d_conv=4, ssm_expand=2, ssm_dt_rank=256,
    source="arXiv:2403.19887",
)
