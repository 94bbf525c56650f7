"""Qwen2.5-14B: dense GQA with QKV bias. [hf:Qwen/Qwen2.5-14B; hf-verified]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-14b", family="dense",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=13824, vocab_size=152064,
    mlp_variant="swiglu", norm="rmsnorm", qkv_bias=True,
    rope_theta=1000000.0,
    pattern=("attn+dense",),
    source="hf:Qwen/Qwen2.5-14B",
)
