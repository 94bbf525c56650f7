"""Qwen2-VL-2B backbone: M-RoPE (t/h/w sections 16/24/24), GQA kv=2.
Vision tower is a STUB per the assignment (patch embeddings precomputed);
the M-RoPE position streams are real inputs. [arXiv:2409.12191; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-2b", family="vlm",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2, head_dim=128,
    d_ff=8960, vocab_size=151936,
    mlp_variant="swiglu", norm="rmsnorm", qkv_bias=True,
    mrope_sections=(16, 24, 24),
    pattern=("attn+dense",), frontend="vision",
    source="arXiv:2409.12191",
)
