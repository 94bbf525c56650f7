"""Gemma 2B: MQA (1 KV head), GeGLU, head_dim=256, huge vocab.
[arXiv:2403.08295; hf-verified]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="gemma-2b", family="dense",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, head_dim=256,
    d_ff=16384, vocab_size=256000,
    mlp_variant="geglu", norm="rmsnorm", tie_embeddings=True,
    pattern=("attn+dense",),
    source="arXiv:2403.08295",
)
