"""Whisper-small backbone: 12L encoder + 12L decoder, d=768, 12 heads,
LayerNorm + GELU. Conv audio frontend is a STUB per the assignment —
inputs are precomputed frame embeddings (B, 1500, 768).
[arXiv:2212.04356]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-small", family="audio",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, head_dim=64,
    d_ff=3072, vocab_size=51865,
    mlp_variant="mlp", act="gelu", norm="layernorm",
    enc_dec=True, n_enc_layers=12, enc_seq_len=1500, frontend="audio",
    pattern=("xdec+dense",),
    source="arXiv:2212.04356",
)
