"""Minitron-4B (pruned Nemotron): squared-relu ungated FFN.
[arXiv:2407.14679; hf-verified]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="minitron-4b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8, head_dim=128,
    d_ff=9216, vocab_size=256000,
    mlp_variant="relu2", act="relu2", norm="layernorm",
    pattern=("attn+dense",),
    source="arXiv:2407.14679",
)
