"""IBM Granite-3 8B: dense GQA transformer.
[hf:ibm-granite/granite-3.0-8b-base family; hf-verified]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="granite-3-8b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=12800, vocab_size=49155,
    mlp_variant="swiglu", norm="rmsnorm",
    pattern=("attn+dense",),
    source="hf:ibm-granite/granite-3.0-2b-base",
)
