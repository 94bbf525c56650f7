"""The paper's own model (§4.1): 784-128-10 sigmoid MLP."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="paper-mlp", family="mlp",
    n_layers=2, d_model=128, n_heads=1, n_kv_heads=1, head_dim=128,
    d_ff=128, vocab_size=10,
    mlp_variant="mlp", act="sigmoid", norm="layernorm",
    pattern=("attn+dense",),  # unused; the MLP has its own model module
    source="paper §4.1",
)
