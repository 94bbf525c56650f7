"""xLSTM-350m: mLSTM + sLSTM blocks (attention-free; runs long_500k).
Period of 4: three mLSTM then one sLSTM (7:1 in the paper at 1.3B scale;
3:1 at 350m keeps the same ingredients at 24 layers). d_ff=0 per the
assignment (blocks carry their own projections). [arXiv:2405.04517]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-350m", family="ssm",
    n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4, head_dim=256,
    d_ff=0, vocab_size=50304,
    norm="layernorm", tie_embeddings=True,
    pattern=("mlstm", "mlstm", "mlstm", "slstm+dense"),
    ssm_expand=2, ssm_d_conv=4, lstm_heads=4,
    source="arXiv:2405.04517",
)
