"""xLSTM-125M (sLSTM + mLSTM blocks). [arXiv:2405.04517; unverified]
d_ff=0: xLSTM blocks carry their own up/down projections.  Constant-size
recurrent state -> sub-quadratic, long_500k eligible."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-125m", family="ssm",
    num_layers=12, d_model=768, num_heads=4, num_kv_heads=4,
    head_dim=192, d_ff=0, vocab_size=50_304,
    xlstm=True, slstm_every=4,   # blocks 4, 8, 12 are sLSTM
    subquadratic=True,
    source="arXiv:2405.04517; unverified",
)
