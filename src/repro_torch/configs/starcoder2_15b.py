"""StarCoder2-15B (dense, GQA kv=4, RoPE, plain-GELU MLP).
[arXiv:2402.19173; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-15b", family="dense",
    num_layers=40, d_model=6144, num_heads=48, num_kv_heads=4,
    head_dim=128, d_ff=24_576, vocab_size=49_152,
    rope_theta=100_000.0, mlp="gelu",
    source="arXiv:2402.19173; hf",
)
