"""ChatGLM3-6B (dense, 2d/partial RoPE, GQA kv=2). [arXiv:2406.12793; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="chatglm3-6b", family="dense",
    num_layers=28, d_model=4096, num_heads=32, num_kv_heads=2,
    head_dim=128, d_ff=13_696, vocab_size=65_024,
    rope_fraction=0.5,   # rotary applied to half the head dim (2d RoPE)
    source="arXiv:2406.12793; hf",
)
