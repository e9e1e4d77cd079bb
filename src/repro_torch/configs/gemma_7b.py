"""Gemma-7B (dense, GeGLU, head_dim=256). [arXiv:2403.08295; hf]
Note attn inner dim (16*256=4096) exceeds d_model (3072)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="gemma-7b", family="dense",
    num_layers=28, d_model=3072, num_heads=16, num_kv_heads=16,
    head_dim=256, d_ff=24_576, vocab_size=256_000,
    mlp="geglu", tie_embeddings=True,
    source="arXiv:2403.08295; hf",
)
