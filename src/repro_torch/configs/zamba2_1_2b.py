"""Zamba2-1.2B (Mamba2 backbone + shared attention block).
[arXiv:2411.15242; hf]  ssm_state=64; the shared transformer block is
invoked every 6th position (weights shared across invocations)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b", family="hybrid",
    num_layers=38, d_model=2048, num_heads=32, num_kv_heads=32,
    head_dim=64, d_ff=8192, vocab_size=32_000,
    ssm_state=64, ssm_head_dim=64, ssm_groups=1, attn_every=6,
    subquadratic=True,
    source="arXiv:2411.15242; hf",
)
