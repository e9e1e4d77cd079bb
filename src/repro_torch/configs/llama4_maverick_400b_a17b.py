"""Llama-4 Maverick 400B-A17B (MoE, early fusion).
[hf:meta-llama/Llama-4-Scout-17B-16E family; unverified]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
    head_dim=128, d_ff=8192, vocab_size=202_048,
    rope_theta=500_000.0,
    num_experts=128, top_k=1, moe_every=2, shared_expert=True,
    source="hf:meta-llama/Llama-4-Scout-17B-16E; unverified",
)
