"""Llama-4 Scout 17B-A16E (MoE, early fusion).
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e", family="moe",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
    head_dim=128, d_ff=8192, vocab_size=202_048,
    rope_theta=500_000.0,
    num_experts=16, top_k=1, moe_every=1, shared_expert=True,
    source="hf:meta-llama/Llama-4-Scout-17B-16E; unverified",
)
