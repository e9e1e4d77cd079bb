"""Llama-3.2-Vision-11B (cross-attn image layers every 5th block).
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]  The vision tower is a
STUB per assignment: input_specs() provides precomputed, already-projected
patch embeddings [B, num_patches, d_model]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-11b", family="vlm",
    num_layers=40, d_model=4096, num_heads=32, num_kv_heads=8,
    head_dim=128, d_ff=14_336, vocab_size=128_256,
    rope_theta=500_000.0,
    cross_attn_every=5, num_patches=1600,
    source="hf:meta-llama/Llama-3.2-11B-Vision; unverified",
)
