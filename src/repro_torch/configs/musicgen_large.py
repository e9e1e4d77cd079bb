"""MusicGen-Large (decoder-only over EnCodec tokens).
[arXiv:2306.05284; hf]  The EnCodec frontend is a STUB per assignment:
input_specs() provides 4-codebook token ids; the embedding sums codebooks
(delay pattern applied upstream).  Positional encoding adapted to RoPE
(original: sinusoidal) — recorded in DESIGN.md."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-large", family="audio",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=32,
    head_dim=64, d_ff=8192, vocab_size=2048,
    mlp="gelu", num_codebooks=4,
    source="arXiv:2306.05284; hf",
)
