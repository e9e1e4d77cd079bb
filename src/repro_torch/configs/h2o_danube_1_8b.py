"""H2O-Danube 1.8B (dense, llama+mistral mix, sliding-window attention).
[arXiv:2401.16818; hf]  SWA makes long_500k decode O(window)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-1.8b", family="dense",
    num_layers=24, d_model=2560, num_heads=32, num_kv_heads=8,
    head_dim=80, d_ff=6912, vocab_size=32_000,
    sliding_window=4096, subquadratic=True,
    source="arXiv:2401.16818; hf",
)
