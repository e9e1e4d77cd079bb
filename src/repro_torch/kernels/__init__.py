"""The model kernels: hand-written CUDA for the reference's Pallas flash
attention, Mamba2 SSD scan, paged decode attention and staged matmul,
their plain PyTorch versions (``ref``) and the dispatch between them
(``ops``)."""
from . import ops, ref
from .jet_decode_attention import decode_attention_paged
from .jet_flash_attention import flash_attention
from .jet_staged_matmul import staged_matmul, staging_pool_bytes
from .mamba2_ssd import ssd_scan

__all__ = ["decode_attention_paged", "flash_attention", "ops", "ref",
           "ssd_scan", "staged_matmul", "staging_pool_bytes"]
