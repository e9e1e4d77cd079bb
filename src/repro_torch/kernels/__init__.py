"""The model kernels: hand-written CUDA for the reference's Pallas flash
attention and Mamba2 SSD scan, their plain PyTorch versions (``ref``) and
the dispatch between them (``ops``)."""
from . import ops, ref

__all__ = ["ops", "ref"]
