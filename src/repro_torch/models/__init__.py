"""The serving model stack of the port (``repro.models``): layers,
attention, the Mamba2 block, the decoder structure, prefill / decode, and
the carry of the reference's parameters (``convert``)."""
from . import api, attention, convert, decoding, layers, ssm, transformer

__all__ = ["api", "attention", "convert", "decoding", "layers", "ssm",
           "transformer"]
