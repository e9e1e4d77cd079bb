"""The serving model stack of the port (``repro.models``): layers,
attention, the MoE dispatch, the Mamba2 and xLSTM blocks, the decoder
structure, prefill / decode, and the carry of the reference's parameters
(``convert``)."""
from . import (api, attention, convert, decoding, layers, moe, ssm,
               transformer, xlstm)

__all__ = ["api", "attention", "convert", "decoding", "layers", "moe", "ssm",
           "transformer", "xlstm"]
