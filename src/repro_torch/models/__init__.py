"""The model stack of the port (``repro.models``): layers, attention
(self- and cross-), the MoE dispatch, the Mamba2 and xLSTM blocks, the
decoder structure and its forward pass and loss, prefill / decode, the
model API with its input specs, and the carry of the reference's
parameters (``convert``)."""
from . import (api, attention, convert, decoding, layers, moe, ssm,
               transformer, xlstm)

__all__ = ["api", "attention", "convert", "decoding", "layers", "moe", "ssm",
           "transformer", "xlstm"]
