"""Model API (``repro.models.api``): the entry points the serving engine
uses."""
from __future__ import annotations

from . import decoding, transformer

init_params = transformer.init_params
prefill = decoding.prefill
decode_step = decoding.decode_step
init_decode_state = decoding.init_decode_state

__all__ = ["decode_step", "init_decode_state", "init_params", "prefill"]
