"""Distribution (``repro.parallel``): so far only the int8 gradient and
moment compression.  The port runs on one card; the mesh, the sharding
rules, the staged collectives and ``compressed_psum`` (an all-reduce over
a process group) are ROADMAP Queue 1 A4."""
from .compression import (BLOCK, compression_ratio, dequantize_int8,
                          dequantize_int8_rowwise, quantize_int8,
                          quantize_int8_rowwise)

__all__ = ["BLOCK", "compression_ratio", "dequantize_int8",
           "dequantize_int8_rowwise", "quantize_int8",
           "quantize_int8_rowwise"]
