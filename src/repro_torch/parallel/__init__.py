"""Distribution (``repro.parallel``), SPMD with one process a rank over
``torch.distributed``: the sharding rules and the mesh context
(``sharding``), the jet staged collectives (``collectives``), int8
compression with the error-feedback ``compressed_psum``
(``compression``), GPipe over the ``pod`` axis (``pipeline``) and the
farm's device probe (``compat``).  The sharded train step that puts them
together is ``train.steps.make_train_step(..., ctx=)``."""
from .compression import (BLOCK, compressed_psum, compression_ratio,
                          dequantize_int8, dequantize_int8_rowwise,
                          quantize_int8, quantize_int8_rowwise)
from .sharding import Mesh, NamedSharding, P, ParallelCtx, \
    single_device_ctx

__all__ = ["BLOCK", "Mesh", "NamedSharding", "P", "ParallelCtx",
           "compressed_psum", "compression_ratio", "dequantize_int8",
           "dequantize_int8_rowwise", "quantize_int8",
           "quantize_int8_rowwise", "single_device_ctx"]
