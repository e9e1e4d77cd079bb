"""PyTorch/CUDA port of the RDCA fabric reproduction.

The JAX package ``repro`` stays the reference; this package re-implements
its main path in PyTorch and runs it on an NVIDIA Hopper card.  It
imports ``torch`` and numpy only, never ``jax`` and nothing of ``repro``:
what it needs of the reference's pure-Python modules (configs, topology,
scenarios, packing) it keeps as its own copy.

Ported so far: the vector fabric engine's static-ECMP, DCQCN, dense,
fixed-dt grid (:func:`repro_torch.fabric.run_fabric_sweep`), whose two
priority water-fills run as hand-written CUDA kernels
(``csrc/fused_waterfill.cu``).
"""
