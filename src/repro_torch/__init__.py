"""PyTorch/CUDA port of the RDCA fabric reproduction.

The JAX package ``repro`` stays the reference; this package re-implements
its main path in PyTorch and runs it on an NVIDIA Hopper card.  It
imports ``torch`` and numpy only, never ``jax`` and nothing of ``repro``:
what it needs of the reference's pure-Python modules (configs, topology,
scenarios, packing) it keeps as its own copy.

Ported so far, each TPU kernel of the reference as a hand-written CUDA
kernel for the H100 (``csrc/``, built by ``_build``):

* the vector fabric engine's static-ECMP, DCQCN, dense, fixed-dt grid
  (:func:`repro_torch.fabric.run_fabric_sweep`), whose two priority
  water-fills run in ``csrc/fused_waterfill.cu``;
* zamba2-1.2b serving (:mod:`repro_torch.serving`,
  :mod:`repro_torch.models`) with flash attention
  (``csrc/flash_attention.cu``) and the Mamba2 SSD scan
  (``csrc/ssd_scan.cu``);
* the paged KV cache (:class:`repro_torch.core.DevicePool`,
  :class:`repro_torch.serving.PagedKV`) with paged decode attention
  (``csrc/decode_attention.cu``), and the staged matmul
  (``csrc/staged_matmul.cu``: float32 on the CUDA cores, bfloat16 through
  wgmma fed by TMA, or mma.sync for shapes TMA cannot describe).

Kernels are reached through :mod:`repro_torch.kernels.ops` and
:mod:`repro_torch.fabric.fused`; a CPU tensor runs a kernel's plain
PyTorch version instead.
"""
