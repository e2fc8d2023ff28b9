"""PyTorch / CUDA port of the ``repro`` package for NVIDIA Hopper (H100).

The JAX package ``repro`` is the reference; this package mirrors its
module layout (``core``, ``kernels``, ``runtime``, ``configs``,
``models``, ``launch``) and imports neither ``jax`` nor ``repro``.  The
slice ported so far is the paged LUT-softmax serving path: the LUT
tables and integer semantics, the two paged-attention kernels
(hand-written CUDA C++ for ``sm_90a`` under ``csrc/``), the host page
bookkeeping, the attention-only decoder, the continuous-batching
``ServingEngine`` and ``PipelinedEngine`` and the asyncio streaming
server; then the int8 pool, Whisper-small lockstep serving and the
remaining TPU kernels (dense LUT attention, the row-wise LUT softmax,
flash attention).
"""
