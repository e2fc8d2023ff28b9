"""Hand-written Hopper kernels of the port, with their plain versions.

  common.py        the per-element LUT pipeline in plain torch (the
                   arithmetic of ``csrc/lut_pipeline.cuh``)
  build.py         ``nvcc`` → ``build/kernels/lib<name>.so`` → ctypes
  lut_attention/   the dispatchers (``ops.py``) and the wrappers of the
                   paged-decode, paged-prefill and dense LUT-attention
                   CUDA kernels

Paged-attention dispatch (``paged_backend``; the canonical statement is
in ``lut_attention/ops.py``): ``auto`` launches the CUDA kernel on CUDA
tensors and runs the plain version on CPU tensors; ``cuda`` launches the
kernel or raises (CPU tensors raise); ``dense`` runs the plain version
everywhere.  Dense attention (``attention_backend``: the lockstep path
and Whisper's encoder and cross-attention) has the same three rows with
``naive`` for the plain version, and sends the exact policy to the plain
version under every knob.  Nothing falls back: on CUDA tensors a kernel
that does not build or launch raises.
"""
