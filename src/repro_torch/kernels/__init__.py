"""Hand-written Hopper kernels of the port, with their plain versions.

  common.py         the per-element LUT pipeline in plain torch (the
                    arithmetic of ``csrc/lut_pipeline.cuh``)
  build.py          ``nvcc`` → ``build/kernels/lib<name>.so`` → ctypes
  lut_attention/    the dispatchers (``ops.py``), the wrappers of the
                    paged-decode, paged-prefill and dense LUT-attention
                    CUDA kernels, and the blocked (chunked) path
  lut_softmax/      ``lut_softmax`` and the row-wise REXP / 2D-LUT
                    softmax CUDA kernel's wrappers
  flash_attention/  ``flash_attention`` and the exact flash-attention
                    CUDA kernel's wrapper

Paged-attention dispatch (``paged_backend``; the canonical statement is
in ``lut_attention/ops.py``): ``auto`` launches the CUDA kernel on CUDA
tensors and runs the plain version on CPU tensors; ``cuda`` launches the
kernel or raises (CPU tensors raise); ``dense`` runs the plain version
everywhere.  Dense attention (``attention_backend``: the lockstep path
and Whisper's encoder and cross-attention) has the same three rows with
``naive`` for the plain version, sends the exact policy to the plain
version under every knob, and has a fourth, ``blocked``, the chunked
flash-style path in plain torch on either device.  ``lut_softmax``
takes the kernel for REXP / 2D-LUT with ``use_kernel=True`` (its plain
version on CPU tensors), and ``flash_attention`` has ``auto | cuda``
over its kernel beside ``naive | blocked``.  Nothing falls back: on
CUDA tensors a kernel that does not build or launch raises.
"""
