"""Row-wise LUT softmax: the public dispatcher (``ops``), the CUDA
kernel's wrappers with their plain PyTorch versions (``lut_softmax``)
and the core-semantics oracle (``ref``)."""
