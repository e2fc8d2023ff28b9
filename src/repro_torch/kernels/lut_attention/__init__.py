"""LUT attention: the public dispatchers (``ops``), the three CUDA
kernels' wrappers (``paged_decode``, ``paged_prefill``, and the dense
``lut_attention``), each with its plain PyTorch version, and the naive
oracle (``ref``)."""
