"""Paged LUT attention: the public dispatchers (``ops``) and the two
CUDA kernels' wrappers (``paged_decode``, ``paged_prefill``), each with
its plain PyTorch version."""
