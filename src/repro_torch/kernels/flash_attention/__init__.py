"""Exact flash attention: the public dispatcher (``ops``), the CUDA
kernel's wrapper with its plain PyTorch version (``flash_attention``)
and the naive oracle (``ref``)."""
