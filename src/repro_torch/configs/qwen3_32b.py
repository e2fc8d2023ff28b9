"""Qwen3 32B — dense GQA with qk-norm, head_dim 128.

[hf:Qwen/Qwen3-8B; hf] (family card; 32B dims per assignment)
"""
from repro_torch.configs.base import ArchConfig

ARCH = ArchConfig(
    name="qwen3-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=64, n_kv_heads=8,
    d_ff=25600, vocab_size=151936,
    head_dim=128, qk_norm=True, rope_theta=1_000_000.0,
    source="[hf:Qwen/Qwen3-8B; hf]",
)
