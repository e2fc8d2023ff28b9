"""Mistral Large 2 (123B) — dense GQA decoder.

[hf:mistralai/Mistral-Large-Instruct-2407; unverified]
"""
from repro_torch.configs.base import ArchConfig

ARCH = ArchConfig(
    name="mistral-large-123b", family="dense",
    n_layers=88, d_model=12288, n_heads=96, n_kv_heads=8,
    d_ff=28672, vocab_size=32768,
    head_dim=128, rope_theta=1_000_000.0,
    source="[hf:mistralai/Mistral-Large-Instruct-2407; unverified]",
)
