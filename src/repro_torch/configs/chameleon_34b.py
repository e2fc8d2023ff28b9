"""Chameleon 34B — early-fusion VLM backbone (VQ image tokens share the
text vocab, so the backbone is a plain decoder LM with qk-norm; the VQ
tokenizer frontend is outside scope — tokens arrive pre-quantized).

[arXiv:2405.09818; unverified]
"""
from repro_torch.configs.base import ArchConfig

ARCH = ArchConfig(
    name="chameleon-34b", family="vlm",
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=22016, vocab_size=65536,
    qk_norm=True,
    source="[arXiv:2405.09818; unverified]",
)
