"""Whisper small — encoder-decoder; conv frontend STUBBED to precomputed
frame embeddings (the serving launcher makes seeded (B, 1500, 768)
frames).

[arXiv:2212.04356; unverified]
"""
from repro_torch.configs.base import ArchConfig

ARCH = ArchConfig(
    name="whisper-small", family="audio",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
    d_ff=3072, vocab_size=51865,
    encoder_layers=12, encoder_seq=1500,
    mlp_gated=False, attn_bias=True, rope=False,
    source="[arXiv:2212.04356; unverified]",
)
