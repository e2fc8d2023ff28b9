"""Granite 3.0 MoE 3B (a800m active) — 40 routed experts, top-8.

[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]  The JAX package's
config, copied: 40 routed experts, top-8 (the published 3B-a800m card
lists 40 experts; the 1B-a400m family card it cites, 32).
"""
from repro_torch.configs.base import ArchConfig, LayerSpec, MoESpec

ARCH = ArchConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8,
    d_ff=512, vocab_size=49155,
    period=(LayerSpec(mixer="attn", ffn="moe"),),
    moe=MoESpec(n_experts=40, top_k=8, d_expert=512),
    tie_embeddings=True,
    source="[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]",
)
