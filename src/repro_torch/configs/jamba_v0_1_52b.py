"""Jamba v0.1 52B — hybrid Mamba+attention 1:7 interleave, MoE 16e top-2.

[arXiv:2403.19887; hf]  Period of 8 layers: attention at index 3, Mamba
elsewhere; MoE replaces the MLP on every other layer (d_expert = d_ff).
Jamba uses no positional encoding (Mamba provides order); rope=False.
"""
from repro_torch.configs.base import ArchConfig, LayerSpec, MoESpec

_PERIOD = tuple(
    LayerSpec(mixer="attn" if i == 3 else "mamba",
              ffn="moe" if i % 2 == 1 else "mlp")
    for i in range(8)
)

ARCH = ArchConfig(
    name="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab_size=65536,
    period=_PERIOD,
    moe=MoESpec(n_experts=16, top_k=2, d_expert=14336),
    rope=False, sub_quadratic=True,
    source="[arXiv:2403.19887; hf]",
)
