"""DeepSeekMoE 16B — 2 shared + 64 routed fine-grained experts, top-6.

[arXiv:2401.06066; hf]  As in the JAX package's config, one deviation:
the real model's layer 0 is a dense MLP; this is a homogeneous MoE stack
(period 1).
"""
from repro_torch.configs.base import ArchConfig, LayerSpec, MoESpec

ARCH = ArchConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab_size=102400,
    period=(LayerSpec(mixer="attn", ffn="moe"),),
    moe=MoESpec(n_experts=64, top_k=6, d_expert=1408, n_shared=2),
    source="[arXiv:2401.06066; hf]",
)
