"""Architecture registry of the port: the dense decoders (every
``LayerSpec`` an attention mixer with an MLP) and the MoE decoders
DeepSeek-MoE-16B and Granite-MoE-3B (attention mixers with an MoE FFN,
``models/moe.py``), which the paged serving engines and the lockstep
path run, and the Whisper-small encoder-decoder, which the lockstep path
runs.  The JAX package's hybrid and SSM archs (Jamba, xLSTM) wait for
their model code."""

from repro_torch.configs.base import ArchConfig, LayerSpec, MoESpec, RunConfig

from repro_torch.configs import (
    chameleon_34b,
    codeqwen1_5_7b,
    deepseek_moe_16b,
    granite_moe_3b_a800m,
    internlm2_20b,
    mistral_large_123b,
    qwen3_32b,
    whisper_small,
)

ARCHS: dict[str, ArchConfig] = {
    m.ARCH.name: m.ARCH
    for m in (mistral_large_123b, internlm2_20b, codeqwen1_5_7b, qwen3_32b,
              chameleon_34b, whisper_small, deepseek_moe_16b,
              granite_moe_3b_a800m)
}


def get_arch(name: str) -> ArchConfig:
    try:
        return ARCHS[name]
    except KeyError:
        raise ValueError(
            f"unknown arch {name!r}; available: {sorted(ARCHS)}") from None


__all__ = ["ArchConfig", "LayerSpec", "MoESpec", "RunConfig", "ARCHS",
           "get_arch"]
