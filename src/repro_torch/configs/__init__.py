"""Architecture registry of the port, every arch of the JAX package's:

* the dense decoders (every ``LayerSpec`` an attention mixer with an
  MLP) and the MoE decoders DeepSeek-MoE-16B and Granite-MoE-3B
  (attention mixers with an MoE FFN, ``models/moe.py``), which the paged
  serving engines and the lockstep path run;
* the hybrid Jamba-v0.1-52B (Mamba mixers around one attention layer a
  period, an MoE FFN on every other layer) and the recurrent xLSTM-125M
  (mLSTM and sLSTM mixers, no FFN; ``models/ssm.py``), and the
  Whisper-small encoder-decoder, which the lockstep path runs — the
  paged engines refuse them, as the JAX package's do."""

from repro_torch.configs.base import ArchConfig, LayerSpec, MoESpec, RunConfig

from repro_torch.configs import (
    chameleon_34b,
    codeqwen1_5_7b,
    deepseek_moe_16b,
    granite_moe_3b_a800m,
    internlm2_20b,
    jamba_v0_1_52b,
    mistral_large_123b,
    qwen3_32b,
    whisper_small,
    xlstm_125m,
)

ARCHS: dict[str, ArchConfig] = {
    m.ARCH.name: m.ARCH
    for m in (mistral_large_123b, internlm2_20b, codeqwen1_5_7b, qwen3_32b,
              chameleon_34b, whisper_small, deepseek_moe_16b,
              granite_moe_3b_a800m, jamba_v0_1_52b, xlstm_125m)
}


def get_arch(name: str) -> ArchConfig:
    try:
        return ARCHS[name]
    except KeyError:
        raise ValueError(
            f"unknown arch {name!r}; available: {sorted(ARCHS)}") from None


__all__ = ["ArchConfig", "LayerSpec", "MoESpec", "RunConfig", "ARCHS",
           "get_arch"]
