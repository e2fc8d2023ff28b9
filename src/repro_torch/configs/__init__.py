"""Architecture registry of the port: the attention-only dense decoders
(every ``LayerSpec`` an attention mixer with an MLP), the archs the paged
serving engine runs.  The JAX package's MoE, hybrid, SSM and enc-dec
archs wait for their model code."""

from repro_torch.configs.base import ArchConfig, LayerSpec, MoESpec, RunConfig

from repro_torch.configs import (
    chameleon_34b,
    codeqwen1_5_7b,
    internlm2_20b,
    mistral_large_123b,
    qwen3_32b,
)

ARCHS: dict[str, ArchConfig] = {
    m.ARCH.name: m.ARCH
    for m in (mistral_large_123b, internlm2_20b, codeqwen1_5_7b, qwen3_32b,
              chameleon_34b)
}


def get_arch(name: str) -> ArchConfig:
    try:
        return ARCHS[name]
    except KeyError:
        raise ValueError(
            f"unknown arch {name!r}; available: {sorted(ARCHS)}") from None


__all__ = ["ArchConfig", "LayerSpec", "MoESpec", "RunConfig", "ARCHS",
           "get_arch"]
