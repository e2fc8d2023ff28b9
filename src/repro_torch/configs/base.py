"""Architecture + runtime configuration.

An :class:`ArchConfig` fully determines a model; the layer stack is
described as a repeating *period* of :class:`LayerSpec`s (homogeneous
dense models have a period of 1; Jamba has a period of 8 with one
attention layer; xLSTM alternates mLSTM/sLSTM).  A copy of the JAX
package's ``configs/base.py``, so a config converts one to one; its
shape registry (:data:`SHAPES`, the four cell shapes of
``launch/cells.py``) too.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Literal

from repro_torch.core.policies import EXACT, SoftmaxPolicy

Mixer = Literal["attn", "mamba", "mlstm", "slstm"]
Ffn = Literal["mlp", "moe", "none"]


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: Mixer = "attn"
    ffn: Ffn = "mlp"


@dataclasses.dataclass(frozen=True)
class MoESpec:
    n_experts: int
    top_k: int
    d_expert: int
    n_shared: int = 0
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    period: tuple[LayerSpec, ...] = (LayerSpec(),)
    moe: MoESpec | None = None
    head_dim: int | None = None
    encoder_layers: int = 0         # > 0 → encoder-decoder (whisper)
    encoder_seq: int = 1500         # stub frame-embedding length
    qk_norm: bool = False
    rope: bool = True
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    mlp_gated: bool = True          # SwiGLU vs GELU
    attn_bias: bool = False
    tie_embeddings: bool = False
    sub_quadratic: bool = False     # SSM/hybrid → long_500k cell runs
    source: str = ""                # [source; verified-tier] provenance

    def __post_init__(self):
        assert self.n_layers % len(self.period) == 0, (
            f"{self.name}: n_layers {self.n_layers} not divisible by "
            f"period {len(self.period)}")

    @property
    def n_periods(self) -> int:
        return self.n_layers // len(self.period)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def with_layers(self, n_periods: int) -> "ArchConfig":
        """Depth-reduced clone (roofline probes, smoke tests)."""
        return dataclasses.replace(
            self, n_layers=n_periods * len(self.period))

    def scaled_down(self, d_model: int = 64, n_heads: int = 4,
                    n_kv_heads: int | None = None, vocab: int = 512,
                    n_periods: int = 1) -> "ArchConfig":
        """Same-family reduced config for CPU smoke tests."""
        kvh = n_kv_heads if n_kv_heads is not None else min(
            n_heads, max(1, self.n_kv_heads * n_heads // self.n_heads))
        moe = None
        if self.moe is not None:
            moe = dataclasses.replace(
                self.moe, n_experts=min(self.moe.n_experts, 4),
                top_k=min(self.moe.top_k, 2), d_expert=d_model // 2)
        return dataclasses.replace(
            self, d_model=d_model, n_heads=n_heads, n_kv_heads=kvh,
            d_ff=d_model * 2 if self.d_ff else 0, vocab_size=vocab,
            n_layers=n_periods * len(self.period), moe=moe, head_dim=None,
            encoder_layers=min(self.encoder_layers, 2 * n_periods),
            encoder_seq=min(self.encoder_seq, 32))

    # ---- parameter counting (MODEL_FLOPS = 6·N·D uses these) ----

    def _attn_params(self) -> int:
        dh = self.resolved_head_dim
        return self.d_model * dh * (self.n_heads * 2
                                    + self.n_kv_heads * 2)

    def _mlp_params(self) -> int:
        mult = 3 if self.mlp_gated else 2
        return mult * self.d_model * self.d_ff

    def _moe_params(self, active_only: bool) -> int:
        m = self.moe
        per_expert = 3 * self.d_model * m.d_expert
        routed = (m.top_k if active_only else m.n_experts) * per_expert
        shared = 3 * self.d_model * (m.d_expert * m.n_shared)
        return routed + shared + self.d_model * m.n_experts

    def _mixer_params(self, mixer: Mixer) -> int:
        d = self.d_model
        if mixer == "attn":
            return self._attn_params()
        if mixer == "mamba":
            di = 2 * d
            dtr = max(1, math.ceil(d / 16))
            return (d * 2 * di + 4 * di + di * (dtr + 32) + dtr * di
                    + di * 16 + di + di * d)
        if mixer == "mlstm":
            return d * 2 * d + 3 * d * d + 2 * d * self.n_heads + d * d
        if mixer == "slstm":
            dh = d // self.n_heads
            return d * 4 * d + 4 * self.n_heads * dh * dh + d * d
        raise ValueError(mixer)

    def param_count(self, active_only: bool = False) -> int:
        """Total (or MoE-active) parameters, embeddings included."""
        per_period = 0
        for spec in self.period:
            per_period += self._mixer_params(spec.mixer)
            if spec.ffn == "mlp":
                per_period += self._mlp_params()
            elif spec.ffn == "moe":
                per_period += self._moe_params(active_only)
        total = per_period * self.n_periods
        if self.encoder_layers:
            total += self.encoder_layers * (
                self._attn_params() * 2 + self._mlp_params())
        total += self.vocab_size * self.d_model  # embed
        if not self.tie_embeddings:
            total += self.vocab_size * self.d_model  # head
        return total


# ---------------------------------------------------------------------------
# Shape registry (the cells)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: Literal["train", "prefill", "decode"]
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}


def shape_applicable(arch: ArchConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether a cell runs, with the skip reason: ``long_500k`` only for
    the sub-quadratic archs (SSM / hybrid)."""
    if shape.name == "long_500k" and not arch.sub_quadratic:
        return False, ("full-attention arch: 500k-context decode requires "
                       "sub-quadratic sequence mixing (run for SSM/hybrid only)")
    return True, ""


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Runtime knobs independent of architecture identity.

    The JAX package's ``RunConfig`` with its defaults, less the knobs of
    its scan: the port walks the periods in a Python loop and runs the
    recurrent mixers as step loops, so ``scan_layers``, ``ssm_chunk`` and
    ``probe_unroll`` have no counterpart (nor ``q_chunk`` / ``k_chunk``,
    which ``lut_attention`` takes directly).
    """
    dtype: str = "bfloat16"                        # activations and the
                                                   # KV pool on the card
    softmax_policy: SoftmaxPolicy = EXACT          # serving softmax
    router_policy: SoftmaxPolicy = EXACT           # MoE router softmax
    attention_backend: str = "auto"                # contiguous / full-seq
                                                   # attention (lockstep,
                                                   # enc-dec): auto | cuda
                                                   # | naive
    paged_backend: str = "auto"                    # paged attention (decode +
                                                   # prefill chunks):
                                                   # auto | cuda | dense
    kv_dtype: str = "f32"                          # KV storage: f32 (pool
                                                   # dtype follows `dtype`)
                                                   # | int8 (per-row f32
                                                   # scales, in-kernel
                                                   # dequant)
    remat: bool = True                             # recompute each period
                                                   # in the backward
    microbatch: int = 1                            # grad-accumulation steps
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    label_smoothing: float = 0.0
    moe_aux_weight: float = 0.01
    grad_compression: bool = False                 # int8 + error feedback
    shard_kv_seq: bool = False                     # the KV length over
                                                   # 'data' too (long
                                                   # context, batch 1)
