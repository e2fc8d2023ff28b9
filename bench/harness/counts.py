"""The operations and bytes the served work needs, from the configuration
and the lengths the benchmark generated, whatever the program computes,
and the chip's peaks they are held to.

A multiply-add counts 2 operations.  A token computed through the model
needs 2 x its active parameters (for an MoE layer: the router, its top-k
experts and the shared experts) and, in each attention layer, 4 x heads x
head_dim x the keys it attends to.  The head's product is counted only
for tokens whose logits are used: every decoded token, and the last token
of each prompt.

The paged attention kernel of one layer reads each live key's K and V
once, the queries and the block table, and writes its f32 output.
"""

from __future__ import annotations

#: NVIDIA H100 SXM (data sheet, dense, no sparsity, 700 W)
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_S = 3.35e12


def layer_params(cfg: dict) -> tuple[int, int]:
    """(attention, FFN active) parameters of one layer."""
    d = cfg["hidden_size"]
    h, kvh, dh = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                  cfg["head_dim"])
    attn = d * h * dh * 2 + d * kvh * dh * 2
    e = cfg.get("n_routed_experts", 0)
    if e:
        f = cfg["moe_intermediate_size"]
        ffn = (d * e + cfg["num_experts_per_tok"] * 3 * d * f
               + cfg["n_shared_experts"] * 3 * d * f)
    else:
        ffn = 3 * d * cfg["intermediate_size"]
    return attn, ffn


def body_flops_per_token(cfg: dict) -> int:
    attn, ffn = layer_params(cfg)
    return 2 * cfg["num_hidden_layers"] * (attn + ffn)


def head_flops(cfg: dict) -> int:
    return 2 * cfg["hidden_size"] * cfg["vocab_size"]


def attn_flops(cfg: dict, keys: int) -> int:
    """All layers' attention operations of tokens attending to ``keys``
    keys in total."""
    return (4 * cfg["num_attention_heads"] * cfg["head_dim"]
            * cfg["num_hidden_layers"] * keys)


def causal_keys(cache: int, n: int) -> int:
    """Keys the rows of a chunk of ``n`` tokens after ``cache`` attend to."""
    return n * cache + n * (n + 1) // 2


def decode_flops(cfg: dict, kv_lens) -> int:
    """A decode step of the live slots attending to ``kv_lens`` keys."""
    n = len(kv_lens)
    return (n * (body_flops_per_token(cfg) + head_flops(cfg))
            + attn_flops(cfg, int(sum(kv_lens))))


def chunk_flops(cfg: dict, cache: int, n: int, last: bool) -> int:
    """A prompt chunk of ``n`` tokens after ``cache`` cached ones;
    ``last``: it ends the prompt, so its last row's logits are used."""
    return (n * body_flops_per_token(cfg)
            + attn_flops(cfg, causal_keys(cache, n))
            + (head_flops(cfg) if last else 0))


def _kv_row_bytes(cfg: dict, kv_bytes: int) -> int:
    return 2 * cfg["num_key_value_heads"] * cfg["head_dim"] * kv_bytes


def paged_decode_cost(cfg: dict, kv_lens, page_size: int,
                      kv_bytes: int = 2, q_bytes: int = 2) -> tuple[int, int]:
    """(operations, bytes) of one layer's paged decode call."""
    hd = cfg["num_attention_heads"] * cfg["head_dim"]
    keys = int(sum(kv_lens))
    pages = sum(-(-int(k) // page_size) for k in kv_lens)
    n = len(kv_lens)
    flops = 4 * hd * keys
    nbytes = (keys * _kv_row_bytes(cfg, kv_bytes) + 4 * pages
              + n * hd * (q_bytes + 4))
    return flops, nbytes


def paged_prefill_cost(cfg: dict, cache: int, n: int, page_size: int,
                       kv_bytes: int = 2, q_bytes: int = 2
                       ) -> tuple[int, int]:
    """(operations, bytes) of one layer's paged prefill call of a chunk of
    ``n`` tokens after ``cache``."""
    hd = cfg["num_attention_heads"] * cfg["head_dim"]
    flops = 4 * hd * causal_keys(cache, n)
    keys = cache + n
    nbytes = (keys * _kv_row_bytes(cfg, kv_bytes)
              + 4 * -(-keys // page_size) + n * hd * (q_bytes + 4))
    return flops, nbytes


def least_time(flops: float, nbytes: float) -> float:
    """The least seconds the chip could take: the larger of the compute
    and the memory bound."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES_S)
