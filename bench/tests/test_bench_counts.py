"""The benchmark's operation and byte counts against hand counts."""

import pytest

from harness import counts as C

DENSE = dict(hidden_size=8, num_attention_heads=4, num_key_value_heads=2,
             head_dim=2, intermediate_size=16, num_hidden_layers=3,
             vocab_size=10)
MOE = dict(DENSE, n_routed_experts=4, num_experts_per_tok=2,
           moe_intermediate_size=6, n_shared_experts=1)


def test_layer_params_by_hand():
    # q 8x8, k 8x4, v 8x4, o 8x8 = 64+32+32+64; SwiGLU 3 x 8 x 16
    assert C.layer_params(DENSE) == (192, 384)
    # router 8x4, two experts of 3 x 8 x 6, one shared of 3 x 8 x 6
    assert C.layer_params(MOE) == (192, 32 + 2 * 144 + 144)


def test_decode_and_chunk_flops_by_hand():
    body = 2 * 3 * (192 + 384)
    head = 2 * 8 * 10
    # two live slots attending to 5 and 7 keys: 4 x H x Dh = 32 a key a layer
    assert C.decode_flops(DENSE, [5, 7]) == 2 * (body + head) + 32 * 3 * 12
    # a chunk of 3 after 4 cached: keys 5 + 6 + 7
    assert C.causal_keys(4, 3) == 18
    assert C.chunk_flops(DENSE, 4, 3, False) == 3 * body + 32 * 3 * 18
    assert C.chunk_flops(DENSE, 4, 3, True) == 3 * body + 32 * 3 * 18 + head


def test_paged_costs_by_hand():
    # K and V of a key: 2 x KVH x Dh x 2 bytes = 16; q bf16 + out f32 a
    # head element; 4 bytes a block-table entry
    fl, by = C.paged_decode_cost(DENSE, [5, 7], page_size=4)
    assert fl == 32 * 12
    assert by == 12 * 16 + 4 * (2 + 2) + 2 * 8 * (2 + 4)
    fl, by = C.paged_prefill_cost(DENSE, 4, 3, page_size=4)
    assert fl == 32 * 18
    assert by == 7 * 16 + 4 * 2 + 3 * 8 * (2 + 4)


@pytest.mark.parametrize("flops,nbytes,bound", [
    (989e12, 1.0, 1.0), (1.0, 3.35e12, 1.0), (989e9, 3.35e10, 0.01)])
def test_least_time_takes_the_larger_bound(flops, nbytes, bound):
    assert C.least_time(flops, nbytes) == pytest.approx(bound)
