"""Lockstep serving: prefill + decode steps and a batched generation loop.

The counterpart of the JAX package's ``runtime/serve_loop.py``.
``run.softmax_policy`` (exact / REXP / 2D-LUT) governs every attention
softmax in prefill and decode; ``run.kv_dtype="int8"`` fake-quantizes
the K/V entering the contiguous caches with the int8 pool's rounding,
which makes :func:`generate` the reference the int8 ``ServingEngine``
is held to.  An encoder-decoder (Whisper) takes its stub frame
embeddings as ``encoder_input``: the prefill step encodes them once.
Every request of a batch shares one prompt length and finishes
together.  The steps run where the tensors lie.

Greedy decoding gives the JAX package's tokens.  Sampling draws from
``torch.Generator`` streams (Philox on the card, not JAX's threefry), so
sampled streams replay exactly from the same seed but do not match the
JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import RunConfig
from repro_torch.models.model_zoo import Model

Tensor = torch.Tensor


def make_prefill_step(model: Model, run: RunConfig, max_len: int):
    """``(params, tokens, encoder_input=None) → (last-position logits
    (B, 1, V), state)``."""
    def prefill_step(params, tokens, encoder_input=None):
        return model.prefill(params, tokens, run, max_len,
                             encoder_input=encoder_input, logits="last")
    return prefill_step


def make_decode_step(model: Model, run: RunConfig):
    """``(params, token (B, 1), caches) → (logits (B, 1, V), caches)``."""
    def decode_step(params, token, state):
        return model.decode_step(params, token, state, run)
    return decode_step


def sample_token(logits: Tensor, generator: torch.Generator | None = None,
                 temperature: float = 0.0) -> Tensor:
    """logits (B, 1, V) → token (B, 1) int32: argmax at temperature ≤ 0,
    else one draw per row from ``softmax(logits / temperature)`` with
    ``generator`` (on the logits' device)."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits[:, 0].double() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator).to(torch.int32)


def sample_row(logits_row: np.ndarray, temperature: float, seed: int,
               position: int) -> int:
    """One request's token from its (V,) logits row on the host: argmax
    at temperature ≤ 0, else a draw from a CPU ``torch.Generator`` seeded
    from ``(seed, position)`` — so a stream replays exactly whatever
    slot or batch the request shares (the engine's sampling)."""
    if temperature <= 0.0:
        return int(np.argmax(logits_row))
    gen = torch.Generator().manual_seed(
        (seed * 1_000_003 + position) % (1 << 63))
    probs = torch.softmax(torch.as_tensor(logits_row, dtype=torch.float64)
                          / temperature, dim=-1)
    return int(torch.multinomial(probs, 1, generator=gen))


def sample_tokens(logits: Tensor, seeds, positions, temperatures, *,
                  greedy: bool = False) -> Tensor:
    """Batched per-slot sampling: logits (B, 1, V) → (B,) int32.

    Row b is :func:`sample_row` of ``(temperatures[b], seeds[b],
    positions[b])``: the argmax at temperature ≤ 0, else its own
    ``(seed, position)`` stream, so slot assignment and batch
    composition do not change a token.  ``greedy=True`` promises every
    temperature is ≤ 0 and takes the argmax on the logits' device.
    """
    argmax = torch.argmax(logits[:, 0], dim=-1).to(torch.int32)
    temps = np.asarray(temperatures, np.float64)
    if greedy or not (temps > 0.0).any():
        return argmax
    rows = logits[:, 0].float().cpu().numpy()
    out = [sample_row(rows[b], float(temps[b]), int(seeds[b]),
                      int(positions[b])) for b in range(rows.shape[0])]
    return torch.as_tensor(out, dtype=torch.int32, device=logits.device)


def generate(model: Model, params, prompt: Tensor, run: RunConfig, *,
             max_new_tokens: int, max_len: int | None = None,
             encoder_input: Tensor | None = None, temperature: float = 0.0,
             seed: int = 0) -> Tensor:
    """Greedy / temperature generation for the (B, S) ``prompt`` (and, for
    an encoder-decoder, its (B, L_enc, D) ``encoder_input``); returns
    (B, max_new_tokens) int32 tokens on the prompt's device."""
    b, s = prompt.shape
    max_len = max_len or (s + max_new_tokens)
    prefill_step = make_prefill_step(model, run, max_len)
    decode_step = make_decode_step(model, run)
    gen = torch.Generator(device=prompt.device).manual_seed(seed)
    logits, state = prefill_step(params, prompt, encoder_input)
    out = []
    tok = sample_token(logits, gen, temperature)
    for i in range(max_new_tokens):
        out.append(tok)
        if i == max_new_tokens - 1:
            break
        logits, state = decode_step(params, tok, state)
        tok = sample_token(logits, gen, temperature)
    return torch.cat(out, dim=1)
