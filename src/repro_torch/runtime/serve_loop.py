"""Lockstep serving: prefill + decode steps and a batched generation loop.

The counterpart of the JAX package's ``runtime/serve_loop.py``.
``run.softmax_policy`` (exact / REXP / 2D-LUT) governs every attention
softmax in prefill and decode; ``run.kv_dtype="int8"`` fake-quantizes
the K/V entering the contiguous caches with the int8 pool's rounding,
which makes :func:`generate` the reference the int8 ``ServingEngine``
is held to.  An encoder-decoder (Whisper) takes its stub frame
embeddings as ``encoder_input``: the prefill step encodes them once.
The hybrid and recurrent decoders (Jamba, xLSTM), which the paged
engines refuse, are served here: their Mamba, mLSTM and sLSTM layers
carry their recurrent state from the prefill through the decode steps
(``models/ssm.py``).
Every request of a batch shares one prompt length and finishes
together.  The steps run where the tensors lie.

Greedy decoding gives the JAX package's tokens.  The lockstep
:func:`generate` samples from ``torch.Generator`` streams (Philox on the
card, not JAX's threefry), so its sampled streams replay exactly from
the same seed but do not match the JAX package's.  The engines sample
with :func:`sample_tokens`: the Gumbel-max draw
``argmax(logits / t + g)`` whose noise ``g`` is a counter-based integer
hash of ``(seed, position, vocab index)``, so a row's token depends on
nothing else — not its slot or batch, and not the device it is drawn
on (:func:`sample_row` is the same function on one host row).  Those
streams are not JAX's threefry streams either.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from repro_torch.configs.base import RunConfig
from repro_torch.models.model_zoo import Model
from repro_torch.runtime import partitioning as PT

Tensor = torch.Tensor


def serving_layout(model: Model, mesh):
    """The serving weights' layout on ``mesh``: the training layout
    (``shard_pspec`` with ``fsdp=True``: FSDP over ``'data'``, tensor
    and expert parallelism over ``'model'``, each ``'data'`` cut
    gathered just before use), as the JAX package's cells cut them;
    ``Layout.cut`` gives a rank's weights from whole ones."""
    return PT.Layout(model.cfg, mesh)


def _serving_scope(model: Model, mesh, batch: int | None):
    """The context a serving step runs in on ``mesh``: a function giving
    a fresh one each call — no autograd, and on a mesh of more than one
    rank the rank's weights under :func:`serving_layout` with the
    ``batch`` rows cut as ``batch_pspec`` cuts them."""
    if mesh is None or mesh.world <= 1:
        return torch.no_grad
    if batch is None:
        raise ValueError("a serving step on a mesh needs the global batch")
    layout = serving_layout(model, mesh)
    rows = PT.row_axes(mesh, batch)

    @contextlib.contextmanager
    def scope():
        with torch.no_grad(), PT.mesh_scope(mesh, cut=True, tokens=rows,
                                            layout=layout):
            yield
    return scope


def make_prefill_step(model: Model, run: RunConfig, max_len: int, *,
                      mesh=None, batch: int | None = None):
    """``(params, tokens, encoder_input=None) → (last-position logits
    (B, 1, V), state)``.

    With a ``mesh`` of more than one rank (the JAX package's serving
    cell under its active mesh): ``params`` are the rank's cut
    (:func:`serving_layout`), ``tokens`` and ``encoder_input`` the
    rank's rows of a global batch of ``batch`` rows
    (``partitioning.row_range``), and the state the rank's cut of the
    caches (``partitioning.cache_specs``)."""
    scope = _serving_scope(model, mesh, batch)

    def prefill_step(params, tokens, encoder_input=None):
        with scope():
            return model.prefill(params, tokens, run, max_len,
                                 encoder_input=encoder_input, logits="last")
    return prefill_step


def make_decode_step(model: Model, run: RunConfig, *, mesh=None,
                     batch: int | None = None):
    """``(params, token (B, 1), caches) → (logits (B, 1, V), caches)``;
    with a ``mesh``, each a rank's share as for
    :func:`make_prefill_step`."""
    scope = _serving_scope(model, mesh, batch)

    def decode_step(params, token, state):
        with scope():
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


_M32 = 0xFFFFFFFF


def _mul32(x: Tensor, c: int) -> Tensor:
    """``x · c mod 2^32`` for int64 ``x`` in [0, 2^32): the constant is
    split into 16-bit halves so that no product leaves int64's range —
    the same integers on every device, with no reliance on overflow."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _mix32(x: Tensor) -> Tensor:
    """A 32-bit integer finalizer (xor-shift-multiply, "lowbias32"):
    a bijection of [0, 2^32) in int64 tensor ops."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def hash_bits(seeds: Tensor, positions: Tensor, vocab: int) -> Tensor:
    """(B, V) int64: 52 random bits a vocab index, a counter-based hash
    of each row's ``(seed, position)`` and the index — two 32-bit hashes
    of the counter, 26 bits of each.  The same integers on every
    device."""
    dev = seeds.device
    key = _mix32(_mix32((seeds.long() & _M32) ^ 0x9E3779B9)
                 ^ (positions.long() & _M32))[:, None]           # (B, 1)
    idx = 2 * torch.arange(vocab, dtype=torch.int64, device=dev)[None]
    hi = _mix32(_mix32(key ^ idx)) >> 6
    lo = _mix32(_mix32(key ^ (idx + 1))) >> 6
    return (hi << 26) | lo


def gumbel_noise(seeds: Tensor, positions: Tensor, vocab: int) -> Tensor:
    """(B, V) f64 Gumbel noise from :func:`hash_bits` ``k``: ``u = (2k +
    1) · 2^-53`` is exact in f64 and lies strictly inside (0, 1); then
    ``g = −log(−log u)`` in f64 (only ``log``'s last ulp may differ
    between devices)."""
    u = (2 * hash_bits(seeds, positions, vocab) + 1).double() * 2.0 ** -53
    return -torch.log(-torch.log(u))


def sample_tokens(logits: Tensor, seeds, positions, temperatures, *,
                  greedy: bool = False) -> Tensor:
    """Batched per-row sampling on the logits' device: logits (B, 1, V)
    → (B,) int32.

    Row b takes the argmax at ``temperatures[b] ≤ 0``, else the
    Gumbel-max draw ``argmax(logits[b] / t + g)`` in f64 with
    :func:`gumbel_noise` of ``(seeds[b], positions[b])`` — so slot
    assignment, batch composition and the device do not change a token.
    ``seeds``, ``positions`` and ``temperatures`` are tensors on the
    logits' device or host sequences.  ``greedy=True`` promises every
    temperature is ≤ 0 and takes the argmax alone.
    """
    rows = logits[:, 0]
    argmax = torch.argmax(rows, dim=-1).to(torch.int32)
    if greedy:
        return argmax
    dev = rows.device
    temps = torch.as_tensor(temperatures, dtype=torch.float64, device=dev)
    seeds = torch.as_tensor(seeds, dtype=torch.int64, device=dev)
    positions = torch.as_tensor(positions, dtype=torch.int64, device=dev)
    hot = temps > 0.0
    # rows that take the argmax still flow through the draw: divide by 1
    safe_t = torch.where(hot, temps, torch.ones_like(temps))
    drawn = torch.argmax(rows.double() / safe_t[:, None]
                         + gumbel_noise(seeds, positions, rows.shape[-1]),
                         dim=-1).to(torch.int32)
    return torch.where(hot, drawn, argmax)


def sample_row(logits_row: np.ndarray, temperature: float, seed: int,
               position: int) -> int:
    """One request's token from its (V,) logits row on the host: row 0 of
    :func:`sample_tokens` — the argmax at temperature ≤ 0, else the
    Gumbel-max draw of ``(seed, position)`` — so the synchronous engine's
    host sampling and the pipelined engine's device sampling give the
    same tokens."""
    row = torch.as_tensor(np.asarray(logits_row))[None, None]
    return int(sample_tokens(row, [seed], [position], [temperature],
                             greedy=temperature <= 0.0)[0])


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
