"""Whether what the timed path served is correct: a sample of the requests
finished by the window's close, drawn from the seed with the longest
among them, run through the plain reference (``bench/reference``) over
each prompt and its served tokens.  Each served (greedy) token has a gap:
how far its logit lies below the reference's best.  The number compared
is the share of served tokens whose gap exceeds the cell's ``tail_gap``
(``tail_share``); the mean and widest gap, the share on the argmax and
the shares over each of ``GAP_STEPS`` are recorded beside it, and a
cell's ``check`` may give any of ``COMPARED`` a limit.

In a ``docqa``-style mix the sample is taken from the requests on the
longest request's document, which the reference prefills once.  Besides,
every finished request's streamed tokens must equal the engine's result.

``control=True`` also runs the reference in the lower precision (fp8) on
the same prompts and tokens, takes at each position the token that it
puts first, and gives its gaps the same readings: the control, which the
same checks have to find not correct.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from harness.traffic import seed_words
from reference.model import Reference, gaps, prompt_groups

#: the numbers a cell's ``check`` may give a limit
COMPARED = ("tail_share", "mean_gap", "max_gap")
#: gaps whose shares every run records
GAP_STEPS = (0.0625, 0.125, 0.1875, 0.25, 0.375, 0.5)


def stream_mismatches(records) -> int:
    return sum(1 for r in records if r.result is not None
               and list(r.tokens) != [int(t) for t in r.result.tokens])


def sample(records, traffic, seed: int, n_requests: int, min_tokens: int):
    """The requests compared: the longest finished one, then others drawn
    from the seed (on its document, where the mix has documents) until
    there are ``n_requests`` and ``min_tokens`` served tokens."""
    done = [r for r in records if r.result is not None and r.tokens]
    if not done:
        return []
    reqs = {r.index: traffic.request(r.index) for r in done}
    longest = max(done, key=lambda r: (len(reqs[r.index].prompt)
                                       + len(r.tokens), -r.index))
    doc = reqs[longest.index].doc
    pool = [r for r in done if r is not longest
            and (doc is None or reqs[r.index].doc == doc)]
    rng = np.random.default_rng(seed_words(seed) + [2])
    out, n_tok = [longest], len(longest.tokens)
    for j in rng.permutation(len(pool)):
        if len(out) >= n_requests and n_tok >= min_tokens:
            break
        out.append(pool[j])
        n_tok += len(pool[j].tokens)
    return out


def _sequences(ref: Reference, traffic, picked, chunk: int, device):
    """Yield (logits, served) of each picked request under ``ref``."""
    def t(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)
    reqs = [traffic.request(r.index) for r in picked]
    docs = {q.doc for q in reqs}
    past = {}
    for d in docs - {None}:
        doc = traffic.documents[d]
        past[d] = (len(doc), ref.forward(t(doc), keep_kv=True)[1])
    for r, q in zip(picked, reqs):
        served = np.asarray(r.tokens, np.int64)
        if q.doc is None:
            seq = np.concatenate([q.prompt, served[:-1]])
            logits, _ = ref.forward(
                t(seq), logits_from=len(q.prompt) - 1,
                groups=prompt_groups(len(q.prompt), chunk))
        else:
            start, kv = past[q.doc]
            seq = np.concatenate([q.prompt[start:], served[:-1]])
            logits, _ = ref.forward(t(seq), start=start, past=kv,
                                    logits_from=len(q.prompt) - start - 1)
        yield logits, t(served)


def readings(per_request, tail_gap: float | None) -> dict:
    """The numbers of a set of served tokens, from each request's gaps:
    their mean and widest, the share on the reference's argmax, the share
    whose gap exceeds ``tail_gap`` (``tail_share``), and the shares over
    each of ``GAP_STEPS`` (recorded, not compared)."""
    g = (torch.cat(per_request) if per_request
         else torch.zeros(0))
    n = max(int(g.numel()), 1)
    out = {"tokens": int(g.numel()),
           "mean_gap": float(g.sum()) / n,
           "max_gap": float(g.max()) if g.numel() else 0.0,
           "argmax_agree": int((g == 0).sum()) / n,
           "over": {str(t): int((g > t).sum()) / n for t in GAP_STEPS}}
    if tail_gap is not None:
        out["tail_share"] = int((g > tail_gap).sum()) / n
    return out


def judge(reading: dict | None, check: dict) -> dict:
    """Each number a cell's ``check`` gives a limit, beside that limit
    (``None`` where nothing was compared)."""
    return {name: {"value": None if reading is None else reading[name],
                   "limit": check[name]}
            for name in COMPARED if name in check}


def passes(checks: dict) -> bool:
    return all(c["value"] is not None and c["limit"] is not None
               and c["value"] <= c["limit"] for c in checks.values())


def compare(cfg: dict, params: dict, traffic, picked, softmax_precision: str,
            chunk: int, tail_gap: float | None,
            control: bool = False) -> dict:
    """The sample's readings (:func:`readings`), REXP's zeroed rows, the
    reference's seconds and each request's gaps (``gaps``); with
    ``control`` also the control's readings (``control``) and gaps
    (``control_gaps``): at each position, the gap of the token that the
    reference in fp8 puts first."""
    device = params["embed"]["table"].device
    t0 = time.perf_counter()
    ref = Reference(cfg, params, softmax_precision)
    per_request, ref_logits = [], []
    for logits, served in _sequences(ref, traffic, picked, chunk, device):
        per_request.append(gaps(logits, served).cpu())
        if control:
            ref_logits.append(logits)
    out = dict(readings(per_request, tail_gap), requests=len(picked),
               zero_rows=ref.rexp.zero_rows, rows=ref.rexp.rows,
               moe_dropped=ref.dropped, gaps=per_request)
    if control:
        low = Reference(cfg, params, softmax_precision, precision="fp8")
        cgaps = [gaps(base, logits.argmax(-1)).cpu()
                 for (logits, _), base in zip(
                     _sequences(low, traffic, picked, chunk, device),
                     ref_logits)]
        out["control"] = readings(cgaps, tail_gap)
        out["control_gaps"] = cgaps
    out["seconds"] = time.perf_counter() - t0
    return out
