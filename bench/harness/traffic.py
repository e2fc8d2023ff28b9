"""The one traffic generator: reads a mix's parameters (``traffic/*.json``)
and the seed, and gives the documents and the request stream.

Every seed gets the same work in the same stretch of the stream: the
stream is cut into blocks of ``block`` requests, and each block holds one
length from each of ``block`` equal strata of the distribution (the
strata's quantiles on a fixed grid, dealt to the blocks in a fixed
order).  The seed only orders the requests within each block and draws
every token id, so a window of any length sees the same sizes whatever
the seed.  Where the mix has documents, each block asks about each
document equally often.

A mix is a closed loop: one client per decode slot, each sending its next
request when its stream ends.  Keys of a mix:

* ``documents`` (optional): ``count`` documents of lengths evenly spaced
  from ``min`` to ``max``, prefilled into the prefix cache at set-up;
  each request is one of them followed by a ``question``;
* ``prompt``: the prompt's length, when there are no documents;
* ``output``: the tokens each request asks for (greedy, no end token);
* ``block``: the requests that make up one block.

A length is ``{"dist": "lognormal", "median", "sigma", "min", "max"}``,
clipped to [min, max], or ``{"dist": "choice", "values": [...]}``, each
value equally often.  Other keys (``source``, ``assumed``, ``cut``) say
where the numbers come from and are not read.
"""

from __future__ import annotations

import statistics
from dataclasses import dataclass

import numpy as np

#: requests drawn a run: more than any window consumes
POOL = 8192
#: the fixed order in which the strata's lengths are dealt to the blocks
DEAL_SEED = 0x5EED


def seed_words(seed: int) -> list[int]:
    """A seed of any size or sign as numpy's seed words."""
    seed = int(seed) % (1 << 64)
    return [seed & 0xFFFFFFFF, seed >> 32]


def quantile_sizes(spec: dict, n: int) -> np.ndarray:
    """``n`` lengths in ascending order: the distribution's quantiles
    (i + 1/2) / n, or a choice's values each n / len(values) times."""
    if spec["dist"] == "choice":
        return np.sort(np.resize(np.asarray(spec["values"], np.int64), n))
    if spec["dist"] != "lognormal":
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    z = statistics.NormalDist()
    mu = np.log(spec["median"])
    x = [np.exp(mu + spec["sigma"] * z.inv_cdf((i + 0.5) / n))
         for i in range(n)]
    return np.clip(np.rint(x), spec["min"], spec["max"]).astype(np.int64)


def document_sizes(spec: dict) -> np.ndarray:
    n = spec["count"]
    return np.rint(np.linspace(spec["min"], spec["max"], n)).astype(np.int64)


def blocked(values: np.ndarray, block: int, rng) -> np.ndarray:
    """``values`` (ascending, a multiple of ``block`` long) as a stream of
    blocks, each one value from each of ``block`` equal strata in the
    fixed deal, ordered within the block by ``rng``."""
    strata = values.reshape(block, -1)
    deal = np.random.default_rng(DEAL_SEED)
    strata = np.stack([s[deal.permutation(s.size)] for s in strata])
    blocks = strata.T.copy()
    order = np.argsort(rng.random(blocks.shape), axis=1)
    return np.take_along_axis(blocks, order, axis=1).reshape(-1)


@dataclass
class Request:
    index: int
    prompt: np.ndarray        # int32 token ids
    max_new_tokens: int
    doc: int | None           # which document opens the prompt
    body: int                 # tokens after the document (all, without)


class Traffic:
    """The documents and the request stream of one mix and seed."""

    def __init__(self, mix: dict, seed: int, vocab: int, pool: int = POOL):
        self.mix = mix
        self.seed = seed
        self.vocab = vocab
        block = int(mix["block"])
        if pool % block:
            raise ValueError(f"a block of {block} does not divide {pool}")
        rng = np.random.default_rng(seed_words(seed))
        self.documents: list[np.ndarray] = []
        docs = mix.get("documents")
        if docs:
            if block % docs["count"]:
                raise ValueError(f"a block of {block} cannot ask about "
                                 f"{docs['count']} documents equally")
            self.documents = [rng.integers(0, vocab, int(n), dtype=np.int32)
                              for n in document_sizes(docs)]
            self.doc_of = blocked(np.sort(np.arange(pool) % docs["count"]),
                                  block, rng)
            body = mix["question"]
        else:
            self.doc_of = None
            body = mix["prompt"]
        self.body = blocked(quantile_sizes(body, pool), block, rng)
        self.out = blocked(quantile_sizes(mix["output"], pool), block, rng)
        self.pool = pool

    def request(self, i: int) -> Request:
        """The ``i``-th request of the stream (the same for one seed)."""
        if i >= self.pool:
            raise IndexError(f"request {i}: the stream holds {self.pool}")
        rng = np.random.default_rng(seed_words(self.seed) + [1, i])
        body = rng.integers(0, self.vocab, int(self.body[i]), dtype=np.int32)
        doc = None
        if self.doc_of is not None:
            doc = int(self.doc_of[i])
            prompt = np.concatenate([self.documents[doc], body])
        else:
            prompt = body
        return Request(i, prompt, int(self.out[i]), doc, len(body))

    def max_context(self) -> int:
        doc = max((len(d) for d in self.documents), default=0)
        return doc + int(self.body.max()) + int(self.out.max())
