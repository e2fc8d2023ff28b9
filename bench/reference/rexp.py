"""REXP (the paper's Algorithm 1) in plain PyTorch, for the benchmark's
reference.  A frozen copy of the table construction and of the integer
semantics, written apart from the program so that a change there cannot
move the yardstick:

    d_i     = max(x) - x_i
    e_i     = LUT_1/e[clamp(round(d_i), 0, n_e - 1)]       (integers)
    S       = sum_j e_j
    a       = LUT_a[clamp(round(S / qmax), 0, x_s)]
    sigma_i = round(e_i * a / qmax) / qmax

``round`` is round half to even, and every division by a table constant is
a multiply by its f32 reciprocal.  A row whose S / qmax reaches the last
bin of LUT_a gets a = 0: every weight of the row is zero.
"""

from __future__ import annotations

import math

import numpy as np
import torch

#: paper Table 8, NLP: LUT_a has 16 entries at every precision but uint2
ALPHA_LEN = 16
#: value bits per entry (paper Tables 5 and 8)
BITS = {"int16": 15, "uint8": 8, "uint4": 4, "uint2": 2}


def qmax_of(precision: str) -> int:
    return (1 << BITS[precision]) - 1


def lut_recip_exp(precision: str) -> np.ndarray:
    """round(e^-i * qmax) for i = 0, 1, ... up to and including the first
    zero entry, at most ceil(ln qmax) + 2 entries (Eq. 4)."""
    q = qmax_of(precision)
    out = []
    for i in range(math.ceil(math.log(q)) + 2):
        out.append(int(np.rint(math.exp(-i) * q)))
        if out[-1] == 0:
            break
    return np.asarray(out, np.int64)


def lut_alpha(precision: str, length: int = ALPHA_LEN) -> np.ndarray:
    """qmax at index 0, round(qmax / j) at index j, 0 at the last index
    (Eq. 7)."""
    q = qmax_of(precision)
    out = [q] + [int(np.rint(q / j)) for j in range(1, length)]
    out[-1] = 0
    return np.asarray(out, np.int64)


def f32_recip(c: float) -> float:
    return float(np.float32(1.0 / c))


class Rexp:
    """The REXP tables of one precision on one device, and the attention
    that uses them.  ``zero_rows`` / ``rows`` count, over every call, the
    rows whose weights all came out zero and the rows computed."""

    def __init__(self, precision: str, device):
        self.qmax = qmax_of(precision)
        self.inv = f32_recip(self.qmax)
        self.lut_e = torch.as_tensor(lut_recip_exp(precision),
                                     dtype=torch.float32, device=device)
        self.lut_a = torch.as_tensor(lut_alpha(precision),
                                     dtype=torch.float32, device=device)
        self.zero_rows = 0
        self.rows = 0

    def weights_int(self, s: torch.Tensor) -> torch.Tensor:
        """f32 logits (..., Lk), -inf where masked → the integer weights
        round(e * a / qmax) as f32, in place of ``s`` where it can."""
        n_e = self.lut_e.numel()
        m = torch.amax(s, dim=-1, keepdim=True)
        torch.sub(m, s, out=s)                 # d >= 0; +inf where masked
        s.clamp_(max=float(n_e - 1)).round_()
        e = self.lut_e[s.long()]
        total = e.sum(dim=-1, keepdim=True)
        ai = torch.clamp(torch.round(total * self.inv), 0,
                         self.lut_a.numel() - 1)
        self.zero_rows += int((ai == self.lut_a.numel() - 1).sum())
        self.rows += ai.numel()
        alpha = self.lut_a[ai.long()]
        return e.mul_(alpha).mul_(self.inv).round_()

    def attention(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  start: int, scale: float,
                  block_elems: int = 1 << 27) -> torch.Tensor:
        """Causal REXP attention of one sequence.

        q (H, Lq, Dh), the queries at positions ``start`` .. ``start + Lq
        - 1``; k, v (KVH, Lk, Dh), key j at position j, Lk >= start + Lq.
        Query head h reads KV head h // (H / KVH).  Logits are f32 products
        of the operands' values.  Returns (H, Lq, Dh) f32.  Rows are taken
        in blocks of at most about ``block_elems`` logits.
        """
        h, lq, dh = q.shape
        kvh = k.shape[0]
        g = h // kvh
        qf = q.float().view(kvh, g, lq, dh)
        kt = k.float().transpose(1, 2)
        vf = v.float()
        out = torch.empty((kvh, g, lq, dh), dtype=torch.float32,
                          device=q.device)
        r0 = 0
        while r0 < lq:
            rows = max(1, block_elems // (h * (start + r0 + 1)))
            while rows > 1 and h * rows * (start + min(lq, r0 + rows)) \
                    > block_elems:
                rows //= 2
            r1 = min(lq, r0 + rows)
            n_keys = start + r1
            qb = qf[:, :, r0:r1].reshape(kvh, g * (r1 - r0), dh)
            s = torch.bmm(qb, kt[:, :, :n_keys]).mul_(scale)
            s = s.view(kvh, g, r1 - r0, n_keys)
            first = start + r0 + 1
            if first < n_keys:
                ki = torch.arange(first, n_keys, device=q.device)
                qi = torch.arange(start + r0, start + r1, device=q.device)
                s[..., first:].masked_fill_(ki[None, :] > qi[:, None],
                                            float("-inf"))
            w = self.weights_int(s.view(kvh, g * (r1 - r0), n_keys))
            o = torch.bmm(w, vf[:, :n_keys]).mul_(self.inv)
            out[:, :, r0:r1] = o.view(kvh, g, r1 - r0, dh)
            r0 = r1
        return out.view(h, lq, dh)
