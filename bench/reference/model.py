"""The benchmark's plain reference of the served decoders: InternLM2-style
dense GQA and DeepSeek-MoE-style routed experts, one sequence at a time,
layer by layer, in plain PyTorch.  It imports nothing of the program.

It reads the weights that the harness drew (``harness.weights``: the
parameter tree the program is handed, leaves stacked over the layers) and
the configuration file, and computes in the configuration's precision,
bf16 weights and activations:

* embedding rows cast to bf16; RMSNorm in f32, cast back;
* q, k, v = h @ W (bf16 operands, f32 accumulation, bf16 result); rotary
  embedding on the halves of each head (theta from the file) in f32, cast
  back; causal REXP attention (``rexp.Rexp``) over f32 logits of the
  bf16 q and k, times 1/sqrt(head_dim); its f32 output cast to bf16,
  then @ wo;
* SwiGLU MLP: silu(h @ w_gate) in f32, cast, times h @ w_up, @ w_down;
* MoE: a softmax over f32 router logits, the top k experts (the lower
  index first among equal probabilities), gates renormalised by their
  sum; GShard capacity within each group of prompt tokens (a prompt
  chunk of the cell), the assignments in (token, k) order, those past
  the capacity dropped; each expert a SwiGLU of its own width; the gated
  sum in f32 of the experts' bf16 outputs with bf16 gates, cast to bf16,
  plus the shared experts' SwiGLU;
* the final RMSNorm, then the head's f32 logits.

``precision="fp8"`` is the control: every matrix product's operands, the
attention's q, k and v among them, rounded to float8 e4m3 (per row of an
activation, per output column of a weight, scaled to the format's range)
before the product, everything else as above.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from reference.rexp import Rexp

F8_MAX = 448.0


def fp8_round(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale per slice along
    ``dim``, returned in ``t``'s dtype."""
    s = t.abs().amax(dim=dim, keepdim=True).float().clamp(min=1e-30) / F8_MAX
    return ((t.float() / s).to(torch.float8_e4m3fn).float() * s).to(t.dtype)


@dataclass(frozen=True)
class Dims:
    layers: int
    d_model: int
    heads: int
    kv_heads: int
    head_dim: int
    rope_theta: float
    eps: float
    experts: int = 0
    top_k: int = 0
    shared: int = 0

    @staticmethod
    def from_file(cfg: dict) -> "Dims":
        return Dims(layers=cfg["num_hidden_layers"],
                    d_model=cfg["hidden_size"],
                    heads=cfg["num_attention_heads"],
                    kv_heads=cfg["num_key_value_heads"],
                    head_dim=cfg["head_dim"],
                    rope_theta=float(cfg["rope_theta"]),
                    eps=float(cfg["rms_norm_eps"]),
                    experts=cfg.get("n_routed_experts", 0),
                    top_k=cfg.get("num_experts_per_tok", 0),
                    shared=cfg.get("n_shared_experts", 0))


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float):
    xf = x.float()
    y = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
    return (y * scale.float()).to(x.dtype)


def rotate(x: torch.Tensor, start: int, theta: float) -> torch.Tensor:
    """x (heads, L, Dh) at positions start.. → rotary-embedded, same
    dtype: the first and second halves of each head are the pairs."""
    dh = x.shape[-1]
    half = dh // 2
    inv_freq = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                             device=x.device) / half))
    pos = torch.arange(start, start + x.shape[1], dtype=torch.float32,
                       device=x.device)
    ang = pos[:, None] * inv_freq[None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    a, b = x[..., :half].float(), x[..., half:].float()
    return torch.cat([a * cos - b * sin, b * cos + a * sin], -1).to(x.dtype)


def capacity(group: int, experts: int, top_k: int,
             factor: float = 1.25) -> int:
    """GShard's slots an expert has in a group of ``group`` tokens, never
    below min(group, 256) (the capacity rule the configuration states)."""
    return max(int(factor * top_k * group / experts), min(group, 256))


class Reference:
    """The reference forward over the harness's weights ``params``."""

    def __init__(self, cfg: dict, params: dict, softmax_precision: str,
                 precision: str = "bf16", block_elems: int = 1 << 27):
        self.d = Dims.from_file(cfg)
        self.p = params
        self.fp8 = precision == "fp8"
        dev = params["embed"]["table"].device
        self.rexp = Rexp(softmax_precision, dev)
        self.block_elems = block_elems
        self.layer = params["periods"][0]
        self.moe = self.d.experts > 0
        self.dtype = params["embed"]["table"].dtype
        #: MoE assignments dropped past an expert's capacity, every call
        self.dropped = 0

    # -- products ----------------------------------------------------------

    def mm(self, a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        w = w.to(a.dtype)
        if self.fp8:
            a, w = fp8_round(a, -1), fp8_round(w, -2)
        return a @ w

    def swiglu(self, h, w_gate, w_up, w_down):
        g = self.mm(h, w_gate)
        u = self.mm(h, w_up)
        return self.mm(F.silu(g.float()).to(h.dtype) * u, w_down)

    # -- layers ------------------------------------------------------------

    def attention(self, i: int, h: torch.Tensor, start: int, past):
        d, lp = self.d, self.layer["mixer"]
        n = h.shape[0]
        q = self.mm(h, lp["wq"][i]).view(n, d.heads, d.head_dim)
        k = self.mm(h, lp["wk"][i]).view(n, d.kv_heads, d.head_dim)
        v = self.mm(h, lp["wv"][i]).view(n, d.kv_heads, d.head_dim)
        q = rotate(q.transpose(0, 1), start, d.rope_theta)
        k = rotate(k.transpose(0, 1), start, d.rope_theta)
        v = v.transpose(0, 1)
        if past is not None:
            k = torch.cat([past[0], k], 1)
            v = torch.cat([past[1], v], 1)
        qa, ka, va = q, k, v
        if self.fp8:
            qa, ka, va = (fp8_round(t, -1) for t in (q, k, v))
        o = self.rexp.attention(qa, ka, va, start, d.head_dim ** -0.5,
                                self.block_elems)
        o = o.to(h.dtype).transpose(0, 1).reshape(n, d.heads * d.head_dim)
        return self.mm(o, lp["wo"][i]), (k, v)

    def moe_ffn(self, i: int, h: torch.Tensor, groups) -> torch.Tensor:
        """``groups``: (start, end, call_tokens) row ranges that shared a
        capacity group in the program's call of ``call_tokens`` rows;
        rows in no range never drop."""
        d, fp = self.d, self.layer["ffn"]
        n = h.shape[0]
        logits = h.float() @ fp["router"][i].float()
        probs = torch.softmax(logits, dim=-1)
        vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
        vals, idx = vals[:, :d.top_k], idx[:, :d.top_k]
        gates = vals / vals.sum(-1, keepdim=True).clamp(min=1e-9)
        kept = torch.ones_like(idx, dtype=torch.bool)
        for a, b, call in groups:
            cap = capacity(min(4096, call), d.experts, d.top_k)
            flat = idx[a:b].reshape(-1)
            onehot = F.one_hot(flat, d.experts)
            rank = (torch.cumsum(onehot, 0) - onehot).gather(
                1, flat[:, None])[:, 0]
            kept[a:b] = (rank < cap).view(b - a, d.top_k)
        out = torch.zeros((n, d.d_model), dtype=torch.float32,
                          device=h.device)
        w = torch.where(kept, gates, torch.zeros_like(gates)).to(h.dtype)
        for e in range(d.experts):
            rows, slot = torch.nonzero((idx == e) & kept, as_tuple=True)
            if rows.numel() == 0:
                continue
            y = self.swiglu(h[rows], fp["w_gate"][i, e], fp["w_up"][i, e],
                            fp["w_down"][i, e])
            out.index_add_(0, rows, w[rows, slot].float()[:, None]
                           * y.float())
        y = out.to(h.dtype)
        if d.shared:
            sp = fp["shared"]
            y = y + self.swiglu(h, sp["w_gate"][i], sp["w_up"][i],
                                sp["w_down"][i])
        self.dropped += int((~kept).sum())
        return y

    # -- the forward -------------------------------------------------------

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor, start: int = 0, past=None,
                keep_kv: bool = False, logits_from: int | None = None,
                groups=()):
        """Run ``tokens`` (L,) at positions ``start``.. after the cached
        ``past`` (one (k, v) pair a layer, the sequence's first ``start``
        positions).  Returns ``(logits, kv)``: f32 logits (L - logits_from,
        V) of the rows from ``logits_from`` on (None when it is None), and
        with ``keep_kv`` the layers' (k, v) of every position."""
        d = self.d
        x = self.p["embed"]["table"][tokens].to(self.dtype)
        kv = [] if keep_kv else None
        for i in range(d.layers):
            h = rms_norm(x, self.layer["norm1"]["scale"][i], d.eps)
            a, pair = self.attention(i, h, start,
                                     None if past is None else past[i])
            if keep_kv:
                kv.append(pair)
            x = x + a
            h = rms_norm(x, self.layer["norm2"]["scale"][i], d.eps)
            if self.moe:
                x = x + self.moe_ffn(i, h, groups)
            else:
                fp = self.layer["ffn"]
                x = x + self.swiglu(h, fp["w_gate"][i], fp["w_up"][i],
                                    fp["w_down"][i])
        logits = None
        if logits_from is not None:
            h = rms_norm(x[logits_from:], self.p["final_norm"]["scale"],
                         d.eps)
            logits = self.mm(h, self.p["head"]["w"]).float()
        return logits, kv


def prompt_groups(prompt_len: int, chunk: int, first: int = 0):
    """The capacity groups of a prompt walked in chunks of ``chunk`` rows
    from position ``first``: each chunk is one call of ``chunk`` rows."""
    return [(a, min(a + chunk, prompt_len), chunk)
            for a in range(first, prompt_len, chunk)]


def gaps(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """How far each served token's logit lies below the row's best."""
    return logits.max(-1).values - logits.gather(1, tokens[:, None])[:, 0]
