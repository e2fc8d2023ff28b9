"""Weights drawn on the device from the seed, one call a leaf, in the type
they are served in, laid out as the program's parameter tree (each layer
leaf stacked over the layers).  The program and the reference are handed
the same tensors.

Each matrix is normal with std 1/sqrt(fan_in); the embedding's std is
the configuration's ``embed_init_std``; norm scales are 1; the router
stays f32.  ``wq`` and ``wk`` are
further multiplied by the configuration's ``qk_init_scale``, which sets
the spread of the pre-softmax logits, and each residual branch's last
projection (``wo``, every ``w_down``) by its ``out_init_scale`` (see the
file's ``assumed``).
"""

from __future__ import annotations

import math

import torch


def leaf_shapes(cfg: dict) -> dict:
    """path → (shape, fan_in or None for ones / the embedding, f32?)."""
    n, d = cfg["num_hidden_layers"], cfg["hidden_size"]
    h, kvh, dh = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                  cfg["head_dim"])
    v = cfg["vocab_size"]
    out = {
        "embed/table": ((v, d), "embed", False),
        "periods/0/norm1/scale": ((n, d), None, True),
        "periods/0/mixer/wq": ((n, d, h * dh), d, False),
        "periods/0/mixer/wk": ((n, d, kvh * dh), d, False),
        "periods/0/mixer/wv": ((n, d, kvh * dh), d, False),
        "periods/0/mixer/wo": ((n, h * dh, d), h * dh, False),
        "periods/0/norm2/scale": ((n, d), None, True),
        "final_norm/scale": ((d,), None, True),
        "head/w": ((d, v), d, False),
    }
    e = cfg.get("n_routed_experts", 0)
    if e:
        f = cfg["moe_intermediate_size"]
        fs = f * cfg["n_shared_experts"]
        out.update({
            "periods/0/ffn/router": ((n, d, e), d, True),
            "periods/0/ffn/w_gate": ((n, e, d, f), d, False),
            "periods/0/ffn/w_up": ((n, e, d, f), d, False),
            "periods/0/ffn/w_down": ((n, e, f, d), f, False),
        })
        if fs:
            out.update({
                "periods/0/ffn/shared/w_up": ((n, d, fs), d, False),
                "periods/0/ffn/shared/w_down": ((n, fs, d), fs, False),
                "periods/0/ffn/shared/w_gate": ((n, d, fs), d, False),
            })
    else:
        f = cfg["intermediate_size"]
        out.update({
            "periods/0/ffn/w_up": ((n, d, f), d, False),
            "periods/0/ffn/w_down": ((n, f, d), f, False),
            "periods/0/ffn/w_gate": ((n, d, f), d, False),
        })
    return out


def _put(tree: dict, path: str, leaf) -> None:
    """Set ``tree[path]``, a digit key indexing a list."""
    keys = path.split("/")
    node = tree
    for i, k in enumerate(keys[:-1]):
        child = [] if keys[i + 1].isdigit() else {}
        if isinstance(node, list):
            while len(node) <= int(k):
                node.append(child)
            node = node[int(k)]
        else:
            node = node.setdefault(k, child)
    node[keys[-1]] = leaf


def draw_params(cfg: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """The parameter tree of ``cfg`` drawn from ``seed`` on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 64))
    qk = float(cfg["assumed"]["qk_init_scale"])
    out = float(cfg["assumed"]["out_init_scale"])
    tree: dict = {}
    for path, (shape, fan_in, f32) in sorted(leaf_shapes(cfg).items()):
        dt = torch.float32 if f32 else dtype
        if fan_in is None:
            leaf = torch.ones(shape, dtype=dt, device=device)
        else:
            leaf = torch.randn(shape, generator=gen, dtype=dt, device=device)
            std = (float(cfg["assumed"]["embed_init_std"])
                   if fan_in == "embed" else 1.0 / math.sqrt(fan_in))
            if path.endswith(("/wq", "/wk")):
                std *= qk
            elif path.endswith(("/wo", "/w_down")):
                std *= out
            leaf.mul_(std)
        _put(tree, path, leaf)
    return tree
