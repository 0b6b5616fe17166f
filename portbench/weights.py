"""Seeded random weights, made on the device in a few large calls.

The benchmark makes the weights itself, in the port's parameter layout
(``reference/model.py`` lists it), and hands the same tensors to the port
and to the reference.  Matrices are normal(0, 1 / d_in), the embedding
normal(0, 0.02) and the router normal(0, 1 / d) as the port's own
initialiser draws them; norm scales are normal(0, 0.1), so that the
``1 + scale`` of every norm is exercised.  Every matrix of the served
dtype is a view into one buffer filled by one ``normal_`` call, every
float32 leaf (norms, router) a view into a second.
"""
from __future__ import annotations

import math

import torch

from portbench.reference.spec import Arch

NORM_STD = 0.1
EMBED_STD = 0.02


def _leaves(a: Arch):
    """(path, shape, group, std) of every leaf; group "w" is the served
    dtype, "f" float32."""
    d, hd, n = a.d_model, a.head_dim, a.layers
    out = [(("embed",), (a.vocab, d), "w", EMBED_STD)]
    if not a.tied:
        out.append((("lm_head",), (d, a.vocab), "w", d ** -0.5))
    out.append((("final_norm",), (d,), "f", NORM_STD))
    lay = ("layers",)
    out += [(lay + ("ln1",), (n, d), "f", NORM_STD),
            (lay + ("ln2",), (n, d), "f", NORM_STD),
            (lay + ("attn", "wq"), (n, d, a.heads * hd), "w", d ** -0.5),
            (lay + ("attn", "wk"), (n, d, a.kv_heads * hd), "w", d ** -0.5),
            (lay + ("attn", "wv"), (n, d, a.kv_heads * hd), "w", d ** -0.5),
            (lay + ("attn", "wo"), (n, a.heads * hd, d), "w",
             (a.heads * hd) ** -0.5)]
    if a.qk_norm:
        out += [(lay + ("attn", "q_norm"), (n, hd), "f", NORM_STD),
                (lay + ("attn", "k_norm"), (n, hd), "f", NORM_STD)]
    if a.moe is None:
        f = a.d_ff
        out += [(lay + ("ffn", "w_gate"), (n, d, f), "w", d ** -0.5),
                (lay + ("ffn", "w_up"), (n, d, f), "w", d ** -0.5),
                (lay + ("ffn", "w_down"), (n, f, d), "w", f ** -0.5)]
    else:
        m = a.moe
        e, f = m.num_experts, m.d_expert
        out += [(lay + ("moe", "router"), (n, d, e), "f", d ** -0.5),
                (lay + ("moe", "w_gate"), (n, e, d, f), "w", d ** -0.5),
                (lay + ("moe", "w_up"), (n, e, d, f), "w", d ** -0.5),
                (lay + ("moe", "w_down"), (n, e, f, d), "w", f ** -0.5)]
        if m.d_shared:
            s = m.d_shared
            out += [(lay + ("moe", "shared", "w_gate"), (n, d, s), "w",
                     d ** -0.5),
                    (lay + ("moe", "shared", "w_up"), (n, d, s), "w",
                     d ** -0.5),
                    (lay + ("moe", "shared", "w_down"), (n, s, d), "w",
                     s ** -0.5)]
    return out


def count_params(a: Arch) -> int:
    return sum(math.prod(shape) for _, shape, _, _ in _leaves(a))


def make_weights(a: Arch, seed: int, device) -> dict:
    """The weight dict of ``a`` drawn from ``seed`` on ``device``."""
    dtypes = {"w": getattr(torch, a.dtype), "f": torch.float32}
    leaves = _leaves(a)
    gen = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
    bufs = {}
    for g, dt in dtypes.items():
        total = sum(math.prod(s) for _, s, gg, _ in leaves if gg == g)
        bufs[g] = torch.empty(total, dtype=dt, device=device).normal_(
            generator=gen)
    weights, offs = {}, {g: 0 for g in dtypes}
    for path, shape, g, std in leaves:
        n = math.prod(shape)
        t = bufs[g][offs[g]:offs[g] + n].view(shape).mul_(std)
        offs[g] += n
        node = weights
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = t
    return weights
