"""Mixture-of-Experts FFN with capacity-bounded sort-scatter dispatch.

The JAX package's ``models/moe.py``, op for op: tokens are ranked inside
their expert segment by one stable argsort and a bincount, scattered into
a dense (E, C, d) buffer, run through one batched matrix product per
expert weight, and gathered back; the Switch-style aux load-balance loss
comes out beside the output.  An assignment ranked past the capacity C
is dropped, as the reference's ``mode="drop"`` scatter drops it: here it
lands in one spare buffer row that is sliced off.

Capacity depends on the number of rows the function receives, padding
rows included, and padding rows are routed like any other: what a row
gets depends on what it is batched with, as in the reference.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dense_init, init_ffn, swiglu


def init_moe(generator: torch.Generator, cfg: ModelConfig, dtype, device,
             lead: Tuple[int, ...] = ()) -> dict:
    """The reference's ``init_moe`` layout: an fp32 router (d, E), expert
    weights (E, d, f) / (E, f, d) in ``dtype`` drawn as normal(0, 1/d_in),
    and the always-on shared FFN when the config has one."""
    m = cfg.moe
    d = cfg.d_model
    p = {
        "router": dense_init(generator, d, m.num_experts, torch.float32,
                             device, lead),
        "w_gate": dense_init(generator, d, m.d_expert, dtype, device,
                             (*lead, m.num_experts)),
        "w_up": dense_init(generator, d, m.d_expert, dtype, device,
                           (*lead, m.num_experts)),
        "w_down": dense_init(generator, m.d_expert, d, dtype, device,
                             (*lead, m.num_experts)),
    }
    if m.num_shared_experts:
        d_sh = m.d_shared or m.num_shared_experts * m.d_expert
        p["shared"] = init_ffn(generator, d, d_sh, dtype, device, lead)
    return p


def capacity(n_tokens: int, cfg: ModelConfig) -> int:
    m = cfg.moe
    c = int(n_tokens * m.top_k * m.capacity_factor / m.num_experts) + 1
    return max(8, min(c, n_tokens))


def route(p: dict, xf: torch.Tensor, cfg: ModelConfig):
    """xf (n, d) -> (probs (n, E) fp32, gate (n, k) renormalised, idx
    (n, k)).  The top k come from a stable descending sort, so equal
    probabilities pick the lower expert index first, as ``lax.top_k``
    does."""
    k = cfg.moe.top_k
    probs = torch.softmax(xf.float() @ p["router"], dim=-1)
    top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = top[:, :k], idx[:, :k]
    gate = gate / torch.clamp(gate.sum(dim=-1, keepdim=True), min=1e-9)
    return probs, gate, idx


def dispatch(idx: torch.Tensor, n: int, cfg: ModelConfig):
    """Rank each of the n*k assignments inside its expert's segment.
    Returns (order: the stable sort of the flat expert ids, slot: each
    sorted assignment's buffer row ``expert * C + rank``, keep: rank < C,
    C)."""
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    c = capacity(n, cfg)
    ef = idx.reshape(-1)
    order = torch.argsort(ef, stable=True)
    se = ef[order]
    counts = torch.bincount(ef, minlength=e)
    seg_start = torch.cumsum(counts, 0) - counts
    pos = torch.arange(n * k, device=idx.device) - seg_start[se]
    return order, se * c + pos, pos < c, c


def moe_ffn(p: dict, x: torch.Tensor, cfg: ModelConfig):
    """x (..., d) -> (out (..., d), aux_loss fp32 scalar).  Every leading
    row is one token; capacity is reckoned from their number."""
    m = cfg.moe
    d = x.shape[-1]
    n = math.prod(x.shape[:-1])
    e, k = m.num_experts, m.top_k
    xf = x.reshape(n, d)
    probs, gate, idx = route(p, xf, cfg)

    # ---- dispatch: rank within expert segment via sort -------------------
    order, slot, keep, c = dispatch(idx, n, cfg)
    tok = order // k
    buf = torch.zeros(e * c + 1, d, dtype=x.dtype, device=x.device)
    buf[torch.where(keep, slot, e * c)] = xf[tok]   # dropped -> spare row
    h = buf[:e * c].view(e, c, d)

    # ---- expert computation (batched over E) -----------------------------
    hg = torch.bmm(h, p["w_gate"])
    hu = torch.bmm(h, p["w_up"])
    hh = F.silu(hg.float()).to(x.dtype) * hu
    y = torch.bmm(hh, p["w_down"]).reshape(e * c, d)

    # ---- combine ----------------------------------------------------------
    contrib_sorted = (y[torch.clamp(slot, max=e * c - 1)]
                      * keep[:, None].to(y.dtype))
    inv = torch.empty_like(order)
    inv[order] = torch.arange(n * k, device=x.device)
    contrib = contrib_sorted[inv].reshape(n, k, d)
    out = (contrib * gate[..., None].to(y.dtype)).sum(dim=1)

    if "shared" in p:
        out = out + swiglu(xf, **p["shared"])

    # ---- Switch-style aux load-balance loss --------------------------------
    frac_tokens = (torch.bincount(idx.reshape(-1), minlength=e).float()
                   / (n * k))
    aux = m.router_aux_loss * e * torch.sum(frac_tokens * probs.mean(dim=0))
    return out.reshape(x.shape), aux
