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
from repro_torch.models import spmd
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


def _expert_counts(ef: torch.Tensor, e: int) -> torch.Tensor:
    """Assignments per expert, (e,) int64.  DTensor has no sharding rule
    for ``bincount`` (its output size depends on the data); there the
    count is a compare-and-sum, the same integers, reduced over the
    ranks that hold the tokens."""
    if not spmd.is_dtensor(ef):
        return torch.bincount(ef, minlength=e)
    experts = spmd.lift(torch.arange(e, device=ef.device), ef)
    return spmd.reduce_partial((ef[:, None] == experts[None, :]).sum(dim=0))


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
    counts = _expert_counts(ef, e)
    seg_start = torch.cumsum(counts, 0) - counts
    pos = (spmd.lift(torch.arange(n * k, device=idx.device), se)
           - seg_start[se])
    return order, se * c + pos, pos < c, c


def _experts(p: dict, h: torch.Tensor, dtype) -> torch.Tensor:
    """The capacity buffer (E, C, d) through each expert's SwiGLU,
    batched over E -> (E, C, d)."""
    hg = spmd.einsum("ecd,edf->ecf", h, p["w_gate"])
    hu = spmd.einsum("ecd,edf->ecf", h, p["w_up"])
    hh = F.silu(hg.float()).to(dtype) * hu
    return spmd.einsum("ecf,efd->ecd", hh, p["w_down"])


def _dense_experts(p, xf, gate, order, slot, keep, c, e):
    """Scatter the sorted assignments into the buffer, run the experts,
    gather each token's k outputs back and mix them by its gates."""
    n, d = xf.shape
    k = gate.shape[-1]
    tok = order // k
    buf = torch.zeros(e * c + 1, d, dtype=xf.dtype, device=xf.device)
    buf[torch.where(keep, slot, e * c)] = xf[tok]   # dropped -> spare row
    y = _experts(p, buf[:e * c].view(e, c, d), xf.dtype).reshape(e * c, d)
    contrib_sorted = (y[torch.clamp(slot, max=e * c - 1)]
                      * keep[:, None].to(y.dtype))
    inv = torch.empty_like(order)
    inv[order] = torch.arange(n * k, device=xf.device)
    contrib = contrib_sorted[inv].reshape(n, k, d)
    return (contrib * gate[..., None].to(y.dtype)).sum(dim=1)


def _sharded_experts(p, xf, gate, order, slot, keep, c, e):
    """:func:`_dense_experts` on DTensors, each rank on its block of the
    buffer, as GSPMD partitions the reference's: the experts split as
    ``w_gate`` splits them (expert parallel over the model axis), the
    capacity slots over every mesh dim that leaves ``w_gate`` whole (the
    data axes), so no rank holds the whole buffer or repeats another's
    expert work.  The capacity is padded to divide over those dims; a
    padded slot holds no token and is never read.  A rank fills its
    block from the tokens all-gathered over the data axes (the gather
    GSPMD inserts for an index into a sharded operand), and hands its
    outputs back by a scatter-add into (n, d) whose partial sums are
    reduce-scattered to the tokens' rows.  Values as the dense path's;
    the k outputs of a token are summed in another order."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    n, d = xf.shape
    k = gate.shape[-1]
    mesh = xf.device_mesh
    ph = [Shard(0) if isinstance(q, Shard) and q.dim == 0
          else Shard(1) if isinstance(q, Replicate) else Replicate()
          for q in p["w_gate"].placements]
    ways = math.prod(mesh.size(i) for i, q in enumerate(ph) if q == Shard(1))
    cp = -(-c // ways) * ways
    spare = e * cp
    whole = [Replicate()] * mesh.ndim
    # a product on one block is a partial sum over the mesh dims that
    # split the buffer, and so is a gradient that comes back through it
    part = [Partial() if isinstance(q, Shard) else Replicate() for q in ph]

    order, slot, keep = (t.full_tensor() for t in (order, slot, keep))
    slot = torch.where(keep, slot // c * cp + slot % c, spare)
    slot_token = torch.full((spare + 1,), n, device=slot.device)  # n: empty
    slot_token[slot] = order // k
    block = spmd.local_shard(slot_token[:spare].view(e, cp), mesh, ph)
    tok = block.clamp(max=n - 1)     # an empty slot reads row 0, masked
    x_all = xf.redistribute(mesh, whole).to_local(grad_placements=part)
    h = x_all[tok] * (block < n)[..., None].to(xf.dtype)
    del x_all       # every token on every rank: gone before the combine's
    h = DTensor.from_local(h, mesh, ph, run_check=False, shape=(e, cp, d),
                           stride=(cp * d, d, 1))
    y = spmd.reduce_partial(_experts(p, h, xf.dtype))
    y = y.redistribute(mesh, ph).to_local()

    g_all = gate.redistribute(mesh, whole).to_local(grad_placements=part)
    slot_gate = torch.zeros(spare + 1, dtype=g_all.dtype,
                            device=g_all.device).index_put(
        (slot,), g_all.reshape(-1)[order])
    w = spmd.local_shard(slot_gate[:spare].view(e, cp), mesh, ph)
    # an empty slot's gate is 0 (and its output too): it adds 0 to row 0
    out = torch.zeros(n, d, dtype=y.dtype, device=y.device)
    out.index_add_(0, tok.reshape(-1),
                   (y * w[..., None].to(y.dtype)).reshape(-1, d))
    return DTensor.from_local(out, mesh, part, run_check=False,
                              shape=(n, d), stride=(d, 1)
                              ).redistribute(mesh, xf.placements)


def moe_ffn(p: dict, x: torch.Tensor, cfg: ModelConfig):
    """x (..., d) -> (out (..., d), aux_loss fp32 scalar).  Every leading
    row is one token; capacity is reckoned from their number."""
    m = cfg.moe
    d = x.shape[-1]
    n = math.prod(x.shape[:-1])
    e, k = m.num_experts, m.top_k
    xf = spmd.pin(x.reshape(n, d))
    probs, gate, idx = route(p, xf, cfg)

    # ---- dispatch: rank within expert segment via sort -------------------
    order, slot, keep, c = dispatch(idx, n, cfg)
    # ---- experts (batched over E), combine -------------------------------
    experts = (_sharded_experts if spmd.is_dtensor(xf) else _dense_experts)
    out = experts(p, xf, gate, order, slot, keep, c, e)

    if "shared" in p:
        out = out + swiglu(xf, **p["shared"])

    # ---- Switch-style aux load-balance loss --------------------------------
    frac_tokens = (_expert_counts(idx.reshape(-1), e).float()
                   / (n * k))
    aux = m.router_aux_loss * e * torch.sum(frac_tokens * probs.mean(dim=0))
    return out.reshape(x.shape), aux
