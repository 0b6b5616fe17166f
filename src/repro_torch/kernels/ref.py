"""Plain PyTorch versions of the attention kernels.

These are the correctness references: the CPU path of every kernel
wrapper, and what ``chip_smoke.py`` holds each CUDA kernel against on the
card.  They keep the rounding points of the JAX oracles: scores are
computed in the input dtype and then cast to fp32, softmax runs in fp32,
and the probabilities are cast to v's dtype before the PV product.

``paged_attention_split_ref`` and ``ragged_segment_attention_tiled_ref``
instead repeat the CUDA kernels' algorithms in fp32 (split partials and
their merge; an online softmax over key tiles), so that the tests can
hold those algorithms against the JAX oracles on the CPU.

Every gather here indexes in range by construction (block tables are
padded with valid ids, padding positions are 0); a torch gather raises
on an out-of-range index where a JAX gather would clamp it.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def paged_attention_ref(q: torch.Tensor,
                        k_pool: torch.Tensor,
                        v_pool: torch.Tensor,
                        block_tables: torch.Tensor,
                        context_lens: torch.Tensor) -> torch.Tensor:
    """Decode attention over a paged KV cache.

    q:            (B, KV, G, hd)   — grouped queries (H = KV*G)
    k_pool/v_pool:(N_blocks, bs, KV, hd)
    block_tables: (B, max_blocks)  int32 physical block ids
    context_lens: (B,)             int32 valid tokens per sequence
    returns:      (B, KV, G, hd)
    """
    b, kv, g, hd = q.shape
    bs = k_pool.shape[1]
    s_max = block_tables.shape[1] * bs
    bt = block_tables.long()
    k = k_pool[bt].reshape(b, s_max, kv, hd)
    v = v_pool[bt].reshape(b, s_max, kv, hd)
    scores = torch.einsum("bkgd,btkd->bkgt", q, k).float() / (hd ** 0.5)
    valid = (torch.arange(s_max, device=q.device)[None, :]
             < context_lens.long()[:, None])                       # (B, S)
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", probs.to(v.dtype), v)
    return out.to(q.dtype)


def ragged_segment_attention_ref(q: torch.Tensor,
                                 k_pool: torch.Tensor,
                                 v_pool: torch.Tensor,
                                 block_tables: torch.Tensor,
                                 positions: torch.Tensor) -> torch.Tensor:
    """Segment-blocked causal attention for a fused ragged iteration batch.

    Query (s, j) sits at absolute position ``positions[s, j]`` of its
    sequence and attends the pool-resident KV of *its own* sequence at
    positions ``<= positions[s, j]`` through its segment's block table —
    never across segments.  The chunk's fresh KV must already be in the
    pool (the fused runner writes before attending).  Padding rows sit at
    position 0 and produce values the caller discards.

    q:            (S, L, KV, G, hd) — grouped queries, tiled per segment
    k_pool/v_pool:(N_blocks, bs, KV, hd)
    block_tables: (S, max_blocks)   int32 — one table per segment
    positions:    (S, L)            int32 absolute position per token
    returns:      (S, L, KV, G, hd)

    The gather is segment-bounded like the CUDA kernel: pages past a
    segment's last attendable page (``max(positions) // bs``) are clamped
    to that page instead of reading the table's padding entries.  Those
    pages are fully masked either way.
    """
    s, _, kv, g, hd = q.shape
    if q.numel() == 0:     # absent prefill part (decode-only iteration)
        return q
    bs = k_pool.shape[1]
    nb = block_tables.shape[1]
    s_max = nb * bs
    pos = positions.long()
    bounds = pos.max(dim=1).values // bs                             # (S,)
    page_idx = torch.minimum(torch.arange(nb, device=q.device)[None, :],
                             bounds[:, None])
    bt = torch.gather(block_tables.long(), 1, page_idx)
    k = k_pool[bt].reshape(s, s_max, kv, hd)
    v = v_pool[bt].reshape(s, s_max, kv, hd)
    scores = torch.einsum("slkgd,stkd->skglt", q, k).float() / (hd ** 0.5)
    keep = (pos[:, None, None, :, None]
            >= torch.arange(s_max, device=q.device)[None, None, None, None, :])
    scores = torch.where(keep, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("skglt,stkd->slkgd", probs.to(v.dtype), v)
    return out.to(q.dtype)


def paged_attention_split_ref(q: torch.Tensor,
                              k_pool: torch.Tensor,
                              v_pool: torch.Tensor,
                              block_tables: torch.Tensor,
                              context_lens: torch.Tensor,
                              split_tokens: int) -> torch.Tensor:
    """The decode kernel's algorithm (flash-decoding): each sequence's
    context is cut into splits of ``split_tokens`` tokens covering the
    table's ``nb * bs``; each split yields a partial (m, l, acc) over its
    own tokens, an empty split (m = NEG_INF, l = 0, acc = 0) included, and
    the partials merge under their common maximum.  Scores and products
    run in fp32 on the inputs as given.  ``cl = 0`` gives zero rows, as
    the CUDA and Pallas kernels do.  Shapes as ``paged_attention_ref``."""
    b, kv, g, hd = q.shape
    bs = k_pool.shape[1]
    s_max = block_tables.shape[1] * bs
    n_split = max(1, -(-s_max // split_tokens))
    span = n_split * split_tokens
    bt = block_tables.long()
    k = k_pool[bt].reshape(b, s_max, kv, hd).float()
    v = v_pool[bt].reshape(b, s_max, kv, hd).float()
    pad = (0, 0, 0, 0, 0, span - s_max)
    k = torch.nn.functional.pad(k, pad).reshape(b, n_split, split_tokens, kv, hd)
    v = torch.nn.functional.pad(v, pad).reshape(b, n_split, split_tokens, kv, hd)
    valid = (torch.arange(span, device=q.device)[None, :]
             < context_lens.long().clamp(0, s_max)[:, None])
    valid = valid.reshape(b, 1, 1, n_split, split_tokens)
    scores = torch.einsum("bkgd,bntkd->bkgnt", q.float(), k) / (hd ** 0.5)
    scores = torch.where(valid, scores, NEG_INF)
    m = scores.amax(dim=-1)                                  # (B,KV,G,n)
    p = torch.where(valid, torch.exp(scores - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    acc = torch.einsum("bkgnt,bntkd->bkgnd", p, v)
    w = torch.exp(m - m.amax(dim=-1, keepdim=True))
    out = ((acc * w[..., None]).sum(dim=-2)
           / (l * w).sum(dim=-1).clamp_min(1e-20)[..., None])
    return out.to(q.dtype)


def ragged_segment_attention_tiled_ref(q: torch.Tensor,
                                       k_pool: torch.Tensor,
                                       v_pool: torch.Tensor,
                                       block_tables: torch.Tensor,
                                       positions: torch.Tensor,
                                       key_tile: int) -> torch.Tensor:
    """The ragged kernel's algorithm: an fp32 online softmax over key
    tiles of ``key_tile`` tokens, scores in fp32 on the inputs as given,
    the probabilities rounded to v's dtype before each tile's PV product
    (accumulated in fp32), the row sums taken before that rounding.  Keys
    past a segment's largest position are masked, as the kernel never
    reads them.  Shapes and page bound as ``ragged_segment_attention_ref``."""
    s, lq, kv, g, hd = q.shape
    if q.numel() == 0:
        return q
    bs = k_pool.shape[1]
    nb = block_tables.shape[1]
    s_max = nb * bs
    pos = positions.long()
    bounds = pos.max(dim=1).values // bs
    page_idx = torch.minimum(torch.arange(nb, device=q.device)[None, :],
                             bounds[:, None])
    bt = torch.gather(block_tables.long(), 1, page_idx)
    k = k_pool[bt].reshape(s, s_max, kv, hd)
    v = v_pool[bt].reshape(s, s_max, kv, hd)
    n_tok = torch.clamp(pos.max(dim=1).values + 1, max=s_max)      # (S,)
    qf = q.float()
    m = torch.full((s, kv, g, lq), NEG_INF, device=q.device)
    l = torch.zeros((s, kv, g, lq), device=q.device)
    acc = torch.zeros((s, kv, g, lq, hd), device=q.device)
    for t0 in range(0, int(n_tok.max()), key_tile):
        kt = k[:, t0:t0 + key_tile].float()
        sc = torch.einsum("slkgd,stkd->skglt", qf, kt) / (hd ** 0.5)
        tok = torch.arange(t0, t0 + kt.shape[1], device=q.device)
        keep = ((tok[None, :] <= pos[:, :, None])
                & (tok[None, None, :] < n_tok[:, None, None]))      # (S,L,T)
        sc = torch.where(keep[:, None, None], sc, NEG_INF)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(sc - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "skglt,stkd->skgld", p.to(v.dtype).float(),
            v[:, t0:t0 + key_tile].float())
        m = m_new
    out = acc / l.clamp_min(1e-20)[..., None]
    return out.permute(0, 3, 1, 2, 4).to(q.dtype)


def chunked_prefill_attention_ref(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor,
                                  window: Optional[int] = None) -> torch.Tensor:
    """Causal (optionally sliding-window) attention oracle.

    q (B,S,KV,G,hd); k/v (B,S,KV,hd) -> (B,S,KV,G,hd)
    """
    s = q.shape[1]
    hd = q.shape[-1]
    scores = torch.einsum("bskgd,btkd->bkgst", q, k).float() / (hd ** 0.5)
    qi = torch.arange(s, device=q.device)[:, None]
    kj = torch.arange(s, device=q.device)[None, :]
    mask = qi >= kj
    if window is not None:
        mask &= (qi - kj) < window
    scores = torch.where(mask[None, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bkgst,btkd->bskgd", probs.to(v.dtype), v).to(q.dtype)
