"""GQA attention: the QKV projection (with qk-norm) used by the serving
steps; full-sequence causal attention (query-chunked for long S, with
sliding-window masks and gemma3's local/global RoPE tables) for the
model-level prefill; one-token decode over a dense cache; and the
encoder-decoder's cross attention over precomputed memory K/V.

Conventions: activations (..., S, d); q/k/v (..., S, H, hd); caches
(2, B, Smax, n_kv, hd) per layer.  All softmax math in fp32.

On DTensors (the dry-run) the functions follow DTensor's propagation;
where a head split is uneven over the model axis, the resharding GSPMD
would insert is explicit (``_heads``, ``_gqa_scores``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import spmd
from repro_torch.models.layers import apply_rope, dense_init, rms_norm, rope_at

NEG_INF = -1e30
LOCAL_ROPE_THETA = 10_000.0  # gemma3: local layers use 10k, global layers cfg.rope_theta


def _dual_rope(positions: torch.Tensor, hd: int, cfg: ModelConfig,
               is_global: Optional[bool]):
    """sin/cos; when ``is_global`` is given and the arch mixes local and
    global layers, the global layers take the config's ``rope_theta`` and
    the local ones LOCAL_ROPE_THETA."""
    if is_global is None or cfg.global_attn_every == 0 or is_global:
        return rope_at(positions, hd, cfg.rope_theta)
    return rope_at(positions, hd, LOCAL_ROPE_THETA)


def init_attention(generator: torch.Generator, cfg: ModelConfig, dtype,
                   device, lead: Tuple[int, ...] = (),
                   cross: bool = False) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv = cfg.num_heads, cfg.num_kv_heads
    p = {
        "wq": dense_init(generator, d, h * hd, dtype, device, lead),
        "wk": dense_init(generator, d, kv * hd, dtype, device, lead),
        "wv": dense_init(generator, d, kv * hd, dtype, device, lead),
        "wo": dense_init(generator, h * hd, d, dtype, device, lead),
    }
    if cfg.qk_norm and not cross:
        p["q_norm"] = torch.zeros(*lead, hd, dtype=torch.float32,
                                  device=device)
        p["k_norm"] = torch.zeros(*lead, hd, dtype=torch.float32,
                                  device=device)
    return p


def _heads(t: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    """(..., n * hd) -> (..., n, hd).  On a DTensor whose flat dim the
    model axis splits into shards that cut heads (eight KV heads over 16
    ranks), the flat dim is gathered first: the resharding GSPMD inserts,
    which DTensor's view propagation refuses to."""
    t = spmd.gather(t, -1, unless_divides=n)
    return t.reshape(*t.shape[:-1], n, hd)


def _project_qkv(p: dict, xq: torch.Tensor, xkv: torch.Tensor,
                 cfg: ModelConfig):
    """(..., S, d) -> q (..., S, H, hd), k/v (..., S, KV, hd); qk-norm
    applied per head when the config has it."""
    hd = cfg.resolved_head_dim
    q = _heads(xq @ p["wq"], cfg.num_heads, hd)
    k = _heads(xkv @ p["wk"], cfg.num_kv_heads, hd)
    v = _heads(xkv @ p["wv"], cfg.num_kv_heads, hd)
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q (B,Sq,H,hd), k (B,Sk,KV,hd) -> scores (B, KV, G, Sq, Sk) fp32.

    On a DTensor q whose heads the model axis splits in shards the
    (KV, G) grouping cannot follow, the resharding is explicit: the model
    axis moves from the heads to the queries (an all-to-all; the
    sequence-parallel layout), or, with too few queries to split (one
    decode token), q's heads are gathered.  Queries that every rank of a
    mesh dim would score alike (heads gathered, K replicated there) are
    split over it."""
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    ways = spmd.shard_ways(q, 2)
    if kvh % ways:
        q = (spmd.move_shard(q, 2, 1) if sq % ways == 0
             else spmd.gather(q, 2))
    q = spmd.spread(q, 1, k)
    qg = q.reshape(b, sq, kvh, h // kvh, hd)
    s = spmd.einsum("bskgd,btkd->bkgst", qg, k).float()
    return s / (hd ** 0.5)


def _gqa_out(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """probs (B,KV,G,Sq,Sk), v (B,Sk,KV,hd) -> (B,Sq,H,hd).  Over a
    sequence-sharded V (split-KV, context parallel) each rank's product
    is a partial sum of the output, reduced here, before the output
    projection: (B, Sq, H, hd) values."""
    b, kvh, g, sq, _ = probs.shape
    out = spmd.einsum("bkgst,btkd->bskgd", probs.to(v.dtype), v)
    return spmd.reduce_partial(out).reshape(b, sq, kvh * g, v.shape[-1])


def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor,
               window: Optional[int] = None) -> torch.Tensor:
    """Additive bias (Sq, Sk): 0 where visible, NEG_INF elsewhere; causal,
    plus the sliding window when given."""
    visible = q_pos[:, None] >= k_pos[None, :]
    if window is not None:
        visible &= (q_pos[:, None] - k_pos[None, :]) < window
    return torch.where(visible, 0.0, NEG_INF)


def causal_attention(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                     is_global: Optional[bool] = None,
                     positions: Optional[torch.Tensor] = None,
                     q_chunk: int = 1024,
                     causal: bool = True,
                     return_kv: bool = False):
    """Full-sequence attention (prefill; ``causal=False`` for the
    encoder).  x (B, S, d) -> (B, S, d), plus the roped (k, v) when
    ``return_kv``.  The config's sliding window applies unless
    ``is_global`` is True.  Queries go in ``q_chunk`` blocks when S
    is a multiple of it, bounding the scores at (B, H, q_chunk, S)."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)
    sin, cos = (spmd.lift(t, x) for t in
                _dual_rope(positions, cfg.resolved_head_dim, cfg, is_global))
    q, k, v = _project_qkv(p, x, x, cfg)
    q = apply_rope(q, sin, cos)
    k = apply_rope(k, sin, cos)
    win = None if is_global else cfg.sliding_window

    def attend(q_blk, qpos_blk):
        scores = _gqa_scores(q_blk, k)                 # (B, KV, G, sq, S)
        if causal:
            scores = scores + spmd.lift(
                _mask_bias(qpos_blk, positions, win), scores)
        # on DTensors, back to q's layout (heads) before the blocks meet
        return spmd.match(_gqa_out(torch.softmax(scores, dim=-1), v), q_blk)

    if s > q_chunk and s % q_chunk == 0:
        out = torch.cat([attend(q[:, i:i + q_chunk], positions[i:i + q_chunk])
                         for i in range(0, s, q_chunk)], dim=1)
    else:
        out = attend(q, positions)
    # pinned: its gradient comes back whole, to be split into heads
    o = spmd.pin(out.reshape(b, s, -1)) @ p["wo"]
    if return_kv:
        return o, (k, v)
    return o


def decode_attention(p: dict, x: torch.Tensor, cache_kv: torch.Tensor,
                     pos: int, cfg: ModelConfig, *,
                     is_global: Optional[bool] = None):
    """One-token decode.  x (B, 1, d); cache_kv (2, B, Smax, KV, hd); pos =
    the slot the new token's K/V is written to (the number of tokens
    already in the cache).  Returns (out (B, 1, d), updated cache_kv); the
    cache passed in is not modified.  The window applies as in
    :func:`causal_attention`."""
    b, smax = x.shape[0], cache_kv.shape[2]
    positions = torch.tensor([pos], device=x.device)
    sin, cos = (spmd.lift(t, x) for t in
                _dual_rope(positions, cfg.resolved_head_dim, cfg, is_global))
    q, k, v = _project_qkv(p, x, x, cfg)
    q = apply_rope(q, sin, cos)
    k = apply_rope(k, sin, cos)
    k_pos = torch.arange(smax, device=x.device)
    # the slot is written by a select, not an indexed store: on DTensors
    # an index into a sequence-sharded cache would gather it whole
    slot = spmd.lift((k_pos == pos)[:, None, None], cache_kv)
    new = torch.stack([k, v]).to(cache_kv.dtype)         # (2, B, 1, KV, hd)
    cache_kv = torch.where(slot, new, cache_kv)
    keep = k_pos <= pos
    if cfg.sliding_window is not None and not is_global:
        keep &= (pos - k_pos) < cfg.sliding_window
    bias = spmd.lift(torch.where(keep, 0.0, NEG_INF), x)
    probs = torch.softmax(_gqa_scores(q, cache_kv[0]) + bias, dim=-1)
    out = _gqa_out(probs, cache_kv[1]).reshape(b, 1, -1)
    return out @ p["wo"], cache_kv


def cross_attention(p: dict, x: torch.Tensor,
                    memory_kv: Tuple[torch.Tensor, torch.Tensor],
                    cfg: ModelConfig):
    """Decoder -> encoder attention over precomputed memory (K, V), each
    (B, T, KV, hd).  x (B, S, d) -> (B, S, d)."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = _heads(x @ p["wq"], cfg.num_heads, hd)
    k, v = memory_kv
    out = _gqa_out(torch.softmax(_gqa_scores(q, k), dim=-1), v)
    return spmd.pin(out.reshape(b, s, -1)) @ p["wo"]


def project_memory_kv(p: dict, memory: torch.Tensor, cfg: ModelConfig):
    """Encoder output (B, T, d) -> the cross attention's (K, V), each
    (B, T, KV, hd); no RoPE, no norm."""
    hd = cfg.resolved_head_dim
    b, t, _ = memory.shape
    k = _heads(memory @ p["wk"], cfg.num_kv_heads, hd)
    v = _heads(memory @ p["wv"], cfg.num_kv_heads, hd)
    return k, v
