"""GQA attention: the QKV projection (with qk-norm) used by the serving
steps; full-sequence causal attention (query-chunked for long S, with
sliding-window masks and gemma3's local/global RoPE tables) for the
model-level prefill; one-token decode over a dense cache; and the
encoder-decoder's cross attention over precomputed memory K/V.

Conventions: activations (..., S, d); q/k/v (..., S, H, hd); caches
(2, B, Smax, n_kv, hd) per layer.  All softmax math in fp32.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
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


def _project_qkv(p: dict, xq: torch.Tensor, xkv: torch.Tensor,
                 cfg: ModelConfig):
    """(..., S, d) -> q (..., S, H, hd), k/v (..., S, KV, hd); qk-norm
    applied per head when the config has it."""
    hd = cfg.resolved_head_dim
    q = (xq @ p["wq"]).reshape(*xq.shape[:-1], cfg.num_heads, hd)
    k = (xkv @ p["wk"]).reshape(*xkv.shape[:-1], cfg.num_kv_heads, hd)
    v = (xkv @ p["wv"]).reshape(*xkv.shape[:-1], cfg.num_kv_heads, hd)
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q (B,Sq,H,hd), k (B,Sk,KV,hd) -> scores (B, KV, G, Sq, Sk) fp32."""
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, sq, kvh, h // kvh, hd)
    s = torch.einsum("bskgd,btkd->bkgst", qg, k).float()
    return s / (hd ** 0.5)


def _gqa_out(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """probs (B,KV,G,Sq,Sk), v (B,Sk,KV,hd) -> (B,Sq,H,hd)."""
    b, kvh, g, sq, _ = probs.shape
    out = torch.einsum("bkgst,btkd->bskgd", probs.to(v.dtype), v)
    return out.reshape(b, sq, kvh * g, v.shape[-1])


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
    sin, cos = _dual_rope(positions, cfg.resolved_head_dim, cfg, is_global)
    q, k, v = _project_qkv(p, x, x, cfg)
    q = apply_rope(q, sin, cos)
    k = apply_rope(k, sin, cos)
    win = None if is_global else cfg.sliding_window

    def attend(q_blk, qpos_blk):
        scores = _gqa_scores(q_blk, k)                 # (B, KV, G, sq, S)
        if causal:
            scores = scores + _mask_bias(qpos_blk, positions, win)
        return _gqa_out(torch.softmax(scores, dim=-1), v)

    if s > q_chunk and s % q_chunk == 0:
        out = torch.cat([attend(q[:, i:i + q_chunk], positions[i:i + q_chunk])
                         for i in range(0, s, q_chunk)], dim=1)
    else:
        out = attend(q, positions)
    o = out.reshape(b, s, -1) @ p["wo"]
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
    sin, cos = _dual_rope(positions, cfg.resolved_head_dim, cfg, is_global)
    q, k, v = _project_qkv(p, x, x, cfg)
    q = apply_rope(q, sin, cos)
    k = apply_rope(k, sin, cos)
    cache_kv = cache_kv.clone()
    cache_kv[0, :, pos] = k[:, 0].to(cache_kv.dtype)
    cache_kv[1, :, pos] = v[:, 0].to(cache_kv.dtype)
    k_pos = torch.arange(smax, device=x.device)
    keep = k_pos <= pos
    if cfg.sliding_window is not None and not is_global:
        keep &= (pos - k_pos) < cfg.sliding_window
    bias = torch.where(keep, 0.0, NEG_INF)
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
    q = (x @ p["wq"]).reshape(b, s, cfg.num_heads, hd)
    k, v = memory_kv
    out = _gqa_out(torch.softmax(_gqa_scores(q, k), dim=-1), v)
    out = out.reshape(b, s, -1)
    return out @ p["wo"]


def project_memory_kv(p: dict, memory: torch.Tensor, cfg: ModelConfig):
    """Encoder output (B, T, d) -> the cross attention's (K, V), each
    (B, T, KV, hd); no RoPE, no norm."""
    hd = cfg.resolved_head_dim
    b, t, _ = memory.shape
    k = (memory @ p["wk"]).reshape(b, t, cfg.num_kv_heads, hd)
    v = (memory @ p["wv"]).reshape(b, t, cfg.num_kv_heads, hd)
    return k, v
