"""GQA attention for the uniform-attention decoders: the QKV projection
(with qk-norm) used by the serving steps, dense causal attention for the
prefill oracle, and one-token decode over a dense cache.

Conventions: activations (..., S, d); q/k/v (..., S, H, hd).  All softmax
math in fp32.  Sliding-window and cross attention join with the model
families that need them.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import apply_rope, dense_init, rms_norm, rope_at

NEG_INF = -1e30


def init_attention(generator: torch.Generator, cfg: ModelConfig, dtype,
                   device, lead: Tuple[int, ...] = ()) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv = cfg.num_heads, cfg.num_kv_heads
    p = {
        "wq": dense_init(generator, d, h * hd, dtype, device, lead),
        "wk": dense_init(generator, d, kv * hd, dtype, device, lead),
        "wv": dense_init(generator, d, kv * hd, dtype, device, lead),
        "wo": dense_init(generator, h * hd, d, dtype, device, lead),
    }
    if cfg.qk_norm:
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


def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor) -> torch.Tensor:
    """Additive causal bias (Sq, Sk): 0 where visible, NEG_INF elsewhere."""
    causal = q_pos[:, None] >= k_pos[None, :]
    return torch.where(causal, 0.0, NEG_INF)


def causal_attention(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                     positions: Optional[torch.Tensor] = None,
                     return_kv: bool = False):
    """Full-sequence causal attention (prefill).  x (B, S, d) -> (B, S, d),
    plus the roped (k, v) when ``return_kv``."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)
    sin, cos = rope_at(positions, cfg.resolved_head_dim, cfg.rope_theta)
    q, k, v = _project_qkv(p, x, x, cfg)
    q = apply_rope(q, sin, cos)
    k = apply_rope(k, sin, cos)
    scores = _gqa_scores(q, k)
    probs = torch.softmax(scores + _mask_bias(positions, positions), dim=-1)
    o = _gqa_out(probs, v).reshape(b, s, -1) @ p["wo"]
    if return_kv:
        return o, (k, v)
    return o


def decode_attention(p: dict, x: torch.Tensor, cache_kv: torch.Tensor,
                     pos: int, cfg: ModelConfig):
    """One-token decode.  x (B, 1, d); cache_kv (2, B, Smax, KV, hd); pos =
    the slot the new token's K/V is written to (the number of tokens
    already in the cache).  Returns (out (B, 1, d), updated cache_kv); the
    cache passed in is not modified."""
    b, smax = x.shape[0], cache_kv.shape[2]
    positions = torch.tensor([pos], device=x.device)
    sin, cos = rope_at(positions, cfg.resolved_head_dim, cfg.rope_theta)
    q, k, v = _project_qkv(p, x, x, cfg)
    q = apply_rope(q, sin, cos)
    k = apply_rope(k, sin, cos)
    cache_kv = cache_kv.clone()
    cache_kv[0, :, pos] = k[:, 0].to(cache_kv.dtype)
    cache_kv[1, :, pos] = v[:, 0].to(cache_kv.dtype)
    k_pos = torch.arange(smax, device=x.device)
    bias = torch.where(k_pos <= pos, 0.0, NEG_INF)
    probs = torch.softmax(_gqa_scores(q, cache_kv[0]) + bias, dim=-1)
    out = _gqa_out(probs, cache_kv[1]).reshape(b, 1, -1)
    return out @ p["wo"], cache_kv
