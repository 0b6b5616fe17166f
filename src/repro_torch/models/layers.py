"""Shared neural-net building blocks (plain functions on tensors; params
are nested dicts of tensors laid out as in the JAX package: weights
``(d_in, d_out)``, layer-stacked on a leading dim)."""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig


def dense_init(generator: torch.Generator, d_in: int, d_out: int, dtype,
               device, lead: Tuple[int, ...] = ()) -> torch.Tensor:
    """Normal(0, 1/d_in) weights of shape ``lead + (d_in, d_out)``, drawn
    in fp32 on ``device`` from ``generator`` and cast to ``dtype``."""
    w = torch.empty(*lead, d_in, d_out, dtype=torch.float32, device=device)
    w.normal_(generator=generator).mul_(1.0 / (d_in ** 0.5))
    return w.to(dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm in fp32, scaled by ``1 + scale`` (zero-initialised)."""
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(dt)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """SwiGLU FFN: silu taken in fp32 and cast back before ``* up``."""
    g = x @ w_gate
    u = x @ w_up
    h = F.silu(g.float()).to(x.dtype) * u
    return h @ w_down


def init_ffn(generator: torch.Generator, d_model: int, d_ff: int, dtype,
             device, lead: Tuple[int, ...] = ()) -> dict:
    return {
        "w_gate": dense_init(generator, d_model, d_ff, dtype, device, lead),
        "w_up": dense_init(generator, d_model, d_ff, dtype, device, lead),
        "w_down": dense_init(generator, d_ff, d_model, dtype, device, lead),
    }


# ---------------------------------------------------------------------------
# RoPE (half-split, not interleaved; angles in fp32)
# ---------------------------------------------------------------------------


def _inv_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, sin: torch.Tensor,
               cos: torch.Tensor) -> torch.Tensor:
    """x: (..., S, H, head_dim); sin/cos: (S, head_dim//2) or
    broadcastable."""
    half = x.shape[-1] // 2
    sin = sin[..., :, None, :]       # (S, 1, half): broadcast over heads
    cos = cos[..., :, None, :]
    x1f, x2f = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1f * cos - x2f * sin, x2f * cos + x1f * sin], dim=-1)
    return out.to(x.dtype)


def rope_at(positions: torch.Tensor, head_dim: int,
            theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """sin/cos at explicit integer positions (any shape (...,))."""
    angles = (positions.float()[..., None]
              * _inv_freqs(head_dim, theta, positions.device))
    return torch.sin(angles), torch.cos(angles)


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------


def init_embedding(generator: torch.Generator, cfg: ModelConfig, dtype,
                   device) -> dict:
    emb = torch.empty(cfg.vocab_size, cfg.d_model, dtype=torch.float32,
                      device=device)
    p = {"embed": emb.normal_(generator=generator).mul_(0.02).to(dtype)}
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(generator, cfg.d_model, cfg.vocab_size,
                                  dtype, device)
    return p


def embed_tokens(params: dict, ids: torch.Tensor) -> torch.Tensor:
    return params["embed"][ids.long()]


def lm_logits(params: dict, x: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return x @ params["embed"].T
    return x @ params["lm_head"]


def layer_slice(layers: dict, i: int) -> dict:
    """Layer ``i``'s params: views into the layer-stacked tree."""
    return {k: layer_slice(v, i) if isinstance(v, dict) else v[i]
            for k, v in layers.items()}

