"""The served language model: the uniform-attention dense decoder.

A :class:`LanguageModel` is a stateless object built from a
:class:`ModelConfig`; parameters are an explicit nested dict of tensors
laid out as the JAX package's pytree (layer-stacked leading dim,
``(d_in, d_out)`` weights), so the two compute the same function on the
same weights (``models/convert.py`` carries them across).

Public entry points:
  init_params(generator, device)   -> params (seeded torch initialiser)
  prefill(params, tokens)          -> (logits, cache)   dense causal forward
  decode_step(params, cache, tok)  -> (logits, cache)   one token, dense cache

MoE, SSM, hybrid and encoder-decoder families raise
``NotImplementedError``: they are ported after the serving path.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device, torch_dtype
from repro_torch.models import attention as attn
from repro_torch.models.layers import (
    embed_tokens,
    init_embedding,
    init_ffn,
    layer_slice,
    lm_logits,
    rms_norm,
    swiglu,
)

_LATER = ("is not ported yet: the port serves uniform-attention dense "
          "decoders so far (see ROADMAP.md, model families)")


class LanguageModel:
    """Decoder-only LM with uniform attention layers and dense FFNs."""

    def __init__(self, cfg: ModelConfig):
        kinds = set(cfg.layer_kinds)
        if kinds != {"attn"}:
            raise NotImplementedError(f"layer kinds {sorted(kinds)} {_LATER}")
        if cfg.moe is not None or cfg.is_encdec:
            raise NotImplementedError(f"{cfg.family} model {_LATER}")
        if cfg.sliding_window is not None or cfg.global_attn_every:
            raise NotImplementedError(f"windowed attention {_LATER}")
        self.cfg = cfg
        self.dtype = torch_dtype(cfg.dtype)
        self.uniform_kind = "attn"

    def init_params(self, generator: torch.Generator,
                    device: Optional[torch.device] = None) -> dict:
        """Random weights drawn from ``generator`` (which must live on
        ``device``), laid out as the JAX package's ``init_params``:
        normal(0, 1/d_in) matrices, 0.02-scaled embedding, zero fp32
        norm scales."""
        cfg, dtype = self.cfg, self.dtype
        device = resolve_device(device)
        n, d = cfg.num_layers, cfg.d_model
        params = init_embedding(generator, cfg, dtype, device)
        params["final_norm"] = torch.zeros(d, dtype=torch.float32,
                                           device=device)
        params["layers"] = {
            "ln1": torch.zeros(n, d, dtype=torch.float32, device=device),
            "ln2": torch.zeros(n, d, dtype=torch.float32, device=device),
            "attn": attn.init_attention(generator, cfg, dtype, device, (n,)),
            "ffn": init_ffn(generator, d, cfg.d_ff, dtype, device, (n,)),
        }
        return params

    @torch.no_grad()
    def _forward_seq(self, params: dict, tokens: torch.Tensor):
        """tokens (B, S) -> final-normed hidden (B, S, d) and the roped
        KV of every layer (L, 2, B, S, KV, hd)."""
        cfg = self.cfg
        x = embed_tokens(params, tokens).to(self.dtype)
        kvs = []
        for i in range(cfg.num_layers):
            lp = layer_slice(params["layers"], i)
            h = rms_norm(x, lp["ln1"], cfg.norm_eps)
            o, (k, v) = attn.causal_attention(lp["attn"], h, cfg,
                                              return_kv=True)
            x = x + o
            h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
            x = x + swiglu(h2, **lp["ffn"])
            kvs.append(torch.stack([k, v]))
        return rms_norm(x, params["final_norm"], cfg.norm_eps), torch.stack(kvs)

    def prefill(self, params: dict, tokens: torch.Tensor):
        """tokens (B, S) -> (last-token logits (B, V), cache) with
        ``cache = {"kv": (L, 2, B, S, KV, hd), "pos": S}``."""
        x, kv = self._forward_seq(params, tokens)
        logits = lm_logits(params, x[:, -1], self.cfg)
        return logits, {"kv": kv, "pos": tokens.shape[1]}

    @torch.no_grad()
    def decode_step(self, params: dict, cache: dict, tokens: torch.Tensor):
        """tokens (B, 1) -> (logits (B, V), updated cache).  ``cache`` is
        what :meth:`prefill` returns, its ``kv`` padded along the sequence
        axis to hold the new token at slot ``cache["pos"]``."""
        cfg = self.cfg
        pos = int(cache["pos"])
        x = embed_tokens(params, tokens).to(self.dtype)
        new_kv = []
        for i in range(cfg.num_layers):
            lp = layer_slice(params["layers"], i)
            h = rms_norm(x, lp["ln1"], cfg.norm_eps)
            o, kv = attn.decode_attention(lp["attn"], h, cache["kv"][i], pos,
                                          cfg)
            x = x + o
            h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
            x = x + swiglu(h2, **lp["ffn"])
            new_kv.append(kv)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = lm_logits(params, x[:, 0], cfg)
        return logits, dict(cache, kv=torch.stack(new_kv), pos=pos + 1)


def build_model(cfg: ModelConfig) -> LanguageModel:
    return LanguageModel(cfg)
