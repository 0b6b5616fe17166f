"""Language models of every architecture family of the JAX package.

A :class:`LanguageModel` (decoder-only: dense, MoE, VLM, RWKV, the Jamba
hybrid) or :class:`EncDecModel` (seamless) is a stateless object built
from a :class:`ModelConfig`; parameters are an explicit nested dict of
tensors laid out as the JAX package's pytree (layer-stacked leading dim,
``(d_in, d_out)`` weights; Jamba stacks 8-layer super-blocks, each
holding its attention layer and its ``mamba_dense`` / ``mamba_moe``
groups), so the two compute the same function on the same weights
(``models/convert.py`` carries them across).

Public entry points:
  init_params(generator, device)          -> params (seeded initialiser)
  loss(params, batch)                     -> (scalar, metrics)  train
  prefill(params, tokens[, frames])       -> (logits, cache)
  decode_step(params, cache, tokens)      -> (logits, cache)  one token
  init_cache(batch, max_len[, enc_len])   -> zeroed cache dict

``loss`` builds the autograd graph, recomputing each layer (each Jamba
super-block) in the backward as the reference's ``jax.checkpoint`` does;
``prefill`` and ``decode_step`` run under ``torch.no_grad``.
"""
from __future__ import annotations

from typing import List, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device, torch_dtype
from repro_torch.models import attention as attn
from repro_torch.models import spmd, ssm
from repro_torch.models.layers import (
    embed_tokens,
    init_embedding,
    init_ffn,
    layer_list,
    layer_slice,
    lm_logits,
    rms_norm,
    softmax_cross_entropy,
    swiglu,
)
from repro_torch.models.moe import init_moe, moe_ffn


def _zeros(lead, d, device) -> torch.Tensor:
    return torch.zeros(*lead, d, dtype=torch.float32, device=device)


def _ffn_or_moe(p: dict, generator, cfg, dtype, device, lead, ffn_kind):
    if ffn_kind == "moe":
        p["moe"] = init_moe(generator, cfg, dtype, device, lead)
    else:
        p["ffn"] = init_ffn(generator, cfg.d_model, cfg.d_ff, dtype, device,
                            lead)
    return p


def _init_attn_layer(generator, cfg, dtype, device, lead, ffn_kind) -> dict:
    p = {"ln1": _zeros(lead, cfg.d_model, device),
         "ln2": _zeros(lead, cfg.d_model, device),
         "attn": attn.init_attention(generator, cfg, dtype, device, lead)}
    return _ffn_or_moe(p, generator, cfg, dtype, device, lead, ffn_kind)


def _init_mamba_layer(generator, cfg, dtype, device, lead, ffn_kind) -> dict:
    p = {"ln1": _zeros(lead, cfg.d_model, device),
         "ln2": _zeros(lead, cfg.d_model, device),
         "mamba": ssm.init_mamba(generator, cfg, dtype, device, lead)}
    return _ffn_or_moe(p, generator, cfg, dtype, device, lead, ffn_kind)


def ffn_with_aux(lp: dict, h2: torch.Tensor, cfg: ModelConfig):
    """The layer's FFN: routed experts where it has them, else SwiGLU.
    Returns (out, the MoE load-balance loss, or None for a dense FFN).
    The MoE FFN sees every row of ``h2``, padding included: its capacity,
    and so which assignments drop, depends on them, as in the reference."""
    if "moe" in lp:
        return moe_ffn(lp["moe"], h2, cfg)
    return swiglu(h2, **lp["ffn"]), None


def ffn_block(lp: dict, h2: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """:func:`ffn_with_aux` without the aux loss (the serving steps)."""
    return ffn_with_aux(lp, h2, cfg)[0]


def _add_aux(total, aux):
    """The running sum of MoE aux losses; None while there is none (so a
    dense model's serving path adds no op)."""
    if aux is None:
        return total
    return aux if total is None else total + aux


def _run_layer(train: bool, fn, lp: dict, *args):
    """``fn(lp, *args)`` for one layer's params ``lp``; when ``train`` its
    activations are recomputed in the backward instead of kept (the
    reference's ``jax.checkpoint``).  On DTensors ``lp`` is unsharded over
    the data axes inside (FSDP), so the recompute gathers it again."""
    def body(lp, *args):
        return fn(spmd.unshard(lp), *args)

    if train:
        return checkpoint(body, lp, *args, use_reentrant=False)
    return body(lp, *args)


# =============================================================================
# LanguageModel
# =============================================================================


class LanguageModel:
    """Decoder-only LM (dense / MoE / VLM / RWKV / Jamba-hybrid)."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.dtype = torch_dtype(cfg.dtype)
        # Optional NamedSharding (models/sharding.py) of the (B, S, d)
        # activations on DTensor runs: pinned at every layer boundary, as
        # the reference constrains its scan carry, so the batch stays
        # sharded over the data axes
        self.act_sharding = None
        kinds = cfg.layer_kinds
        self.uniform_kind = kinds[0] if len(set(kinds)) == 1 else None
        if self.uniform_kind is None:
            # Jamba-style periodic pattern; the smallest repeating unit
            self.block_period = next(
                p for p in range(1, cfg.num_layers + 1)
                if cfg.num_layers % p == 0
                and kinds == kinds[:p] * (cfg.num_layers // p))
            self.n_blocks = cfg.num_layers // self.block_period
            self.block_kinds = kinds[:self.block_period]
        moe_layers = set(cfg.moe_layer_indices())
        self.ffn_kinds = tuple("moe" if i in moe_layers else "dense"
                               for i in range(cfg.num_layers))
        if self.uniform_kind is None:
            # the ffn pattern repeats with the block (jamba: moe period 2 | 8)
            assert self.ffn_kinds == (self.ffn_kinds[:self.block_period]
                                      * self.n_blocks)

    def _constrain(self, x: torch.Tensor) -> torch.Tensor:
        return spmd.constrain(x, self.act_sharding)

    # -- flags ---------------------------------------------------------------
    def _is_global_flags(self) -> Optional[List[bool]]:
        """Per layer: True for a global layer, False for a windowed one;
        None when the arch has no window."""
        cfg = self.cfg
        if cfg.global_attn_every:
            return [(i % cfg.global_attn_every) == (cfg.global_attn_every - 1)
                    for i in range(cfg.num_layers)]
        if cfg.sliding_window is not None:
            return [False] * cfg.num_layers
        return None

    def _layer_flags(self) -> list:
        return self._is_global_flags() or [None] * self.cfg.num_layers

    def _block_layers(self, blk: dict):
        """(kind, ffn kind, layer params) of each layer of one Jamba block,
        in block order."""
        i_md = i_mm = 0
        for i, kind in enumerate(self.block_kinds):
            fk = self.ffn_kinds[i]
            if kind == "attn":
                yield kind, fk, blk["attn"]
            elif fk == "moe":
                yield kind, fk, layer_slice(blk["mamba_moe"], i_mm)
                i_mm += 1
            else:
                yield kind, fk, layer_slice(blk["mamba_dense"], i_md)
                i_md += 1

    # =========================================================================
    # init
    # =========================================================================
    def init_params(self, generator: torch.Generator,
                    device: Optional[torch.device] = None) -> dict:
        """Random weights drawn from ``generator`` (which must live on
        ``device``), laid out as the JAX package's ``init_params``:
        normal(0, 1/d_in) matrices, 0.02-scaled embedding, zero fp32 norm
        scales, fp32 routers and SSM decay leaves."""
        cfg, dtype = self.cfg, self.dtype
        device = resolve_device(device)
        n = cfg.num_layers
        params = init_embedding(generator, cfg, dtype, device)
        params["final_norm"] = _zeros((), cfg.d_model, device)
        if self.uniform_kind == "attn":
            params["layers"] = _init_attn_layer(generator, cfg, dtype, device,
                                                (n,), self.ffn_kinds[0])
        elif self.uniform_kind == "rwkv":
            params["layers"] = {
                "ln1": _zeros((n,), cfg.d_model, device),
                "ln2": _zeros((n,), cfg.d_model, device),
                "tmix": ssm.init_rwkv_time_mix(generator, cfg, dtype, device,
                                               (n,)),
                "cmix": ssm.init_rwkv_channel_mix(generator, cfg, dtype,
                                                  device, (n,)),
            }
        else:  # jamba blocks: one attention layer and two mamba groups
            nb = self.n_blocks
            blk = {}
            groups = {"mamba_dense": 0, "mamba_moe": 0}
            for i, kind in enumerate(self.block_kinds):
                fk = self.ffn_kinds[i]
                if kind == "attn":
                    blk["attn"] = _init_attn_layer(generator, cfg, dtype,
                                                   device, (nb,), fk)
                else:
                    groups["mamba_moe" if fk == "moe" else "mamba_dense"] += 1
            for name, count in groups.items():
                if count:
                    blk[name] = _init_mamba_layer(
                        generator, cfg, dtype, device, (nb, count),
                        "moe" if name == "mamba_moe" else "dense")
            params["layers"] = blk
        return params

    # =========================================================================
    # caches
    # =========================================================================
    def init_cache(self, batch: int, max_len: int,
                   device: Optional[torch.device] = None) -> dict:
        cfg = self.cfg
        device = resolve_device(device)
        hd = cfg.resolved_head_dim
        cache: dict = {"pos": 0}
        n_attn = len(cfg.attn_layer_indices)
        if n_attn:
            cache["kv"] = torch.zeros(
                n_attn, 2, batch, max_len, cfg.num_kv_heads, hd,
                dtype=self.dtype, device=device)
        kinds = cfg.layer_kinds
        n_rwkv = sum(1 for k in kinds if k == "rwkv")
        if n_rwkv:
            h = cfg.d_model // cfg.rwkv_head_dim
            cache["rwkv_state"] = torch.zeros(
                n_rwkv, batch, h, cfg.rwkv_head_dim, cfg.rwkv_head_dim,
                dtype=torch.float32, device=device)
            cache["rwkv_shift1"] = torch.zeros(n_rwkv, batch, cfg.d_model,
                                               dtype=self.dtype, device=device)
            cache["rwkv_shift2"] = torch.zeros(n_rwkv, batch, cfg.d_model,
                                               dtype=self.dtype, device=device)
        n_mamba = sum(1 for k in kinds if k == "mamba")
        if n_mamba:
            di = cfg.ssm_expand * cfg.d_model
            cache["mamba_h"] = torch.zeros(n_mamba, batch, di,
                                           cfg.ssm_state_dim,
                                           dtype=torch.float32, device=device)
            cache["mamba_conv"] = torch.zeros(
                n_mamba, batch, cfg.ssm_conv_dim - 1, di, dtype=self.dtype,
                device=device)
        return cache

    # =========================================================================
    # layer bodies (shared by train / prefill / decode)
    # =========================================================================
    def _attn_layer_fwd(self, lp, x, is_global, train=False):
        """-> (x, MoE aux or None, the layer's stacked (K, V); None when
        ``train``)."""
        cfg = self.cfg
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        if train:
            o, kv = attn.causal_attention(lp["attn"], h, cfg,
                                          is_global=is_global), None
        else:
            o, kv = attn.causal_attention(lp["attn"], h, cfg,
                                          is_global=is_global, return_kv=True)
            kv = torch.stack(kv)
        x = x + self._constrain(o)
        f, aux = ffn_with_aux(lp, rms_norm(x, lp["ln2"], cfg.norm_eps), cfg)
        return x + self._constrain(f), aux, kv

    def _attn_layer_decode(self, lp, x, cache_kv, pos, is_global):
        cfg = self.cfg
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        o, new_kv = attn.decode_attention(lp["attn"], h, cache_kv, pos, cfg,
                                          is_global=is_global)
        x = x + self._constrain(o)
        return x + self._constrain(ffn_block(
            lp, rms_norm(x, lp["ln2"], cfg.norm_eps), cfg)), new_kv

    def _rwkv_layer_fwd(self, lp, x, state, s1, s2, decode: bool):
        cfg = self.cfg
        fn = ssm.rwkv_time_mix_step if decode else ssm.rwkv_time_mix
        o, new_state, new_s1 = fn(lp["tmix"],
                                  rms_norm(x, lp["ln1"], cfg.norm_eps),
                                  state, s1, cfg)
        x = x + self._constrain(o)
        o2, new_s2 = ssm.rwkv_channel_mix(
            lp["cmix"], rms_norm(x, lp["ln2"], cfg.norm_eps), s2)
        return x + self._constrain(o2), new_state, new_s1, new_s2

    def _mamba_layer_fwd(self, lp, x, h_state, conv_state, decode: bool):
        cfg = self.cfg
        fn = ssm.mamba_step if decode else ssm.mamba_forward
        o, new_h, new_conv = fn(lp["mamba"],
                                rms_norm(x, lp["ln1"], cfg.norm_eps),
                                h_state, conv_state, cfg)
        x = x + self._constrain(o)
        f, aux = ffn_with_aux(lp, rms_norm(x, lp["ln2"], cfg.norm_eps), cfg)
        return x + self._constrain(f), aux, new_h, new_conv

    def _jamba_block_fwd(self, blk, x, h0, c0, train=False):
        """One super-block: -> (x, summed MoE aux or None, its attention
        layers' K/V, its Mamba states, its conv windows)."""
        aux = None
        kvs, hs, convs = [], [], []
        for kind, _, lp in self._block_layers(blk):
            if kind == "attn":
                x, a, kv = self._attn_layer_fwd(lp, x, None, train)
                kvs.append(kv)
            else:
                x, a, nh, nc = self._mamba_layer_fwd(lp, x, h0, c0, False)
                hs.append(nh)
                convs.append(nc)
            aux = _add_aux(aux, a)
        return x, aux, kvs, hs, convs

    # =========================================================================
    # full-sequence forward (train / prefill)
    # =========================================================================
    def _forward_seq(self, params: dict, tokens: torch.Tensor,
                     train: bool = False):
        """tokens (B, S) -> (final-normed hidden (B, S, d), the MoE aux
        loss summed over the layers (fp32 scalar; None without MoE), the
        cache of the whole sequence).  With ``train`` no cache is built
        (None), and each layer, each Jamba super-block, is checkpointed."""
        cfg = self.cfg
        x = self._constrain(embed_tokens(params, tokens).to(self.dtype))
        b, s = tokens.shape
        dev = x.device
        aux = None
        cache = None if train else {"pos": s}
        n = self.n_blocks if self.uniform_kind is None else cfg.num_layers
        lps = layer_list(params["layers"], n)
        if self.uniform_kind == "attn":
            kvs = []
            for lp, flag in zip(lps, self._layer_flags()):
                x, a, kv = _run_layer(train, self._attn_layer_fwd, lp,
                                      self._constrain(x), flag, train)
                aux = _add_aux(aux, a)
                kvs.append(kv)
            if not train:
                cache["kv"] = torch.stack(kvs)
        elif self.uniform_kind == "rwkv":
            h = cfg.d_model // cfg.rwkv_head_dim
            st0 = spmd.lift(torch.zeros(b, h, cfg.rwkv_head_dim,
                                        cfg.rwkv_head_dim,
                                        dtype=torch.float32, device=dev),
                            x, dims=(0,))
            sh0 = spmd.lift(torch.zeros(b, cfg.d_model, dtype=self.dtype,
                                        device=dev), x, dims=(0,))
            sts, sh1s, sh2s = [], [], []
            for lp in lps:
                x, st, sh1, sh2 = _run_layer(
                    train, self._rwkv_layer_fwd, lp, self._constrain(x), st0,
                    sh0, sh0, False)
                sts.append(st)
                sh1s.append(sh1.to(self.dtype))
                sh2s.append(sh2.to(self.dtype))
            if not train:
                cache.update(rwkv_state=torch.stack(sts),
                             rwkv_shift1=torch.stack(sh1s),
                             rwkv_shift2=torch.stack(sh2s))
        else:  # jamba blocks
            di = cfg.ssm_expand * cfg.d_model
            h0 = spmd.lift(torch.zeros(b, di, cfg.ssm_state_dim,
                                       dtype=torch.float32, device=dev),
                           x, dims=(0,))
            c0 = spmd.lift(torch.zeros(b, cfg.ssm_conv_dim - 1, di,
                                       dtype=self.dtype, device=dev),
                           x, dims=(0,))
            kvs, hs, convs = [], [], []
            for blk in lps:
                x, a, bkv, bh, bc = _run_layer(
                    train, self._jamba_block_fwd, blk, self._constrain(x), h0,
                    c0, train)
                aux = _add_aux(aux, a)
                kvs += bkv
                hs += bh
                convs += bc
            if not train:
                cache.update(kv=torch.stack(kvs), mamba_h=torch.stack(hs),
                             mamba_conv=torch.stack(convs))
        return rms_norm(x, params["final_norm"], cfg.norm_eps), aux, cache

    # =========================================================================
    # public API
    # =========================================================================
    def loss(self, params: dict, batch: dict):
        """batch {"tokens" (B, S), "labels" (B, S)[, "mask" (B, S)]} ->
        (next-token cross entropy + the MoE aux loss, {"ce", "aux"}), with
        the autograd graph to ``params``' leaves that require grad."""
        x, aux, _ = self._forward_seq(params, batch["tokens"], train=True)
        if aux is None:
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
        logits = lm_logits(params, x, self.cfg)
        ce = softmax_cross_entropy(logits, batch["labels"], batch.get("mask"))
        return ce + aux, {"ce": ce, "aux": aux}

    @torch.no_grad()
    def prefill(self, params: dict, tokens: torch.Tensor):
        """tokens (B, S) -> (last-token logits (B, V), cache); the cache
        holds ``pos = S`` and, by family, ``kv`` (L_attn, 2, B, S, KV,
        hd), the RWKV states and shifts, the Mamba states and conv
        windows."""
        x, _, cache = self._forward_seq(params, tokens)
        return lm_logits(params, x[:, -1], self.cfg), cache

    @torch.no_grad()
    def decode_step(self, params: dict, cache: dict, tokens: torch.Tensor):
        """tokens (B, 1) -> (logits (B, V), updated cache).  ``cache`` is
        what :meth:`prefill` returns, its ``kv`` padded along the sequence
        axis to hold the new token at slot ``cache["pos"]``; it is not
        modified."""
        cfg = self.cfg
        pos = int(cache["pos"])
        x = embed_tokens(params, tokens).to(self.dtype)
        new = dict(cache, pos=pos + 1)
        if self.uniform_kind == "attn":
            kvs = []
            for i, flag in enumerate(self._layer_flags()):
                x, kv = self._attn_layer_decode(
                    spmd.unshard(layer_slice(params["layers"], i)),
                    self._constrain(x), cache["kv"][i], pos, flag)
                kvs.append(kv)
            new["kv"] = torch.stack(kvs)
        elif self.uniform_kind == "rwkv":
            sts, s1s, s2s = [], [], []
            for i in range(cfg.num_layers):
                x, st, s1, s2 = self._rwkv_layer_fwd(
                    spmd.unshard(layer_slice(params["layers"], i)),
                    self._constrain(x),
                    cache["rwkv_state"][i], cache["rwkv_shift1"][i],
                    cache["rwkv_shift2"][i], True)
                sts.append(st)
                s1s.append(s1.to(self.dtype))
                s2s.append(s2.to(self.dtype))
            new.update(rwkv_state=torch.stack(sts),
                       rwkv_shift1=torch.stack(s1s),
                       rwkv_shift2=torch.stack(s2s))
        else:  # jamba
            kvs, hs, convs = [], [], []
            i_a = i_m = 0
            for j in range(self.n_blocks):
                blk = spmd.unshard(layer_slice(params["layers"], j))
                x = self._constrain(x)
                for kind, _, lp in self._block_layers(blk):
                    if kind == "attn":
                        x, kv = self._attn_layer_decode(
                            lp, x, cache["kv"][i_a], pos, None)
                        kvs.append(kv)
                        i_a += 1
                    else:
                        x, _, nh, nc = self._mamba_layer_fwd(
                            lp, x, cache["mamba_h"][i_m],
                            cache["mamba_conv"][i_m], True)
                        hs.append(nh)
                        convs.append(nc)
                        i_m += 1
            new.update(kv=torch.stack(kvs), mamba_h=torch.stack(hs),
                       mamba_conv=torch.stack(convs))
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return lm_logits(params, x[:, 0], cfg), new


# =============================================================================
# Encoder-decoder (seamless-m4t): the encoder consumes frame embeddings
# =============================================================================


class EncDecModel:
    """Enc-dec transformer; the encoder consumes precomputed frame
    embeddings (B, S_enc, d) in place of the speech frontend."""

    def __init__(self, cfg: ModelConfig):
        assert cfg.is_encdec
        self.cfg = cfg
        self.dtype = torch_dtype(cfg.dtype)
        self.act_sharding = None   # as LanguageModel's

    def _constrain(self, x: torch.Tensor) -> torch.Tensor:
        return spmd.constrain(x, self.act_sharding)

    def init_params(self, generator: torch.Generator,
                    device: Optional[torch.device] = None) -> dict:
        cfg, dtype = self.cfg, self.dtype
        device = resolve_device(device)
        d, ne, nd = cfg.d_model, (cfg.num_encoder_layers,), (cfg.num_layers,)
        params = init_embedding(generator, cfg, dtype, device)
        params["final_norm"] = _zeros((), d, device)
        params["enc_final_norm"] = _zeros((), d, device)
        params["encoder"] = {
            "ln1": _zeros(ne, d, device), "ln2": _zeros(ne, d, device),
            "attn": attn.init_attention(generator, cfg, dtype, device, ne),
            "ffn": init_ffn(generator, d, cfg.d_ff, dtype, device, ne)}
        params["decoder"] = {
            "ln1": _zeros(nd, d, device), "ln_x": _zeros(nd, d, device),
            "ln2": _zeros(nd, d, device),
            "attn": attn.init_attention(generator, cfg, dtype, device, nd),
            "xattn": attn.init_attention(generator, cfg, dtype, device, nd,
                                         cross=True),
            "ffn": init_ffn(generator, d, cfg.d_ff, dtype, device, nd)}
        return params

    def encode(self, params: dict, frames: torch.Tensor) -> torch.Tensor:
        """frames (B, S_enc, d) -> the encoder's final-normed output."""
        cfg = self.cfg
        x = frames.to(self.dtype)
        for lp in layer_list(params["encoder"], cfg.num_encoder_layers):
            lp = spmd.unshard(lp)
            x = self._constrain(x)
            h = rms_norm(x, lp["ln1"], cfg.norm_eps)
            x = x + self._constrain(
                attn.causal_attention(lp["attn"], h, cfg, causal=False))
            h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
            x = x + self._constrain(swiglu(h2, **lp["ffn"]))
        return rms_norm(x, params["enc_final_norm"], cfg.norm_eps)

    def _memory_kv(self, params: dict, memory: torch.Tensor) -> torch.Tensor:
        """(L, 2, B, S_enc, KV, hd): every decoder layer's cross K/V."""
        return torch.stack([
            torch.stack(attn.project_memory_kv(spmd.unshard(lp["xattn"]),
                                               memory, self.cfg))
            for lp in layer_list(params["decoder"], self.cfg.num_layers)])

    def _decoder_layer(self, lp, x, mem_kv, cache_kv=None, pos=None,
                       train=False):
        """-> (x, the layer's new self-attention K/V; None when
        ``train``)."""
        cfg = self.cfg
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        if cache_kv is not None:
            o, new_kv = attn.decode_attention(lp["attn"], h, cache_kv, pos,
                                              cfg)
        elif train:
            o, new_kv = attn.causal_attention(lp["attn"], h, cfg), None
        else:
            o, kv = attn.causal_attention(lp["attn"], h, cfg, return_kv=True)
            new_kv = torch.stack(kv)
        x = x + self._constrain(o)
        hx = rms_norm(x, lp["ln_x"], cfg.norm_eps)
        x = x + self._constrain(attn.cross_attention(
            lp["xattn"], hx, (mem_kv[0], mem_kv[1]), cfg))
        h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
        return x + self._constrain(swiglu(h2, **lp["ffn"])), new_kv

    def loss(self, params: dict, batch: dict):
        """batch {"frames" (B, S_enc, d), "tokens", "labels"[, "mask"]} ->
        (cross entropy, {"ce", "aux": 0}).  The encoder and the memory
        K/V run as they are; each decoder layer is checkpointed, as in the
        reference."""
        cfg = self.cfg
        mkvs = self._memory_kv(params, self.encode(params, batch["frames"]))
        x = embed_tokens(params, batch["tokens"]).to(self.dtype)
        for lp, mkv in zip(layer_list(params["decoder"], cfg.num_layers),
                           mkvs):
            x, _ = _run_layer(True, self._decoder_layer, lp,
                              self._constrain(x), mkv, None, None, True)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        ce = softmax_cross_entropy(lm_logits(params, x, cfg), batch["labels"],
                                   batch.get("mask"))
        return ce, {"ce": ce, "aux": torch.zeros((), dtype=torch.float32,
                                                 device=x.device)}

    def init_cache(self, batch: int, max_len: int, enc_len: int,
                   device: Optional[torch.device] = None) -> dict:
        cfg = self.cfg
        device = resolve_device(device)
        shape = (cfg.num_layers, 2, batch)
        tail = (cfg.num_kv_heads, cfg.resolved_head_dim)
        return {
            "pos": 0,
            "kv": torch.zeros(*shape, max_len, *tail, dtype=self.dtype,
                              device=device),
            "memory_kv": torch.zeros(*shape, enc_len, *tail,
                                     dtype=self.dtype, device=device),
        }

    @torch.no_grad()
    def prefill(self, params: dict, tokens: torch.Tensor,
                frames: torch.Tensor):
        """tokens (B, S), frames (B, S_enc, d) -> (last-token logits, cache
        {"pos", "kv", "memory_kv"})."""
        cfg = self.cfg
        mkvs = self._memory_kv(params, self.encode(params, frames))
        x = embed_tokens(params, tokens).to(self.dtype)
        kvs = []
        for lp, mkv in zip(layer_list(params["decoder"], cfg.num_layers),
                           mkvs):
            x, kv = self._decoder_layer(spmd.unshard(lp), self._constrain(x),
                                        mkv)
            kvs.append(kv)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        cache = {"pos": tokens.shape[1], "kv": torch.stack(kvs),
                 "memory_kv": mkvs}
        return lm_logits(params, x[:, -1], cfg), cache

    @torch.no_grad()
    def decode_step(self, params: dict, cache: dict, tokens: torch.Tensor):
        cfg = self.cfg
        pos = int(cache["pos"])
        x = embed_tokens(params, tokens).to(self.dtype)
        kvs = []
        for i in range(cfg.num_layers):
            x, kv = self._decoder_layer(
                spmd.unshard(layer_slice(params["decoder"], i)), x,
                                        cache["memory_kv"][i],
                                        cache["kv"][i], pos)
            kvs.append(kv)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return (lm_logits(params, x[:, 0], cfg),
                dict(cache, kv=torch.stack(kvs), pos=pos + 1))


def build_model(cfg: ModelConfig):
    return EncDecModel(cfg) if cfg.is_encdec else LanguageModel(cfg)
