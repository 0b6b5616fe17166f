"""Attention-free sequence mixers: RWKV6 (Finch) and the Mamba selective
SSM, as the JAX package's ``models/ssm.py`` computes them.

Both come in a chunked form for prefill (the sequence split into chunks
of RWKV_CHUNK / MAMBA_CHUNK tokens, the state carried across chunks) and
an O(1) single-step form for decode.  Inside an RWKV chunk the relative
log decays are sums of non-positive terms, so ``exp`` never overflows.
The reference's Mamba chunk is an associative scan; here the same
first-order recurrence runs as a loop over the chunk's positions, in
fp32.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import spmd
from repro_torch.models.layers import dense_init, rms_norm

# ---------------------------------------------------------------------------
# RWKV6 time mix (data-dependent per-channel decay, matrix-valued state)
# ---------------------------------------------------------------------------

RWKV_CHUNK = 32
_DECAY_LORA = 64


def _fp32(generator, shape, device, fill: str) -> torch.Tensor:
    t = torch.empty(*shape, dtype=torch.float32, device=device)
    if fill == "uniform":
        return t.uniform_(generator=generator)
    return t.normal_(generator=generator)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) with no linear cut-over."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def init_rwkv_time_mix(generator: torch.Generator, cfg: ModelConfig, dtype,
                       device, lead: Tuple[int, ...] = ()) -> dict:
    d = cfg.d_model
    hd = cfg.rwkv_head_dim
    h = d // hd
    w = lambda a, b: dense_init(generator, a, b, dtype, device, lead)
    return {
        "mu": _fp32(generator, (*lead, 5, d), device, "uniform"),  # r,k,v,g,w mixes
        "wr": w(d, d),
        "wk": w(d, d),
        "wv": w(d, d),
        "wg": w(d, d),
        "w_lora_a": w(d, _DECAY_LORA),
        "w_lora_b": w(_DECAY_LORA, d),
        "w_bias": torch.full((*lead, d), -1.0, dtype=torch.float32,
                             device=device),
        "u": _fp32(generator, (*lead, h, hd), device, "normal").mul_(0.1),
        "wo": w(d, d),
        "ln_x": torch.zeros(*lead, d, dtype=torch.float32, device=device),
    }


def _rwkv_mix(x: torch.Tensor, x_prev: torch.Tensor,
              mu: torch.Tensor) -> torch.Tensor:
    """Token shift interpolation: x + mu*(shift(x) - x)."""
    return x + (x_prev - x) * mu.to(x.dtype)


def _shifted(x: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """x (B, S, d) moved one token later, ``shift`` (B, d) in front."""
    return torch.cat([shift[:, None].to(x.dtype), x[:, :-1]], dim=1)


def _rwkv_projections(p: dict, x: torch.Tensor, shift: torch.Tensor,
                      cfg: ModelConfig):
    """x (B,S,d), shift (B,d) = last token of previous segment."""
    b, s, d = x.shape
    hd = cfg.rwkv_head_dim
    h = d // hd
    xs = _shifted(x, shift)
    mu = p["mu"]
    r = _rwkv_mix(x, xs, mu[0]) @ p["wr"]
    k = _rwkv_mix(x, xs, mu[1]) @ p["wk"]
    v = _rwkv_mix(x, xs, mu[2]) @ p["wv"]
    g = F.silu((_rwkv_mix(x, xs, mu[3]) @ p["wg"]).float())
    wx = _rwkv_mix(x, xs, mu[4])
    w_log = -_softplus(((wx @ p["w_lora_a"]) @ p["w_lora_b"]).float()
                       + p["w_bias"])                    # (B,S,d) <= 0
    shape = (b, s, h, hd)

    def heads(t):
        # on DTensors, gathered first where the model axis cuts heads
        return spmd.gather(t, -1, unless_divides=h).reshape(shape)

    return (heads(r).float(), heads(k).float(), heads(v).float(), g,
            heads(w_log), x[:, -1])


def _rwkv_chunk(r, k, v, w_log, u, state):
    """One chunk of the WKV recurrence.

    r,k,v,w_log: (B,C,H,hd) fp32; u (H,hd); state (B,H,hd,hd).
    o_t = r_t . S_{t-1} + (r_t . (u*k_t)) v_t ;  S_t = diag(w_t) S_{t-1} + k_t^T v_t
    """
    c = r.shape[1]
    a = torch.cumsum(w_log, dim=1)           # inclusive  (B,C,H,hd)
    b_ex = a - w_log                          # exclusive
    o_inter = torch.einsum("bchd,bhde->bche", r * torch.exp(b_ex), state)
    # intra-chunk strict-lower scores with per-dim relative decay
    dlog = b_ex[:, :, None] - a[:, None, :]   # (B,Ct,Cj,H,hd); <=0 for j<t
    ar = torch.arange(c, device=r.device)
    mask = spmd.lift((ar[:, None] > ar[None, :])[None, :, :, None, None],
                     dlog)
    dec = torch.where(mask, torch.exp(torch.clamp(dlog, max=0.0)), 0.0)
    scores = torch.einsum("bthd,bjhd,btjhd->bhtj", r, k, dec)
    o_intra = torch.einsum("bhtj,bjhe->bthe", scores, v)
    # bonus diagonal (current token, weight u)
    rb = torch.einsum("bthd,hd,bthd->bth", r, u, k)
    o = o_inter + o_intra + rb[..., None] * v
    # S_end = diag(exp(a_C)) S0 + sum_j (exp(a_C - a_j) * k_j)^T v_j
    a_last = a[:, -1]                         # (B,H,hd)
    k_dec = k * torch.exp(a_last[:, None] - a)
    new_state = (state * torch.exp(a_last)[..., None]
                 + torch.einsum("bjhd,bjhe->bhde", k_dec, v))
    return o, new_state


def rwkv_time_mix(p: dict, x: torch.Tensor, state: torch.Tensor,
                  shift: torch.Tensor, cfg: ModelConfig,
                  chunk: int = RWKV_CHUNK):
    """Full-sequence (prefill). Returns (out (B,S,d), state, shift)."""
    b, s, d = x.shape
    hd = cfg.rwkv_head_dim
    h = d // hd
    r, k, v, g, w_log, new_shift = _rwkv_projections(p, x, shift, cfg)
    pad = (-s) % chunk
    if pad:     # decay 1, k = 0: padding is a no-op on the state
        r, k, v, w_log = (F.pad(t, (0, 0, 0, 0, 0, pad))
                          for t in (r, k, v, w_log))
    outs = []
    for i in range(0, s + pad, chunk):
        o, state = _rwkv_chunk(r[:, i:i + chunk], k[:, i:i + chunk],
                               v[:, i:i + chunk], w_log[:, i:i + chunk],
                               p["u"], state)
        outs.append(o)
    o = torch.cat(outs, dim=1)[:, :s]
    o = rms_norm(o, p["ln_x"].reshape(h, hd), cfg.norm_eps)  # per-head group norm
    # on DTensors the heads' gradient must come back whole to be split
    # into heads again: pinned, as the forward has it
    o = (spmd.pin(o.reshape(b, s, d)) * g).to(x.dtype)
    return o @ p["wo"], state, new_shift


def rwkv_time_mix_step(p: dict, x: torch.Tensor, state: torch.Tensor,
                       shift: torch.Tensor, cfg: ModelConfig):
    """Single-token decode. x (B,1,d). Returns (out, state, shift)."""
    b, _, d = x.shape
    hd = cfg.rwkv_head_dim
    h = d // hd
    r, k, v, g, w_log, new_shift = _rwkv_projections(p, x, shift, cfg)
    r, k, v, w_log = (t[:, 0] for t in (r, k, v, w_log))     # (B,H,hd)
    o = torch.einsum("bhd,bhde->bhe", r, state)
    rb = torch.einsum("bhd,hd,bhd->bh", r, p["u"], k)
    o = o + rb[..., None] * v
    new_state = (state * torch.exp(w_log)[..., None]
                 + torch.einsum("bhd,bhe->bhde", k, v))
    o = rms_norm(o[:, None], p["ln_x"].reshape(h, hd), cfg.norm_eps)
    o = (o.reshape(b, 1, d) * g.reshape(b, 1, d)).to(x.dtype)
    return o @ p["wo"], new_state, new_shift


def init_rwkv_channel_mix(generator: torch.Generator, cfg: ModelConfig,
                          dtype, device, lead: Tuple[int, ...] = ()) -> dict:
    d = cfg.d_model
    return {
        "mu": _fp32(generator, (*lead, 2, d), device, "uniform"),
        "wk": dense_init(generator, d, cfg.d_ff, dtype, device, lead),
        "wv": dense_init(generator, cfg.d_ff, d, dtype, device, lead),
        "wr": dense_init(generator, d, d, dtype, device, lead),
    }


def rwkv_channel_mix(p: dict, x: torch.Tensor, shift: torch.Tensor):
    """Squared-ReLU FFN with receptance gate; shift (B,d). Returns (out, shift)."""
    xs = _shifted(x, shift)
    xk = _rwkv_mix(x, xs, p["mu"][0])
    xr = _rwkv_mix(x, xs, p["mu"][1])
    k = torch.square(torch.relu((xk @ p["wk"]).float()))
    vv = k.to(x.dtype) @ p["wv"]
    r = torch.sigmoid((xr @ p["wr"]).float())
    return (r * vv.float()).to(x.dtype), x[:, -1]


# ---------------------------------------------------------------------------
# Mamba selective SSM
# ---------------------------------------------------------------------------

MAMBA_CHUNK = 128


def init_mamba(generator: torch.Generator, cfg: ModelConfig, dtype, device,
               lead: Tuple[int, ...] = ()) -> dict:
    d = cfg.d_model
    di = cfg.ssm_expand * d
    n = cfg.ssm_state_dim
    rank = max(d // 16, 1)
    w = lambda a, b: dense_init(generator, a, b, dtype, device, lead)
    a_log = torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                   device=device)).expand(*lead, di, n)
    return {
        "in_proj": w(d, 2 * di),
        "conv_w": _fp32(generator, (*lead, cfg.ssm_conv_dim, di), device,
                        "normal").mul_(0.2).to(dtype),
        "conv_b": torch.zeros(*lead, di, dtype=torch.float32, device=device),
        "x_proj": w(di, rank + 2 * n),
        "dt_proj": w(rank, di),
        "dt_bias": torch.zeros(*lead, di, dtype=torch.float32, device=device),
        "a_log": a_log.contiguous(),
        "d_skip": torch.ones(*lead, di, dtype=torch.float32, device=device),
        "out_proj": w(di, d),
    }


def _mamba_conv(p: dict, x: torch.Tensor, conv_state: torch.Tensor):
    """Causal depthwise conv, kernel k. x (B,S,di); conv_state (B,k-1,di)."""
    kk = p["conv_w"].shape[0]
    s = x.shape[1]
    xp = torch.cat([conv_state.to(x.dtype), x], dim=1)
    out = torch.zeros_like(x, dtype=torch.float32)
    for j in range(kk):
        out = out + xp[:, j:j + s].float() * p["conv_w"][j].float()
    out = out + p["conv_b"]
    new_state = xp[:, -(kk - 1):] if kk > 1 else conv_state
    return out.to(x.dtype), new_state


def _mamba_scan_inputs(p: dict, xc: torch.Tensor, cfg: ModelConfig):
    """xc (B,S,di) post-conv+silu -> dt (B,S,di) fp32, B/C (B,S,N) fp32."""
    n = cfg.ssm_state_dim
    rank = p["dt_proj"].shape[0]
    # on DTensors x_proj is row-parallel: its partial sums are reduced
    # here, before the softplus and the scan read them
    proj = spmd.reduce_partial(xc @ p["x_proj"])
    dt_r, bm, cm = torch.split(proj, [rank, n, n], dim=-1)
    dt = _softplus((dt_r @ p["dt_proj"]).float() + p["dt_bias"])
    return dt, bm.float(), cm.float()


def _mamba_in(p: dict, x: torch.Tensor, conv_state: torch.Tensor,
              cfg: ModelConfig):
    """Input projection, causal conv and silu, and the scan inputs."""
    # on DTensors each half is sharded over the model axis as the whole
    # was, as the rest of the block's weights expect
    x_in, z = spmd.chunk(x @ p["in_proj"], 2, dim=-1)
    xc_raw, new_conv = _mamba_conv(p, x_in, conv_state)
    xc = F.silu(xc_raw.float()).to(x.dtype)
    dt, bm, cm = _mamba_scan_inputs(p, xc, cfg)
    return xc, z, dt, bm, cm, new_conv


def _mamba_out(p: dict, y: torch.Tensor, xc: torch.Tensor, z: torch.Tensor,
               dtype) -> torch.Tensor:
    y = y + p["d_skip"] * xc.float()
    y = (y * F.silu(z.float())).to(dtype)
    return y @ p["out_proj"]


def mamba_forward(p: dict, x: torch.Tensor, h_state: torch.Tensor,
                  conv_state: torch.Tensor, cfg: ModelConfig,
                  chunk: int = MAMBA_CHUNK):
    """Full-sequence. x (B,S,d); h_state (B,di,N) fp32; conv (B,k-1,di).
    Returns (out (B,S,d), h_state, conv_state)."""
    s = x.shape[1]
    xc, z, dt, bm, cm, new_conv = _mamba_in(p, x, conv_state, cfg)
    a_mat = -torch.exp(p["a_log"])                       # (di,N) < 0
    h = h_state
    ys = []
    for i in range(0, s, chunk):
        dtc, bc, cc = dt[:, i:i + chunk], bm[:, i:i + chunk], cm[:, i:i + chunk]
        a = torch.exp(dtc[..., None] * a_mat)           # (B,C,di,N) in (0,1]
        bx = ((dtc * xc[:, i:i + chunk].float())[..., None]
              * bc[:, :, None, :])
        hs = []
        for t in range(a.shape[1]):
            h = a[:, t] * h + bx[:, t]
            hs.append(h)
        ys.append(spmd.einsum("bcdn,bcn->bcd", torch.stack(hs, dim=1), cc))
    y = torch.cat(ys, dim=1)
    return _mamba_out(p, y, xc, z, x.dtype), h, new_conv


def mamba_step(p: dict, x: torch.Tensor, h_state: torch.Tensor,
               conv_state: torch.Tensor, cfg: ModelConfig):
    """Single-token decode. x (B,1,d)."""
    xc, z, dt, bm, cm, new_conv = _mamba_in(p, x, conv_state, cfg)
    a_mat = -torch.exp(p["a_log"])
    a = torch.exp(dt[:, 0, :, None] * a_mat)             # (B,di,N)
    bx = (dt[:, 0] * xc[:, 0].float())[..., None] * bm[:, 0, None, :]
    new_h = a * h_state + bx
    y = torch.einsum("bdn,bn->bd", new_h, cm[:, 0])[:, None]
    return _mamba_out(p, y, xc, z, x.dtype), new_h, new_conv
