"""A plain forward pass of the configured decoder in float32.

It follows the configuration file (``spec.Arch``) and reads the weights
the benchmark made, in the port's parameter layout: ``embed`` (V, d),
``lm_head`` (d, V) when untied, ``final_norm`` (d,), and under
``layers`` every leaf stacked on a leading layer dim: ``ln1`` / ``ln2``
(d,), ``attn`` {``wq`` (d, H*hd), ``wk`` / ``wv`` (d, KV*hd), ``wo``
(H*hd, d), ``q_norm`` / ``k_norm`` (hd,)}, and ``ffn`` {``w_gate``,
``w_up`` (d, f), ``w_down`` (f, d)} or ``moe`` {``router`` (d, E),
``w_gate`` / ``w_up`` (E, d, f), ``w_down`` (E, f, d), ``shared``
{...}}.  Norm scales multiply by ``1 + scale``.

The equations: RMSNorm; q, k, v projections, per-head RMSNorm of q and k
where ``qk_norm``; RoPE on the two halves of each head (angles
``position * theta ** (-i / (hd / 2))``); causal grouped-query attention
with softmax scale ``hd ** -0.5``; the output projection; a SwiGLU FFN,
or for a mixture of experts a softmax router over all experts, the
top-k, gates renormalised where ``norm_topk_prob``, every assignment
computed (none dropped), plus the shared FFN; the final norm and the
head (the embedding, transposed, where tied).  No cache, no batching,
no kernels: one sequence, every position.

``precision`` names the arithmetic of the matrix products: ``float32``
(the reference; TF32 is switched off), or a lower precision the control
computes in: ``bfloat16`` rounds each product's inputs to bf16, and
``float8_e4m3fn`` scales each activation row and each weight column to
the e4m3 range and rounds there.  The products accumulate in float32 in
every case; norms, RoPE, softmax and attention stay float32.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch

from portbench.reference.spec import Arch

PRECISIONS = ("float32", "bfloat16", "float8_e4m3fn")
FP8_MAX = 448.0
NEG_INF = -1e30


@contextlib.contextmanager
def no_tf32():
    """float32 products in float32, not TF32, on the card."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _round(t: torch.Tensor, precision: str, dim: int) -> torch.Tensor:
    """``t`` (float32) rounded to ``precision``; fp8 scales along ``dim``
    (the reduced dim of the product) by the absolute maximum."""
    if precision == "float32":
        return t
    if precision == "bfloat16":
        return t.to(torch.bfloat16).float()
    scale = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


class Forward:
    """The reference model over one weight dict."""

    def __init__(self, weights: dict, arch: Arch,
                 precision: str = "float32", q_chunk: int = 1024):
        if precision not in PRECISIONS:
            raise ValueError(f"unknown precision {precision!r}")
        self.w, self.arch, self.precision = weights, arch, precision
        self.q_chunk = q_chunk

    # -- pieces ---------------------------------------------------------------
    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x (n, k) float32 @ w (k, m) in the run's precision."""
        return (_round(x, self.precision, -1)
                @ _round(w.float(), self.precision, 0))

    def norm(self, x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        var = x.square().mean(dim=-1, keepdim=True)
        return x * torch.rsqrt(var + self.arch.eps) * (1.0 + scale.float())

    def rope(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """x (S, heads, hd)."""
        half = self.arch.head_dim // 2
        inv = 1.0 / (self.arch.rope_theta ** (
            torch.arange(half, dtype=torch.float32, device=x.device) / half))
        ang = pos.float()[:, None] * inv[None, :]
        sin, cos = torch.sin(ang)[:, None, :], torch.cos(ang)[:, None, :]
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)

    def swiglu(self, x: torch.Tensor, p: dict, i: int,
               e: Optional[int] = None) -> torch.Tensor:
        def w(name):
            t = p[name][i]
            return t if e is None else t[e]
        g = self.mm(x, w("w_gate"))
        u = self.mm(x, w("w_up"))
        return self.mm(torch.nn.functional.silu(g) * u, w("w_down"))

    def attention(self, x: torch.Tensor, i: int) -> torch.Tensor:
        a, p = self.arch, self.w["layers"]["attn"]
        s, hd = x.shape[0], a.head_dim
        q = self.mm(x, p["wq"][i]).view(s, a.heads, hd)
        k = self.mm(x, p["wk"][i]).view(s, a.kv_heads, hd)
        v = self.mm(x, p["wv"][i]).view(s, a.kv_heads, hd)
        if a.qk_norm:
            q = self.norm(q, p["q_norm"][i])
            k = self.norm(k, p["k_norm"][i])
        pos = torch.arange(s, device=x.device)
        q, k = self.rope(q, pos), self.rope(k, pos)
        g = a.heads // a.kv_heads
        qg = q.view(s, a.kv_heads, g, hd)
        outs = []
        for lo in range(0, s, self.q_chunk):
            hi = min(s, lo + self.q_chunk)
            sc = torch.einsum("qkgd,tkd->kgqt", qg[lo:hi], k) * hd ** -0.5
            mask = pos[lo:hi, None] >= pos[None, :]
            sc = torch.where(mask, sc, NEG_INF)
            o = torch.einsum("kgqt,tkd->qkgd", torch.softmax(sc, dim=-1), v)
            outs.append(o.reshape(hi - lo, a.heads * hd))
        return self.mm(torch.cat(outs), p["wo"][i])

    def moe(self, x: torch.Tensor, i: int) -> torch.Tensor:
        m, p = self.arch.moe, self.w["layers"]["moe"]
        probs = torch.softmax(x @ p["router"][i].float(), dim=-1)
        gate, idx = probs.topk(m.top_k, dim=-1)
        if m.renormalize:
            gate = gate / gate.sum(dim=-1, keepdim=True)
        out = torch.zeros_like(x)
        flat = idx.reshape(-1)
        order = torch.argsort(flat)
        counts = torch.bincount(flat, minlength=m.num_experts).tolist()
        start = 0
        for e, c in enumerate(counts):
            if c:
                sel = order[start:start + c]
                rows = sel // m.top_k
                y = self.swiglu(x[rows], p, i, e)
                out.index_add_(0, rows, y * gate.reshape(-1)[sel, None])
            start += c
        if m.d_shared:
            out = out + self.swiglu(x, p["shared"], i)
        return out

    # -- the whole pass -------------------------------------------------------
    @torch.no_grad()
    def hidden(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (S,) ids -> the final-normed states (S, d), float32."""
        a, w = self.arch, self.w
        with no_tf32():
            x = w["embed"][tokens.long()].float()
            lay = w["layers"]
            for i in range(a.layers):
                x = x + self.attention(self.norm(x, lay["ln1"][i]), i)
                h = self.norm(x, lay["ln2"][i])
                x = x + (self.moe(h, i) if a.moe is not None
                         else self.swiglu(h, lay["ffn"], i))
            return self.norm(x, w["final_norm"])

    @torch.no_grad()
    def head(self, x: torch.Tensor) -> torch.Tensor:
        """Final-normed states (n, d) -> float32 logits (n, V)."""
        w = self.w
        with no_tf32():
            return self.mm(x, w["embed"].T if self.arch.tied
                           else w["lm_head"])

    def logits(self, tokens: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
        """tokens (S,) ids -> float32 logits (len(rows), V) at positions
        ``rows``."""
        return self.head(self.hidden(tokens)[rows.long()])
