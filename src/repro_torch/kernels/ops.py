"""The attention entry points of the fused step, with a backend switch.

``backend="cuda"`` runs the hand-written CUDA kernels (``csrc/``) on a
CUDA tensor; ``"ref"`` runs the plain PyTorch versions
(``kernels/ref.py``).  The serving runner picks ``default_backend`` of
its device: ``"cuda"`` on the card, ``"ref"`` on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.paged_attention import (
    paged_attention as _paged_cuda,
)
from repro_torch.kernels.ragged_attention import (
    ragged_segment_attention as _ragged_cuda,
)

PAGED_BACKENDS = ("cuda", "ref")
RAGGED_BACKENDS = ("cuda", "ref", "flat", "flat_ref")


def default_backend(device) -> str:
    return "cuda" if torch.device(device).type == "cuda" else "ref"


def _check(backend: str, allowed) -> None:
    # a typo'd backend must not silently run the plain version in the
    # hot loop (token-identical, so nothing else would catch it)
    if backend not in allowed:
        raise ValueError(f"unknown attention backend {backend!r}; "
                         f"choose from {allowed}")


def paged_attention(q, k_pool, v_pool, block_tables, context_lens,
                    backend: str = "ref"):
    """Decode attention over a paged KV pool.  See kernels/ref.py for
    shapes."""
    _check(backend, PAGED_BACKENDS)
    if q.numel() == 0:      # absent decode part (prefill-only iteration)
        return q
    if backend == "cuda":
        return _paged_cuda(q, k_pool, v_pool, block_tables, context_lens)
    return _ref.paged_attention_ref(q, k_pool, v_pool, block_tables,
                                    context_lens)


def ragged_segment_attention(q, k_pool, v_pool, block_tables, positions,
                             backend: str = "ref"):
    """Segment-blocked causal attention over a paged pool for the prefill
    part of a fused :class:`~repro_torch.serving.batch_scheduler.
    IterationBatch` — every chunk's tokens tiled to (S, L).  See
    ``kernels/ref.py`` for shapes and mask semantics.

    Backends
    --------
    ``"cuda"``
        The segment-tiled CUDA kernel (``csrc/ragged_attention.cu``).
    ``"flat"`` / ``"flat_ref"``
        The flatten-and-repeat lowering onto the single-query paged
        decode path — S·L query rows, block tables repeated per row, each
        row's context length set to ``position + 1`` — over the CUDA
        decode kernel or its plain version; kept as a differential
        reference for the segment kernel.
    ``"ref"``
        The plain PyTorch version, with the same segment-bounded page
        gather as the kernel.
    """
    _check(backend, RAGGED_BACKENDS)
    if q.numel() == 0:      # absent prefill part (decode-only iteration)
        return q
    if backend == "cuda":
        return _ragged_cuda(q, k_pool, v_pool, block_tables, positions)
    if backend in ("flat", "flat_ref"):
        s, lq, kv, g, hd = q.shape
        flat_q = q.reshape(s * lq, kv, g, hd)
        flat_bt = block_tables.repeat_interleave(lq, dim=0)
        flat_cl = positions.reshape(-1) + 1
        paged = _paged_cuda if backend == "flat" else _ref.paged_attention_ref
        out = paged(flat_q, k_pool, v_pool, flat_bt, flat_cl)
        return out.reshape(s, lq, kv, g, hd)
    return _ref.ragged_segment_attention_ref(q, k_pool, v_pool, block_tables,
                                             positions)
