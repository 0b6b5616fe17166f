"""Paged decode attention: the CUDA kernel's wrapper.

Port of the Pallas TPU kernel ``repro/kernels/paged_attention.py:
paged_attention``; the kernel is ``csrc/paged_attention.cu``.  One query
token per sequence attends its paged KV (grid (B, KV), a token loop per
block).  On a CPU tensor the wrapper computes the plain PyTorch version
(``kernels/ref.py``); on a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import paged_attention_ref

MAX_GROUP = 16      # query heads per KV head one block holds


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, block_tables: torch.Tensor,
                    context_lens: torch.Tensor) -> torch.Tensor:
    """q (B, KV, G, hd); pools (N, bs, KV, hd); tables (B, nb) int32;
    lens (B,) int32.  Returns (B, KV, G, hd) in q's dtype.  ``lens = 0``
    gives zero rows.  Counts each kernel launch in
    ``paged_attention.launches``."""
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pool, v_pool, block_tables,
                                   context_lens)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: no kernel for {q.device}")
    b, kv, g, hd = q.shape
    n, bs = k_pool.shape[:2]
    nb = block_tables.shape[1]
    if (k_pool.shape != (n, bs, kv, hd) or v_pool.shape != k_pool.shape
            or block_tables.shape != (b, nb) or context_lens.shape != (b,)):
        raise ValueError("paged_attention: inconsistent operand shapes")
    if not 1 <= g <= MAX_GROUP:
        raise ValueError(f"paged_attention: G={g} outside 1..{MAX_GROUP}")
    build.check_operands("paged_attention", (q, k_pool, v_pool),
                         (block_tables, context_lens))
    out = torch.empty_like(q)
    if b == 0 or nb == 0:
        # nothing to attend: a zero grid dimension is a launch error
        return out.zero_()
    lib = build.load_library()
    with torch.cuda.device(q.device):
        rc = lib.paged_attention_launch(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            block_tables.data_ptr(), context_lens.data_ptr(), out.data_ptr(),
            b, kv, g, hd, nb, bs, build.dtype_code(q),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged_attention: launch failed, cudaError {rc}")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
