"""Ragged segment attention: the CUDA kernel's wrapper.

Port of the Pallas TPU kernel ``repro/kernels/ragged_attention.py:
ragged_segment_attention``; the kernel is ``csrc/ragged_attention.cu``.
Each prompt chunk ("segment") is a dense (L,) tile of queries at absolute
positions, attending its own sequence's pool-resident KV through a
per-segment block table under a segment-blocked causal mask: one block
per 128 (bfloat16) or 64 (float32) query rows of one KV head, a key-tile
loop bounded by the rows' largest position.  bfloat16 runs its products
on the tensor cores (wgmma); float32 runs on an fp32 CUDA-core body.  On
a CPU tensor the wrapper computes the plain PyTorch version
(``kernels/ref.py``); on a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import ragged_segment_attention_ref

MAX_GROUP = 64      # query heads per KV head one block holds


def ragged_segment_attention(q: torch.Tensor, k_pool: torch.Tensor,
                             v_pool: torch.Tensor, block_tables: torch.Tensor,
                             positions: torch.Tensor) -> torch.Tensor:
    """q (S, L, KV, G, hd); pools (N, bs, KV, hd); tables (S, nb) int32;
    positions (S, L) int32.  Returns (S, L, KV, G, hd) in q's dtype; an
    empty q is returned as is.  Counts each kernel launch in
    ``ragged_segment_attention.launches``."""
    if q.numel() == 0:      # absent prefill part (decode-only iteration)
        return q
    if q.device.type == "cpu":
        return ragged_segment_attention_ref(q, k_pool, v_pool, block_tables,
                                            positions)
    if q.device.type != "cuda":
        raise ValueError(f"ragged_segment_attention: no kernel for "
                         f"{q.device}")
    s, lq, kv, g, hd = q.shape
    n, bs = k_pool.shape[:2]
    nb = block_tables.shape[1]
    if (k_pool.shape != (n, bs, kv, hd) or v_pool.shape != k_pool.shape
            or block_tables.shape != (s, nb) or positions.shape != (s, lq)
            or nb == 0):
        raise ValueError("ragged_segment_attention: inconsistent operand "
                         "shapes")
    if not 1 <= g <= MAX_GROUP:
        raise ValueError(f"ragged_segment_attention: G={g} outside "
                         f"1..{MAX_GROUP}")
    build.check_operands("ragged_segment_attention", (q, k_pool, v_pool),
                         (block_tables, positions))
    out = torch.empty_like(q)
    lib = build.load_library()
    with torch.cuda.device(q.device):
        rc = lib.ragged_attention_launch(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            block_tables.data_ptr(), positions.data_ptr(), out.data_ptr(),
            s, lq, kv, g, hd, nb, bs, build.dtype_code(q),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ragged_segment_attention: launch failed, "
                           f"cudaError {rc}")
    build.count_launch(ragged_segment_attention)
    return out


ragged_segment_attention.launches = 0
