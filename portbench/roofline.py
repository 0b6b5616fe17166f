"""Peaks of the chip and the operations and bytes the served work needs.

Peaks are NVIDIA's published figures for one H100 SXM (dense, no
sparsity), which assume the card's full 700 W: 989 TFLOP/s in bf16 and
3.35 TB/s of HBM3.  A run records the card's ``power.limit`` beside
every share taken against them.

Counts are of what the inputs need, each input byte read once and each
output byte written once, whatever a kernel reads again:

* decode attention (the paged kernel), a row of context ``c``: its K and
  V over ``c`` positions, its query and its output;
* prefill-chunk attention (the ragged kernel), a chunk of ``n`` tokens
  at positions ``start .. start + n - 1``: 4 * hd * heads operations for
  every (query, visible key) pair, ``n * start + n (n + 1) / 2`` pairs;
  its K and V over the ``start + n`` positions, its queries and outputs;
* the step: 2 * (the parameters a token passes through) a token computed,
  the head's 2 * d * V for each row whose logits are taken, and
  4 * context * hd * heads a layer of attention.
"""
from __future__ import annotations

from typing import Iterable, Sequence, Tuple

from portbench.reference.spec import Arch, dtype_bytes

PEAK_FLOPS = 989e12        # bf16 dense, H100 SXM
PEAK_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM


def paged_bytes(a: Arch, contexts: Iterable[int]) -> int:
    """Bytes one launch of decode attention over rows of these context
    lengths needs, in one layer."""
    b = dtype_bytes(a.dtype)
    kv = 2 * a.kv_heads * a.head_dim * b
    qo = 2 * a.heads * a.head_dim * b
    return sum(c * kv + qo for c in contexts)


def ragged_cost(a: Arch, chunks: Sequence[Tuple[int, int]]):
    """(operations, bytes) one launch of chunk attention over chunks
    ``(start, end)`` needs, in one layer."""
    b = dtype_bytes(a.dtype)
    ops = by = 0
    for start, end in chunks:
        n = end - start
        pairs = n * start + n * (n + 1) // 2
        ops += 4 * a.head_dim * a.heads * pairs
        by += (end * 2 * a.kv_heads * a.head_dim
               + 2 * n * a.heads * a.head_dim) * b
    return ops, by


def bound_s(ops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of the two."""
    return max(ops / PEAK_FLOPS, nbytes / PEAK_BYTES_PER_S)


def step_flops(a: Arch, n_tokens: int, context_sum: int,
               sampled_rows: int) -> int:
    """Operations of ``n_tokens`` computed tokens whose contexts (position
    + 1) sum to ``context_sum``, and of the head on ``sampled_rows``."""
    return (n_tokens * 2 * a.matrix_params()
            + context_sum * 4 * a.head_dim * a.heads * a.layers
            + sampled_rows * 2 * a.d_model * a.vocab)


def chunk_contexts_sum(start: int, end: int) -> int:
    """Sum of the contexts (position + 1) of a chunk's tokens."""
    n = end - start
    return n * start + n * (n + 1) // 2
