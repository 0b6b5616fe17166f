"""Attention kernels of the fused serving step: hand-written CUDA kernels
for Hopper (``csrc/``), their plain PyTorch versions (``ref``), and the
backend switch (``ops``)."""
from repro_torch.kernels.ops import (
    default_backend,
    paged_attention,
    ragged_segment_attention,
)
from repro_torch.kernels.ref import (
    chunked_prefill_attention_ref,
    paged_attention_ref,
    ragged_segment_attention_ref,
)

__all__ = ["default_backend", "paged_attention", "ragged_segment_attention",
           "chunked_prefill_attention_ref", "paged_attention_ref",
           "ragged_segment_attention_ref"]
