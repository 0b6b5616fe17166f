"""RWKV6-3B (Finch) — [ssm] 32L d_model=2560 attention-free d_ff=8960
vocab=65536; data-dependent per-channel decay, matrix-valued WKV state.
[arXiv:2404.05892]

O(1) decode state -> long_500k applies; the paper's Eq.1 KV ramp
degenerates to a constant (DESIGN.md §4).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    num_layers=32,
    d_model=2560,
    num_heads=0,
    num_kv_heads=0,
    d_ff=8960,
    vocab_size=65_536,
    rwkv_head_dim=64,          # 40 heads of 64
    source="arXiv:2404.05892",
)
