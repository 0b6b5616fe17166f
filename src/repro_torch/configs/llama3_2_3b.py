"""Llama-3.2-3B — [dense] 28L d_model=3072 24H (GQA kv=8) d_ff=8192
vocab=128256, rope_theta=500k. [hf:meta-llama/Llama-3.2-1B family]

Sharding note: 24 heads % 16 != 0 -> GSPMD pads the head dim on the
model axis; KV heads (8) are replicated across model shards.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b",
    family="dense",
    num_layers=28,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=128_256,
    rope_theta=500_000.0,
    source="hf:meta-llama/Llama-3.2-1B",
)
