"""Gemma3-27B — [dense] 62L d_model=5376 32H (GQA kv=16) d_ff=21504
vocab=262144; 5:1 local(sliding 1024):global attention, 128k context.
head_dim fixed at 128 (gemma3 decouples it from d_model).
[hf:google/gemma-3-1b-pt family card]

long_500k applies: 5/6 of layers have window-bounded KV; global layers
keep full-context KV (see models/attention.py).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b",
    family="dense",
    num_layers=62,
    d_model=5376,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=21_504,
    vocab_size=262_144,
    qk_norm=True,
    sliding_window=1024,
    global_attn_every=6,   # layers with index % 6 == 5 are global
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    source="hf:google/gemma-3-1b-pt",
)
