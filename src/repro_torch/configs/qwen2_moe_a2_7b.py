"""Qwen1.5-MoE-A2.7B — [moe] 24L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=151936, MoE 60 routed experts top-4 + 4 shared experts.
[hf:Qwen/Qwen1.5-MoE-A2.7B]

Sharding note (DESIGN.md §5): 60 experts % 16 != 0 -> experts are
tensor-parallel (d_expert 1408 = 16*88) instead of expert-parallel.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=151_936,
    rope_theta=1_000_000.0,
    moe=MoEConfig(
        num_experts=60,
        top_k=4,
        d_expert=1408,
        num_shared_experts=4,
        d_shared=5632,
        moe_layer_period=1,
    ),
    source="hf:Qwen/Qwen1.5-MoE-A2.7B",
)
