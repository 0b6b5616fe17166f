"""Kimi-K2 1T-A32B — [moe] 61L d_model=7168 64H (GQA kv=8) routed-expert
d_ff=2048 vocab=163840, MoE 384 experts top-8 + 1 shared expert.
Trillion-param paper-table config. [arXiv:2501.kimi2]

Sharding note: 384 experts % 16 == 0 -> expert-parallel over the `model`
axis (24 experts/shard); training uses Adafactor + FSDP over `data`
(DESIGN.md §5) — honest memory numbers in EXPERIMENTS.md §Dry-run.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    head_dim=112,
    d_ff=2048,
    vocab_size=163_840,
    moe=MoEConfig(
        num_experts=384,
        top_k=8,
        d_expert=2048,
        num_shared_experts=1,
        d_shared=2048,
        moe_layer_period=1,
    ),
    source="arXiv:2501.kimi2",
)
