"""Jamba-v0.1-52B — [hybrid] 32L d_model=4096 32H (GQA kv=8) d_ff=14336,
Mamba:attention 7:1 interleave (attn at index 4 of each 8-layer block),
MoE 16 experts top-2 on every second layer. [arXiv:2403.19887]

long_500k applies: 28/32 layers carry O(1) Mamba state; the 4 attention
layers keep full KV (batch=1, seq sharded over `data`).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

_PATTERN = tuple("attn" if (i % 8) == 4 else "mamba" for i in range(32))

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14_336,
    vocab_size=65_536,
    layer_pattern=_PATTERN,
    moe=MoEConfig(
        num_experts=16,
        top_k=2,
        d_expert=14_336,
        moe_layer_period=2,    # MoE on odd layers
    ),
    ssm_state_dim=16,
    ssm_expand=2,
    ssm_conv_dim=4,
    source="arXiv:2403.19887",
)
