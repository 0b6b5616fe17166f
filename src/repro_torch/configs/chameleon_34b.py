"""Chameleon-34B — [vlm] 48L d_model=8192 64H (GQA kv=8) d_ff=22016
vocab=65536; early-fusion: images are discrete VQ tokens inside the same
65536 vocab, so the backbone consumes plain token ids. The VQ-GAN image
tokenizer is the sanctioned frontend stub. [arXiv:2405.09818]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="vlm",
    num_layers=48,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22_016,
    vocab_size=65_536,
    qk_norm=True,  # chameleon uses QK-norm for training stability
    frontend="vision_patches",
    source="arXiv:2405.09818",
)
