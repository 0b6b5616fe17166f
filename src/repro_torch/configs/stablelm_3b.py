"""StableLM-3B — [dense] 32L d_model=2560 32H (GQA kv=32, i.e. MHA)
d_ff=6912 vocab=50304. [hf:stabilityai/stablelm-2-1_6b family]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b",
    family="dense",
    num_layers=32,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    d_ff=6912,
    vocab_size=50_304,
    source="hf:stabilityai/stablelm-2-1_6b",
)
