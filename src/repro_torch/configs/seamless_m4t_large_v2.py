"""SeamlessM4T-large-v2 — [audio] enc-dec, 24L decoder + 24L encoder,
d_model=1024 16H (kv=16) d_ff=8192 vocab=256206. [arXiv:2308.11596]

The w2v-BERT speech frontend (mel-spectrogram + conv feature extractor)
is the sanctioned stub: ``input_specs()`` provides precomputed frame
embeddings of shape (batch, enc_len, d_model).  train/prefill shapes
split seq_len as enc_len = dec_len = seq_len // 2 (DESIGN.md §4).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    num_layers=24,             # decoder
    num_encoder_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=8192,
    vocab_size=256_206,
    frontend="audio_frames",
    source="arXiv:2308.11596",
)
