"""The model a configuration file states, as the reference and the weight
maker read it.

A configuration file (``portbench/configs/<name>.json``) holds the
published ``config.json`` keys as they are run, plus ``qk_norm`` (Qwen3
normalises q and k per head; its ``config.json`` has no key for it) and,
for a mixture of experts, ``moe_capacity_factor`` (the port's capacity
bound, set so that no assignment drops).
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoE:
    num_experts: int
    top_k: int
    d_expert: int
    d_shared: int           # width of the one always-on shared FFN (0: none)
    renormalize: bool       # ``norm_topk_prob``: gates divided by their sum
    capacity_factor: float  # the port's bound; the reference drops nothing


@dataclasses.dataclass(frozen=True)
class Arch:
    layers: int
    d_model: int
    heads: int
    kv_heads: int
    head_dim: int
    d_ff: int               # dense FFN width (unused where every layer is MoE)
    vocab: int
    eps: float
    rope_theta: float
    qk_norm: bool
    tied: bool
    dtype: str
    moe: Optional[MoE] = None

    @property
    def kv_bytes_per_token(self) -> int:
        """K and V of one token over every layer, in the served dtype."""
        return self.layers * 2 * self.kv_heads * self.head_dim * dtype_bytes(
            self.dtype)

    def matrix_params(self) -> int:
        """Parameters a token passes through in the layers (not the
        embedding or the head): attention, and the dense FFN or the top-k
        routed experts, the shared expert and the router."""
        d, hd = self.d_model, self.head_dim
        attn = d * hd * (self.heads + 2 * self.kv_heads) + self.heads * hd * d
        if self.moe is None:
            ffn = 3 * d * self.d_ff
        else:
            m = self.moe
            ffn = (m.top_k * 3 * d * m.d_expert + 3 * d * m.d_shared
                   + d * m.num_experts)
        return self.layers * (attn + ffn)


def dtype_bytes(dtype: str) -> int:
    return {"bfloat16": 2, "float16": 2, "float32": 4}[dtype]


def arch_of(config: dict) -> Arch:
    """The architecture a configuration file states."""
    d = config["hidden_size"]
    heads = config["num_attention_heads"]
    moe = None
    if config.get("num_experts"):
        moe = MoE(num_experts=config["num_experts"],
                  top_k=config["num_experts_per_tok"],
                  d_expert=config["moe_intermediate_size"],
                  d_shared=config.get("shared_expert_intermediate_size", 0),
                  renormalize=bool(config["norm_topk_prob"]),
                  capacity_factor=float(config["moe_capacity_factor"]))
    return Arch(layers=config["num_hidden_layers"], d_model=d, heads=heads,
                kv_heads=config["num_key_value_heads"],
                head_dim=config.get("head_dim") or d // heads,
                d_ff=config["intermediate_size"],
                vocab=config["vocab_size"], eps=float(config["rms_norm_eps"]),
                rope_theta=float(config["rope_theta"]),
                qk_norm=bool(config.get("qk_norm", False)),
                tied=bool(config["tie_word_embeddings"]),
                dtype=config["torch_dtype"], moe=moe)
