"""Config system: model architecture configs and the dry-run's input
shapes.

Every architecture of the JAX package has one
``src/repro_torch/configs/<id>.py`` module exporting ``CONFIG``;
``get_config`` imports it by id.  CPU tests use the ``reduced()``
variants; the full configs run on the card.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional, Sequence, Tuple

# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int                 # ffn hidden dim of each routed expert
    num_shared_experts: int = 0   # always-on experts (qwen2-moe style)
    d_shared: int = 0             # ffn hidden of the shared expert block
    moe_layer_period: int = 1     # apply MoE every k-th layer (jamba: 2)
    capacity_factor: float = 1.25
    router_aux_loss: float = 0.01


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | encdec | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int                # 0 for attention-free archs
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 -> d_model // num_heads
    # attention variants -----------------------------------------------------
    qk_norm: bool = False
    sliding_window: Optional[int] = None   # window size for local layers
    global_attn_every: int = 0             # gemma3: 1 global per k+1 layers (5 local : 1 global -> 6)
    rope_theta: float = 10_000.0
    # layer pattern ----------------------------------------------------------
    # per-layer block kind; None -> all "attn" (or all "rwkv" for ssm family)
    layer_pattern: Optional[Tuple[str, ...]] = None  # entries: attn|mamba|rwkv
    # moe --------------------------------------------------------------------
    moe: Optional[MoEConfig] = None
    # ssm --------------------------------------------------------------------
    ssm_state_dim: int = 16       # mamba N
    ssm_expand: int = 2           # mamba d_inner = expand * d_model
    ssm_conv_dim: int = 4
    rwkv_head_dim: int = 64
    # enc-dec ----------------------------------------------------------------
    num_encoder_layers: int = 0
    # modality frontend stub -------------------------------------------------
    frontend: str = "none"        # none | audio_frames | vision_patches
    # numerics ---------------------------------------------------------------
    dtype: str = "bfloat16"
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # provenance
    source: str = ""

    # --- derived -----------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        if self.layer_pattern is not None:
            assert len(self.layer_pattern) == self.num_layers
            return self.layer_pattern
        if self.family == "ssm":
            return tuple("rwkv" for _ in range(self.num_layers))
        return tuple("attn" for _ in range(self.num_layers))

    @property
    def attn_layer_indices(self) -> Tuple[int, ...]:
        return tuple(i for i, k in enumerate(self.layer_kinds) if k == "attn")

    @property
    def is_encdec(self) -> bool:
        return self.num_encoder_layers > 0

    @property
    def sub_quadratic(self) -> bool:
        """True when the arch can decode at 500k context (O(1)/windowed state)."""
        kinds = set(self.layer_kinds)
        if kinds <= {"rwkv", "mamba"}:
            return True
        if "mamba" in kinds or "rwkv" in kinds:
            return True  # hybrid: attention layers are the minority; still runnable
        if self.sliding_window is not None:
            return True  # windowed KV bounds the cache (global layers capped, see models/attention.py)
        return False

    def moe_layer_indices(self) -> Tuple[int, ...]:
        if self.moe is None:
            return ()
        p = self.moe.moe_layer_period
        return tuple(i for i in range(self.num_layers) if (i % p) == (p - 1))

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d, hd = self.d_model, self.resolved_head_dim
        n = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        moe_layers = set(self.moe_layer_indices())
        for i, kind in enumerate(self.layer_kinds):
            if kind == "attn":
                n += d * hd * (self.num_heads + 2 * self.num_kv_heads) + self.num_heads * hd * d
            elif kind == "mamba":
                di = self.ssm_expand * d
                n += 2 * d * di + di * d + di * (2 * self.ssm_state_dim + self.ssm_conv_dim + 2)
            elif kind == "rwkv":
                n += 4 * d * d + d * d  # r,k,v,g,o projections (~5 d^2) + decay params
            if self.moe is not None and i in moe_layers:
                n += self.moe.num_experts * 3 * d * self.moe.d_expert
                n += self.moe.num_shared_experts * 3 * d * max(self.moe.d_shared, self.moe.d_expert)
                n += d * self.moe.num_experts
            elif kind != "mamba":
                n += 3 * d * self.d_ff
        if self.is_encdec:
            # encoder blocks (self-attn + ffn) + decoder cross-attn
            enc = self.num_encoder_layers * (4 * d * hd * self.num_heads + 3 * d * self.d_ff)
            xattn = self.num_layers * (d * hd * (self.num_heads + 2 * self.num_kv_heads) + self.num_heads * hd * d)
            n += enc + xattn
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top-k + shared only)."""
        if self.moe is None:
            return self.param_count()
        full = self.param_count()
        moe_layers = len(self.moe_layer_indices())
        d = self.d_model
        inactive = (self.moe.num_experts - self.moe.top_k) * 3 * d * self.moe.d_expert * moe_layers
        return full - inactive

    def kv_bytes_per_token(self, bytes_per_el: int = 2) -> int:
        """Per-token KV growth — the slope `k` of the paper's Eq. 1 (per seq)."""
        n_attn = len(self.attn_layer_indices)
        return 2 * n_attn * self.num_kv_heads * self.resolved_head_dim * bytes_per_el

    def state_bytes(self, bytes_per_el: int = 4) -> int:
        """Constant recurrent-state footprint per sequence (SSM/hybrid)."""
        d = self.d_model
        total = 0
        for kind in self.layer_kinds:
            if kind == "mamba":
                di = self.ssm_expand * d
                total += di * self.ssm_state_dim + di * self.ssm_conv_dim
            elif kind == "rwkv":
                heads = d // self.rwkv_head_dim
                total += heads * self.rwkv_head_dim * self.rwkv_head_dim + 2 * d
        return total * bytes_per_el

    def reduced(self) -> "ModelConfig":
        """Tiny same-family variant for CPU smoke tests (<=2 layers, d<=512)."""
        kinds = self.layer_kinds
        # keep at most 2 layers but preserve the kind diversity (hybrid!)
        if len(set(kinds)) > 1:
            order = []
            for k in ("mamba", "attn", "rwkv"):
                if k in kinds:
                    order.append(k)
            pat: Tuple[str, ...] = tuple(order[:2]) if len(order) >= 2 else (kinds[0],) * 2
        else:
            pat = (kinds[0],) * 2
        moe = None
        if self.moe is not None:
            moe = dataclasses.replace(
                self.moe, num_experts=4, top_k=min(self.moe.top_k, 2),
                d_expert=128, d_shared=128 if self.moe.num_shared_experts else 0,
                num_shared_experts=min(self.moe.num_shared_experts, 1),
                moe_layer_period=1)
        n_heads = min(self.num_heads, 4) if self.num_heads else 0
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            num_layers=2,
            d_model=256,
            num_heads=n_heads,
            num_kv_heads=min(self.num_kv_heads, max(n_heads // 2, 1)) if n_heads else 0,
            head_dim=64 if n_heads else 0,
            d_ff=512,
            vocab_size=512,
            layer_pattern=pat,
            moe=moe,
            sliding_window=64 if self.sliding_window else None,
            global_attn_every=min(self.global_attn_every, 2) if self.global_attn_every else 0,
            num_encoder_layers=2 if self.is_encdec else 0,
            rwkv_head_dim=64,
        )


# ---------------------------------------------------------------------------
# Input shapes
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

ARCH_IDS = (
    "qwen2-moe-a2.7b",
    "chameleon-34b",
    "gemma3-27b",
    "seamless-m4t-large-v2",
    "rwkv6-3b",
    "stablelm-3b",
    "llama3.2-3b",
    "jamba-v0.1-52b",
    "kimi-k2-1t-a32b",
    "qwen3-1.7b",
)

_MODULE_FOR = {a: "repro_torch.configs." + a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _MODULE_FOR:
        raise KeyError(f"unknown arch {arch_id!r}; choose from {ARCH_IDS}")
    mod = importlib.import_module(_MODULE_FOR[arch_id])
    return mod.CONFIG


def all_configs() -> Sequence[ModelConfig]:
    return [get_config(a) for a in ARCH_IDS]


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    """Whether (arch, shape) is a supported dry-run combination (see DESIGN.md §4)."""
    if shape.name == "long_500k":
        return cfg.sub_quadratic
    return True
