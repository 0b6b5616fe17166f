"""Sharding rules for every architecture x input shape, the JAX package's
``models/sharding.py`` on DTensor.

Mesh axes: ("data", "model") single pod, ("pod", "data", "model")
multi-pod.  Batch shards over pod x data; weights megatron-style over
model; MoE experts expert-parallel over model when divisible, else per-
expert tensor parallel; optional FSDP adds a data-axis shard on weight
d_model dims (kimi-k2 training).  long_500k (batch=1) context-shards the
KV sequence dim over pod x data.

A :class:`PartitionSpec` names, per tensor dim, the mesh axis (or tuple
of axes) that dim is split over, or None.  The rules read a mesh only
through ``mesh.shape[name]`` and ``mesh.axis_names``, so a
:class:`NamedMesh` over a torch ``DeviceMesh`` and a bare stand-in with
those two attributes serve alike.  :func:`to_placements` turns a spec
into DTensor placements, the counterpart of a ``NamedSharding``.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

from repro_torch.configs.base import ModelConfig, ShapeConfig


def _canonical(part):
    """A tuple of one axis is that axis, an empty tuple None (as JAX
    canonicalises a partition)."""
    if isinstance(part, tuple):
        return None if not part else part[0] if len(part) == 1 else part
    return part


class PartitionSpec(tuple):
    """Per tensor dim: a mesh axis name, a tuple of names, or None.  The
    empty spec replicates; a spec shorter than the tensor leaves the
    trailing dims unsharded."""

    def __new__(cls, *parts):
        return super().__new__(cls, (_canonical(p) for p in parts))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class NamedMesh:
    """A torch ``DeviceMesh`` with named axes, exposing ``shape``
    ({axis name: size}), ``axis_names`` and ``size`` as a JAX mesh does."""

    def __init__(self, device_mesh):
        names = device_mesh.mesh_dim_names
        if names is None:
            raise ValueError("the DeviceMesh needs mesh_dim_names")
        self.device_mesh = device_mesh
        self.axis_names = tuple(names)
        self.shape = dict(zip(self.axis_names, device_mesh.mesh.shape))
        self.size = math.prod(self.shape.values())

    def __repr__(self) -> str:
        return f"NamedMesh({self.shape})"


def to_placements(spec, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each
    mesh dim that tensor dim ``d`` names (a tuple such as
    ("pod", "data") shards one tensor dim over several mesh dims, major
    to minor as the mesh orders them), ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    owner = {}
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        names = ax if isinstance(ax, tuple) else (ax,)
        order = [mesh.axis_names.index(a) for a in names]
        if order != sorted(order):
            raise ValueError(f"{spec}: axes {names} are not in the mesh's "
                             f"order {mesh.axis_names}")
        for a in names:
            if a in owner:
                raise ValueError(f"{spec}: mesh axis {a!r} shards two dims")
            owner[a] = d
    return [Shard(owner[a]) if a in owner else Replicate()
            for a in mesh.axis_names]


class NamedSharding:
    """A spec on a mesh: what a leaf of :func:`param_shardings` holds."""

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = PartitionSpec(*spec)

    @property
    def placements(self) -> list:
        return to_placements(self.spec, self.mesh)

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


def tree_map_with_path(fn, tree, path: Tuple[str, ...] = ()):
    """``fn(path, leaf)`` over a nested dict, ``path`` the tuple of keys
    down to the leaf (what the reference reads from a pytree path)."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    return fn(path, tree)


def dp_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def _axis_size(mesh, name: str) -> int:
    return mesh.shape[name] if name in mesh.axis_names else 1


def _div(n: int, k: int) -> bool:
    return k > 0 and n % k == 0


# --------------------------------------------------------------------------- #
# parameter rules
# --------------------------------------------------------------------------- #


def param_pspec(path: Tuple[str, ...], leaf, cfg: ModelConfig, mesh,
                fsdp: bool = False) -> PartitionSpec:
    """Map a parameter-tree path to a PartitionSpec.

    The returned spec addresses the TRAILING dims of the (possibly
    layer-stacked) leaf; leading stack dims are padded with None.
    """
    key = path[-1]
    msize = _axis_size(mesh, "model")
    d_axis = "data" if (fsdp and "data" in mesh.axis_names) else None

    def base() -> Optional[Tuple]:
        m = cfg.moe
        # ---- embeddings -----------------------------------------------------
        # vocab dim only: FSDP-sharding the d_model dim here would put the
        # contraction dim of the LM head on `data` and force a full-logits
        # fp32 all-reduce
        if key == "embed":
            return ("model", None)
        if key == "lm_head":
            return (None, "model")
        # ---- MoE ------------------------------------------------------------
        if key == "router":
            return (None, None)
        if key in ("w_gate", "w_up", "w_down") and leaf.ndim >= 3 and m is not None:
            ep = _div(m.num_experts, msize)
            if key == "w_down":   # (E, f, d)
                return ("model", None, d_axis) if ep else (None, "model", d_axis)
            return ("model", d_axis, None) if ep else (None, d_axis, "model")
        # ---- dense ffn -------------------------------------------------------
        if key in ("w_gate", "w_up"):
            return (d_axis, "model")
        if key == "w_down":
            return ("model", d_axis)
        # ---- attention -------------------------------------------------------
        if key in ("wq",):
            return (d_axis, "model")
        if key in ("wk", "wv"):
            kv_flat = cfg.num_kv_heads * cfg.resolved_head_dim
            return (d_axis, "model") if _div(kv_flat, msize) else (None, None)
        if key == "wo":
            return ("model", d_axis)
        # ---- rwkv ------------------------------------------------------------
        if key in ("wr", "wg"):
            return (d_axis, "model")
        if key in ("w_lora_a", "w_lora_b", "w_bias", "u", "mu", "ln_x"):
            return None
        # ---- mamba -----------------------------------------------------------
        if key == "in_proj":
            return (d_axis, "model")
        if key == "out_proj":
            return ("model", d_axis)
        if key == "conv_w":
            return (None, "model")
        if key in ("conv_b", "d_skip", "dt_bias"):
            return ("model",)
        if key == "x_proj":
            return ("model", None)
        if key == "dt_proj":
            return (None, "model")
        if key == "a_log":
            return ("model", None)
        return None

    spec = base()
    if spec is None:
        return P()
    spec = tuple(spec)[-leaf.ndim:] if len(spec) > leaf.ndim else spec
    # verify divisibility; drop axes that don't divide (GSPMD would pad;
    # weights prefer explicit replication)
    dims = leaf.shape[leaf.ndim - len(spec):]
    fixed = []
    for ax, dim in zip(spec, dims):
        if ax is None:
            fixed.append(None)
            continue
        size = math.prod(_axis_size(mesh, a) for a in
                         (ax if isinstance(ax, tuple) else (ax,)))
        fixed.append(ax if _div(dim, int(size)) else None)
    pad = (None,) * (leaf.ndim - len(fixed))
    return P(*(pad + tuple(fixed)))


def param_shardings(params_shape, cfg: ModelConfig, mesh, fsdp: bool = False):
    """Nested dict of :class:`NamedSharding` matching a params (or train
    state) tree; each leaf needs ``ndim`` and ``shape``."""
    return tree_map_with_path(
        lambda keys, leaf: NamedSharding(
            mesh, param_pspec(keys, leaf, cfg, mesh, fsdp)),
        params_shape)


# --------------------------------------------------------------------------- #
# activation / batch / cache rules
# --------------------------------------------------------------------------- #


def batch_pspec(shape: ShapeConfig, mesh) -> PartitionSpec:
    dp = dp_axes(mesh)
    n_dp = math.prod(mesh.shape[a] for a in dp)
    if _div(shape.global_batch, n_dp):
        return P(dp, None)
    return P(None, None)              # long_500k: batch 1 replicated


def cache_pspecs(cfg: ModelConfig, shape: ShapeConfig, mesh,
                 cache_shape) -> dict:
    """PartitionSpecs for the decode cache tree.

    decode_32k: batch over pod x data, kv-heads over model (when
    divisible).  long_500k (batch=1): KV **sequence** dim over pod x data
    (context parallelism).  With fewer kv heads than the model axis the
    cache SEQUENCE dim shards over `model` (split-KV, flash-decoding
    style): scores stay S-sharded through the softmax and the PV
    contraction reduces just (B, H, 1, hd)."""
    dp = dp_axes(mesh)
    n_dp = math.prod(mesh.shape[a] for a in dp)
    msize = _axis_size(mesh, "model")
    batch_ok = _div(shape.global_batch, n_dp)
    kv_ok = _div(cfg.num_kv_heads, msize)
    kv_axis = "model" if kv_ok else None
    seq_axis_model = None if kv_ok else "model"
    di = cfg.ssm_expand * cfg.d_model

    specs = {}
    for key, leaf in cache_shape.items():
        if key == "pos":
            specs[key] = P()
        elif key in ("kv", "memory_kv"):
            # (L, 2, B, S, KV, hd)
            seq = leaf.shape[3]
            if batch_ok:
                sa = seq_axis_model if _div(seq, msize) else None
                specs[key] = P(None, None, dp, sa, kv_axis, None)
            else:
                if kv_ok:
                    sa = dp if _div(seq, n_dp) else None
                else:
                    sa = (dp + ("model",)) if _div(seq, n_dp * msize) else (
                        dp if _div(seq, n_dp) else None)
                specs[key] = P(None, None, None, sa, kv_axis, None)
        elif key == "rwkv_state":      # (L, B, H, hd, hd)
            specs[key] = P(None, dp if batch_ok else None, None, None, None)
        elif key in ("rwkv_shift1", "rwkv_shift2"):   # (L, B, d)
            specs[key] = P(None, dp if batch_ok else None,
                           "model" if _div(cfg.d_model, msize) else None)
        elif key == "mamba_h":         # (L, B, di, N)
            specs[key] = P(None, dp if batch_ok else None,
                           "model" if _div(di, msize) else None, None)
        elif key == "mamba_conv":      # (L, B, k-1, di)
            specs[key] = P(None, dp if batch_ok else None, None,
                           "model" if _div(di, msize) else None)
        else:
            specs[key] = P()
    return specs


# --------------------------------------------------------------------------- #
# serving (paged-engine) rules
# --------------------------------------------------------------------------- #

# Paged KV pool (L, 2, num_blocks, block_size, n_kv, hd): shard the
# KV-head dim over "model"; each tensor-parallel shard holds exactly the
# head slice its megatron-sharded K/V projections produce.
POOL_PSPEC = P(None, None, None, None, "model", None)


def serving_param_specs(params, cfg: ModelConfig, mesh):
    """PartitionSpec tree for the paged serving engine's params: the
    layer stack gets the megatron rules of :func:`param_pspec`;
    embeddings, LM head and final norm are REPLICATED (the serving head is
    argmax-only, and a vocab-sharded head would add a per-iteration vocab
    collective on the hot path)."""
    return tree_map_with_path(
        lambda keys, leaf: (param_pspec(keys, leaf, cfg, mesh)
                            if "layers" in keys else P()),
        params)


def validate_serving_tp(cfg: ModelConfig, tp: int) -> None:
    """Raise unless a ``tp``-way megatron shard of this config is exact:
    a silently replicated weight (param_pspec's fallback) would make the
    per-layer reduction double-count that block's contribution."""
    if tp <= 1:
        return
    if cfg.num_kv_heads % tp or cfg.num_heads % tp:
        raise ValueError(
            f"model_parallel={tp} must divide num_heads={cfg.num_heads} "
            f"and num_kv_heads={cfg.num_kv_heads} ({cfg.name})")
    if cfg.d_ff % tp:
        raise ValueError(
            f"model_parallel={tp} must divide d_ff={cfg.d_ff} ({cfg.name})")
    if cfg.moe is not None:
        raise ValueError(
            "tensor-parallel paged serving of MoE archs is not supported "
            "(expert-parallel serving: see ROADMAP)")


def should_fsdp(cfg: ModelConfig, kind: str) -> bool:
    """Shard weights over the `data` axis as well (FSDP-style): in
    training above 8e9 parameters (Adam keeps 12 bytes per parameter),
    in serving above 4e10 (bf16 weights alone)."""
    if kind == "train":
        return cfg.param_count() > 8e9
    return cfg.param_count() > 40e9
