"""Carry a JAX parameter pytree across to the port.

The port's params mirror the JAX package's layout leaf for leaf — the
layer-stacked leading dim and the ``(d_in, d_out)`` weights — so the two
compute the same function on the same weights.  The tree arrives as
numpy arrays (``jax.tree_util.tree_map(np.asarray, params)``); nothing
here imports JAX.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device, torch_dtype

# norm scales stay fp32 whatever the model dtype, as in the JAX package
FP32_LEAVES = frozenset({"ln1", "ln2", "final_norm", "q_norm", "k_norm"})


def params_from_jax(np_tree: dict, cfg: ModelConfig, device=None,
                    dtype: Optional[torch.dtype] = None) -> dict:
    """numpy pytree -> nested dict of tensors on ``device`` (the CUDA card
    by default).  Weights take ``dtype`` (default: the config's); norm
    scales stay fp32.  bf16 leaves pass through fp32, which is exact."""
    device = resolve_device(device)
    dtype = dtype or torch_dtype(cfg.dtype)

    def conv(tree):
        out = {}
        for key, leaf in tree.items():
            if isinstance(leaf, dict):
                out[key] = conv(leaf)
                continue
            t = torch.from_numpy(np.array(leaf, np.float32))
            out[key] = t.to(device=device, dtype=torch.float32
                            if key in FP32_LEAVES else dtype)
        return out

    return conv(np_tree)
