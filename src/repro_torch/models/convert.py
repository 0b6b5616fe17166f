"""Carry a JAX parameter pytree across to the port.

The port's params mirror the JAX package's layout leaf for leaf — the
layer-stacked leading dims and the ``(d_in, d_out)`` weights — so the two
compute the same function on the same weights.  The tree arrives as
numpy arrays (``jax.tree_util.tree_map(np.asarray, params)``); nothing
here imports JAX.  Each leaf keeps the dtype the JAX tree holds it in:
the model-dtype weights, and the fp32 leaves the JAX package keeps fp32
whatever the model dtype (norm scales, routers, SSM decays and mixes).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device

# numpy holds JAX's bfloat16 through ml_dtypes; its dtype is named
# "bfloat16", which torch.from_numpy does not take
_TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "float16": torch.float16, "int32": torch.int32}


def params_from_jax(np_tree: dict, device=None) -> dict:
    """numpy pytree -> nested dict of tensors on ``device`` (the CUDA card
    by default), each leaf in its own dtype.  bfloat16 leaves pass
    through fp32, which is exact."""
    device = resolve_device(device)

    def conv(tree):
        out = {}
        for key, leaf in tree.items():
            if isinstance(leaf, dict):
                out[key] = conv(leaf)
                continue
            leaf = np.asarray(leaf)
            dtype = _TORCH_DTYPE.get(leaf.dtype.name)
            if dtype is None:
                raise TypeError(f"leaf {key!r}: no torch dtype for "
                                f"{leaf.dtype}")
            wide = np.float32 if leaf.dtype.kind in "fV" else leaf.dtype
            out[key] = torch.from_numpy(np.array(leaf, wide)).to(
                device=device, dtype=dtype)
        return out

    return conv(np_tree)
