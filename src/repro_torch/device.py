"""Device and dtype resolution shared by the port's entry points.

Entry points run on the CUDA card unless the caller asks for the CPU:
``device=None`` means ``cuda`` and raises when CUDA is absent, so a run
never falls back to the CPU unnoticed.
"""
from __future__ import annotations

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_device(device=None, rank=None) -> torch.device:
    """``None`` -> the CUDA card (raises without one); else as given, with
    a bare ``"cuda"`` pinned to the current card's index.  Given the
    process's ``rank`` (a tensor-parallel shard), ``None`` and a bare
    ``"cuda"`` mean card ``rank % device_count``.

    On a CUDA device this also turns TF32 off for float32 matrix products
    and convolutions: the port's float32 runs are held to the reference
    at float32 precision, and TF32 keeps about three decimal digits."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available: pass device='cpu' "
                               "to run on the CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            # "cuda" names the current card; tensors made there report
            # "cuda:<index>", and the two compare unequal
            device = torch.device("cuda", torch.cuda.current_device()
                                  if rank is None
                                  else rank % torch.cuda.device_count())
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's ``dtype`` string."""
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype {name!r}; choose from "
                         f"{tuple(_DTYPES)}")
    return _DTYPES[name]
