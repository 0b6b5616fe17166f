"""Production mesh definitions, over ranks of a torch process group.

Functions, not module-level constants, so importing this module touches
no device and no process group.  Production target: 16x16 = 256 ranks
per pod; the multi-pod mesh adds a leading "pod" axis (2 pods = 512
ranks).  Each mesh comes back as a :class:`NamedMesh`, which the
sharding rules read through ``shape`` and ``axis_names``.

The serving topology uses rank-level meshes: :func:`make_local_mesh` for
one tensor-parallel instance, :func:`make_slice_meshes` to carve the
ranks into disjoint same-size slices (data-parallel instances x
tensor-parallel shards); :func:`slice_ranks` gives the same carving
without a mesh.  Every argument is validated before a mesh is built.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

from repro_torch.models.sharding import NamedMesh

# the dry-run's fake tensors live on the CPU, and its meshes with them
DEVICE_TYPE = "cpu"


def _world_ranks() -> List[int]:
    import torch.distributed as dist
    if not dist.is_initialized():
        raise RuntimeError("no process group: init_process_group first "
                           "(or pass ranks=)")
    return list(range(dist.get_world_size()))


def make_production_mesh(*, multi_pod: bool = False) -> NamedMesh:
    """("data", "model") 16x16, or ("pod", "data", "model") 2x16x16, over
    the current process group, whose world size must match."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return NamedMesh(init_device_mesh(DEVICE_TYPE, shape,
                                      mesh_dim_names=axes))


def make_local_mesh(model_parallel: int = 1,
                    ranks: Optional[Sequence[int]] = None) -> NamedMesh:
    """("data", "model") mesh over ``ranks`` (default: every rank of the
    process group).  ``model_parallel`` must be a positive factor of the
    rank count."""
    ranks = list(ranks) if ranks is not None else _world_ranks()
    n = len(ranks)
    if model_parallel < 1:
        raise ValueError(
            f"model_parallel must be >= 1, got {model_parallel}")
    if n == 0 or n % model_parallel != 0:
        raise ValueError(
            f"model_parallel={model_parallel} does not divide the "
            f"{n} available device(s); pick a factor of the device count "
            f"(or pass an explicit `devices=` slice)")
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    grid = torch.tensor(ranks, dtype=torch.int64).reshape(
        n // model_parallel, model_parallel)
    return NamedMesh(DeviceMesh(DEVICE_TYPE, grid,
                                mesh_dim_names=("data", "model")))


def slice_ranks(n_slices: int, model_parallel: int = 1,
                ranks: Optional[Sequence[int]] = None) -> List[List[int]]:
    """The rank lists :func:`make_slice_meshes` builds its meshes over:
    ``n_slices`` consecutive groups of ``model_parallel`` ranks, validated
    as it validates them, with no mesh and no process group made (the
    tensor-parallel serving slices make their own groups)."""
    ranks = list(ranks) if ranks is not None else _world_ranks()
    if n_slices < 1:
        raise ValueError(f"n_slices must be >= 1, got {n_slices}")
    need = n_slices * model_parallel
    if need > len(ranks):
        raise ValueError(
            f"{n_slices} slice(s) x {model_parallel}-way model parallel "
            f"needs {need} devices; only {len(ranks)} available")
    if model_parallel < 1:
        raise ValueError(
            f"model_parallel must be >= 1, got {model_parallel}")
    return [ranks[i * model_parallel:(i + 1) * model_parallel]
            for i in range(n_slices)]


def make_slice_meshes(n_slices: int, model_parallel: int = 1,
                      ranks: Optional[Sequence[int]] = None
                      ) -> List[NamedMesh]:
    """Disjoint ("data", "model") sub-meshes for data-parallel serving:
    ``n_slices`` consecutive groups of ``model_parallel`` ranks, one
    tensor-parallel instance per slice, no rank shared between slices."""
    return [make_local_mesh(model_parallel, r)
            for r in slice_ranks(n_slices, model_parallel, ranks)]
