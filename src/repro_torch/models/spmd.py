"""What the model needs to run on DTensor activations and weights.

The model's functions are written for plain tensors.  Given DTensors
(the dry-run's sharded params, caches and inputs) they follow DTensor's
sharding propagation, save where it cannot follow an op that GSPMD
would partition; there the resharding GSPMD would insert is made
explicit by these helpers, each called at the op it serves:

* a tensor made inside the model (positions, RoPE tables, masks, zero
  states) is lifted onto the mesh of the activation it meets;
* a dim is gathered before a reshape that would split it unevenly over
  a mesh axis (eight KV heads over a 16-way model axis), or its shard
  moved to another dim; the chunks of a sharded dim are resharded as it
  was;
* a product whose operands are both sharded along two batch dims runs
  on each rank's shards (DTensor's ``bmm`` refuses that layout);
* a layer's FSDP-sharded weights are gathered before it runs;
* vocab-parallel lookups and picks finish with one reduction;
* a gradient is brought back to its forward layout where DTensor would
  hand back one the ops before it cannot follow.

With plain tensors every helper returns its input unchanged, so the
model computes what it did; ``torch.distributed.tensor`` is imported
only once a DTensor is seen.
"""
from __future__ import annotations

import torch


def is_dtensor(t) -> bool:
    if type(t) is torch.Tensor or not isinstance(t, torch.Tensor):
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def lift(t: torch.Tensor, like: torch.Tensor, dims=()) -> torch.Tensor:
    """``t``, made inside the model, on the mesh of ``like``: dim ``i``
    of ``t`` sharded as dim ``dims[i]`` of ``like`` (a zero state takes
    the batch's sharding with ``dims=(0,)``), replicated elsewhere.
    Plain ``like``: ``t``."""
    if not is_dtensor(like):
        return t
    return distribute(t, like.device_mesh, _placements_as(like, dims))


def _placements_as(ref: torch.Tensor, dims) -> list:
    """Placements for a tensor whose dim ``i`` is dim ``dims[i]`` of the
    DTensor ``ref``: sharded where that dim is, replicated over every
    other mesh dim."""
    from torch.distributed.tensor import Replicate, Shard
    owner = {d % ref.ndim: i for i, d in enumerate(dims)}
    return [Shard(owner[p.dim]) if isinstance(p, Shard) and p.dim in owner
            else Replicate() for p in ref.placements]


def distribute(t: torch.Tensor, mesh, placements) -> torch.Tensor:
    """``t``, whole on every rank, as a DTensor of ``placements`` on
    ``mesh``: each rank keeps its shard, no collective."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local_shard(t, mesh, placements), mesh,
                              placements, run_check=False, shape=t.shape,
                              stride=t.stride())


def local_shard(t: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's shard of ``t`` (whole on every rank) under
    ``placements``: ``t`` itself where nothing is sharded, else a
    contiguous copy of the slice."""
    from torch.distributed.tensor import Shard
    coord = mesh.get_coordinate() or [0] * mesh.ndim
    local = t
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            n = local.shape[p.dim] // mesh.size(i)
            assert n * mesh.size(i) == local.shape[p.dim], \
                (tuple(t.shape), placements)
            local = local.narrow(p.dim, coord[i] * n, n)
    if local.shape != t.shape:
        local = local.clone(memory_format=torch.contiguous_format)
    return local


def shard_ways(t: torch.Tensor, dim: int) -> int:
    """How many shards the mesh cuts ``t``'s ``dim`` into (1 for a plain
    tensor)."""
    if not is_dtensor(t):
        return 1
    from torch.distributed.tensor import Shard
    dim = dim % t.ndim
    ways = 1
    for i, p in enumerate(t.placements):
        if isinstance(p, Shard) and p.dim == dim:
            ways *= t.device_mesh.size(i)
    return ways


def gather(t: torch.Tensor, dim: int, unless_divides: int = 0):
    """``t`` with ``dim`` replicated over every mesh dim that shards it:
    the all-gather GSPMD inserts before a reshape that splits ``dim``
    into ``unless_divides`` groups the shard count does not divide (with
    ``unless_divides`` 0, always).  Plain ``t``: ``t``."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate, Shard
    dim = dim % t.ndim
    # a shard over a one-rank mesh dim is gathered too: DTensor refuses
    # an unbind along any sharded dim
    if not any(isinstance(p, Shard) and p.dim == dim for p in t.placements):
        return t
    if unless_divides and unless_divides % shard_ways(t, dim) == 0:
        return t
    placements = [Replicate() if isinstance(p, Shard) and p.dim == dim
                  else p for p in t.placements]
    return t.redistribute(t.device_mesh, placements)


def chunk(t: torch.Tensor, n: int, dim: int) -> tuple:
    """``torch.chunk(t, n, dim)``.  On a DTensor sharded along ``dim`` a
    chunk spans some ranks' shards and not others', which DTensor cannot
    express: ``dim`` is gathered, and each chunk is sharded as ``t`` was
    (a local slice), the resharding GSPMD makes of a slice of a sharded
    dim."""
    if not is_dtensor(t):
        return torch.chunk(t, n, dim)
    whole = gather(t, dim)
    if whole is t:
        return torch.chunk(t, n, dim)
    return tuple(c.redistribute(t.device_mesh, t.placements)
                 for c in torch.chunk(whole, n, dim))


def spread(t: torch.Tensor, dim: int, other: torch.Tensor) -> torch.Tensor:
    """``t`` with ``dim`` sharded over every mesh dim on which neither
    ``t`` nor ``other`` is sharded (where ``dim`` divides): work every rank
    of that mesh dim would repeat is split instead, a local slice.
    Plain ``t``: ``t``."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate, Shard
    dim = dim % t.ndim
    mesh, n = t.device_mesh, t.shape[dim]
    placements = list(t.placements)
    for i, (p, q) in enumerate(zip(t.placements, other.placements)):
        ways = shard_ways(t, dim) * mesh.size(i)
        if isinstance(p, Replicate) and isinstance(q, Replicate) \
                and mesh.size(i) > 1 and n % ways == 0:
            placements[i] = Shard(dim)
            t = t.redistribute(mesh, placements)
    return t


def move_shard(t: torch.Tensor, src: int, dst: int) -> torch.Tensor:
    """``t`` with the mesh dims that shard dim ``src`` sharding dim
    ``dst`` instead (an all-to-all).  Plain ``t``: ``t``."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Shard
    src, dst = src % t.ndim, dst % t.ndim
    return t.redistribute(t.device_mesh, [
        Shard(dst) if isinstance(p, Shard) and p.dim == src else p
        for p in t.placements])


def follow(t: torch.Tensor, ref: torch.Tensor, dims) -> torch.Tensor:
    """``t`` laid out as ``ref``, dim ``i`` of ``t`` being dim ``dims[i]``
    of ``ref``: sharded where that dim is, replicated over every other
    mesh dim (a factor brought to the layout of the tensor it scales, as
    GSPMD reshards it).  Plain ``t``: ``t``."""
    if not is_dtensor(t):
        return t
    return t.redistribute(ref.device_mesh, _placements_as(ref, dims))


def match(t: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``t`` placed as ``ref`` (same rank, dims of the same meaning): for a
    replicated ``t`` a local slice, no traffic.  Plain ``t``: ``t``."""
    if not is_dtensor(t):
        return t
    return t.redistribute(ref.device_mesh, ref.placements)


def einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.einsum(eq, a, b)``.  On DTensors it runs on each rank's
    shards, as GSPMD partitions a product: DTensor lowers an einsum to
    ``bmm`` over the merged batch dims, and refuses two of them sharded
    (batch over data, heads over model).  Per mesh dim, a letter sharded
    in one operand is sliced the same way in the other where that has
    it (no traffic); a sharded contracted letter leaves a partial sum."""
    if not (is_dtensor(a) or is_dtensor(b)):
        return torch.einsum(eq, a, b)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    lhs, out = eq.replace(" ", "").split("->")
    la, lb = lhs.split(",")
    mesh = a.device_mesh if is_dtensor(a) else b.device_mesh
    a, b = lift(a, b) if not is_dtensor(a) else a, \
        lift(b, a) if not is_dtensor(b) else b

    def letter(t, labels, i):
        p = t.placements[i]
        return labels[p.dim] if isinstance(p, Shard) else None

    pa, pb, po = [], [], []
    for i in range(mesh.ndim):
        ca, cb = letter(a, la, i), letter(b, lb, i)
        if a.placements[i].is_partial() or b.placements[i].is_partial() \
                or (ca and cb and ca != cb):
            return torch.einsum(eq, a, b)      # DTensor decides
        c = ca or cb
        if c is None:
            pa.append(Replicate()), pb.append(Replicate())
            po.append(Replicate())
            continue
        pa.append(Shard(la.index(c)) if c in la else Replicate())
        pb.append(Shard(lb.index(c)) if c in lb else Replicate())
        po.append(Shard(out.index(c)) if c in out else Partial())
    a = a.redistribute(mesh, pa)
    b = b.redistribute(mesh, pb)

    def grad_placements(ps):
        # an operand replicated over a mesh dim that splits the product
        # gets from each rank only that rank's share of its gradient
        return [Partial() if isinstance(p, Replicate)
                and not isinstance(q, Replicate) else p
                for p, q in zip(ps, po)]

    local = torch.einsum(eq, a.to_local(grad_placements=grad_placements(pa)),
                         b.to_local(grad_placements=grad_placements(pb)))
    return DTensor.from_local(local, mesh, po, run_check=False)


def unshard(params: dict) -> dict:
    """A layer's params with every shard over a data axis ("pod",
    "data") gathered: FSDP's per-layer unshard, which GSPMD inserts for
    the FSDP specs of models/sharding.py.  The backward reduce-scatters
    the gradients back.  Plain leaves pass through."""
    def one(t):
        if isinstance(t, dict):
            return {k: one(v) for k, v in t.items()}
        if not is_dtensor(t):
            return t
        from torch.distributed.tensor import Replicate
        names = t.device_mesh.mesh_dim_names or ()
        placements = [Replicate() if names[i] in ("pod", "data") else p
                      for i, p in enumerate(t.placements)]
        if placements == list(t.placements):
            return t
        return t.redistribute(t.device_mesh, placements)
    return one(params)


def pin(t: torch.Tensor) -> torch.Tensor:
    """``t`` unchanged, its gradient brought back to ``t``'s placements in
    the backward.  DTensor otherwise hands a gradient whatever layout its
    producer chose; a token matrix whose rows come back split over the
    model axis as well cannot be viewed as (B, S, d) again."""
    if not is_dtensor(t):
        return t
    return t.redistribute(t.device_mesh, t.placements)


def pick_last(t: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``t[..., index]`` per row: (..., V), (...) -> (...).  On a DTensor
    sharded along its last dim (vocab-parallel logits) each rank picks
    the indices inside its shard by a one-hot product, and the partial
    sums are reduced: what GSPMD makes of the reference's one-hot
    contraction, spelt out here because DTensor's propagation of the
    broadcast compare differs between versions (some replicate the
    vocab ids, and with them the whole product)."""
    if not is_dtensor(t):
        return torch.take_along_dim(t, index[..., None], dim=-1)[..., 0]
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh, last = t.device_mesh, t.ndim - 1
    rows = [p if isinstance(p, Shard) and p.dim < last else Replicate()
            for p in t.placements]
    coord = mesh.get_coordinate() or [0] * mesh.ndim
    size, offset = t.shape[-1], 0
    for i, p in enumerate(t.placements):
        if isinstance(p, Shard) and p.dim == last:
            size //= mesh.size(i)
            offset += coord[i] * size
    local = t.to_local()
    idx = index.redistribute(mesh, rows).to_local() - offset
    hit = idx[..., None] == torch.arange(local.shape[-1], device=idx.device)
    picked = (local * hit).sum(dim=-1)
    return reduce_partial(DTensor.from_local(
        picked, mesh, [Partial() if isinstance(p, Shard) and p.dim == last
                       else p for p in t.placements], run_check=False))


def reduce_partial(t: torch.Tensor) -> torch.Tensor:
    """``t`` with every pending (partial) reduction done: the all-reduce
    that completes a vocab-parallel embedding lookup."""
    if not is_dtensor(t) or not any(p.is_partial() for p in t.placements):
        return t
    from torch.distributed.tensor import Replicate
    return t.redistribute(t.device_mesh, [Replicate() if p.is_partial()
                                          else p for p in t.placements])


def constrain(x: torch.Tensor, sharding) -> torch.Tensor:
    """Pin a (B, S, d) activation to ``sharding`` (a NamedSharding over a
    torch mesh), as ``with_sharding_constraint`` pins it in the
    reference; a no-op without a sharding or on a plain tensor."""
    if sharding is None or x.ndim != 3 or not is_dtensor(x):
        return x
    return x.redistribute(sharding.mesh.device_mesh, sharding.placements)
