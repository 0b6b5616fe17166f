"""Tensor-parallel serving on local tensors: mesh slices, driver and
follower ranks.

The JAX package serves a tensor-parallel instance from one controller
that drives every device of its mesh slice through ``shard_map``.  The
port runs one process per rank instead, over a ``torch.distributed``
process group the caller creates (gloo or NCCL; this module picks no
backend and no device):

* A :class:`MeshSlice` is one instance's ranks, the group its shards
  all-reduce over, and a *control* group of the driver (global rank 0)
  and the slice's ranks.
* Every rank of a slice holds a :class:`~repro_torch.serving.engine.
  PagedModelRunner` on its own shard: local tensors, the megatron column
  or row slice of each layer weight (:func:`shard_params`), a KV pool of
  its own KV heads, and two fp32 all-reduces a layer.  No DTensor: its
  per-op dispatch costs more than a serving iteration can spend.
* The engine, its scheduler, the cluster and the Kairos control plane
  run on the driver alone.  The driver's runner posts each operation to
  its slice over the control group (:meth:`MeshSlice.post`); the
  followers run :func:`~repro_torch.serving.engine.serve_follower` until
  the driver shuts the slice down.  When the driver holds no shard of a
  slice it receives each result from the slice's first rank.

Group creation order.  ``dist.new_group`` is collective over the whole
default group: every rank must call it, members or not, for the same
groups in the same order, or the ranks deadlock.  The one place that
creates groups is :func:`make_serving_slices`, which every rank calls
with the same arguments; it walks the slices in order and creates each
slice's groups in a fixed order.
"""
from __future__ import annotations

import dataclasses
import enum
from types import SimpleNamespace
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.launch.mesh import slice_ranks
from repro_torch.models.sharding import serving_param_specs

DRIVER = 0          # the global rank that runs the engines
HEADER_WORDS = 32   # int64 words of an operation header


class Op(enum.IntEnum):
    """Operations the driver posts to a slice's followers."""
    FUSED = 1
    PREFILL = 2
    SUFFIX = 3
    DECODE = 4
    COPY = 5
    READ = 6
    WRITE = 7
    ADDRESS = 8
    CLONE = 9
    SHUTDOWN = 10


def _dist():
    import torch.distributed as dist
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("no process group: init_process_group first "
                           "(tensor-parallel serving runs one process "
                           "per rank)")
    return dist


@dataclasses.dataclass(frozen=True)
class MeshSlice:
    """One tensor-parallel instance's ranks, seen from this process.

    ``group`` spans ``ranks`` (None for a one-rank slice: nothing to
    reduce); ``control`` spans the driver and ``ranks`` (None when the
    driver is the slice's only rank: nobody to post to).  Control
    messages and results travel as tensors on ``wire``: the host for
    gloo, the card for NCCL, which takes no host tensor."""
    ranks: Tuple[int, ...]
    rank: int
    group: object = None
    control: object = None
    wire: torch.device = torch.device("cpu")

    @property
    def tp(self) -> int:
        return len(self.ranks)

    @property
    def is_member(self) -> bool:
        return self.rank in self.ranks

    @property
    def index(self) -> Optional[int]:
        """This rank's shard index in the slice, None off the slice."""
        return self.ranks.index(self.rank) if self.is_member else None

    @property
    def is_driver(self) -> bool:
        return self.rank == DRIVER

    @property
    def relays(self) -> bool:
        """This rank sends the slice's results to the driver: the first
        rank of a slice the driver holds no shard of."""
        return DRIVER not in self.ranks and self.index == 0

    # -- the all-reduce of the sharded layer tail -----------------------------
    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the slice's shards, in place."""
        _dist().all_reduce(t, group=self.group)
        return t

    # -- the control group: driver -> followers --------------------------------
    def post(self, op: Op, *words: int, payload=None) -> None:
        """Driver: send one operation header (and an int32 payload) to
        every follower of the slice."""
        dist = _dist()
        n = 0 if payload is None else int(payload.numel())
        vals = [int(op), n, *words]
        if len(vals) > HEADER_WORDS:
            raise ValueError(f"{op.name}: {len(vals)} header words")
        head = torch.zeros(HEADER_WORDS, dtype=torch.int64)
        head[:len(vals)] = torch.tensor(vals, dtype=torch.int64)
        dist.broadcast(head.to(self.wire), src=DRIVER, group=self.control)
        if n:
            dist.broadcast(payload.to(self.wire, torch.int32).contiguous(),
                           src=DRIVER, group=self.control)

    def receive(self) -> Tuple[Op, List[int], Optional[torch.Tensor]]:
        """Follower: the next operation, its words and its payload."""
        dist = _dist()
        head = torch.empty(HEADER_WORDS, dtype=torch.int64, device=self.wire)
        dist.broadcast(head, src=DRIVER, group=self.control)
        vals = head.tolist()
        payload = None
        if vals[1]:
            payload = torch.empty(vals[1], dtype=torch.int32,
                                  device=self.wire)
            dist.broadcast(payload, src=DRIVER, group=self.control)
            payload = payload.cpu()
        return Op(vals[0]), vals[2:], payload

    # -- point to point: results and KV blocks ---------------------------------
    def send(self, t: torch.Tensor, dst: int) -> None:
        """Send ``t`` to global rank ``dst`` over the control group."""
        t = t.detach().contiguous()
        if t.dtype in _WIRE:
            t = t.view(_WIRE[t.dtype])
        _dist().send(t.to(self.wire), dst=dst, group=self.control)

    def recv(self, shape, dtype: torch.dtype, src: int) -> torch.Tensor:
        """A host tensor of ``shape`` and ``dtype`` from global rank
        ``src``."""
        buf = torch.empty(shape, dtype=_WIRE.get(dtype, dtype),
                          device=self.wire)
        _dist().recv(buf, src=src, group=self.control)
        return buf.cpu().view(dtype)

    def from_first(self, shape, dtype: torch.dtype) -> torch.Tensor:
        """Driver off the slice: the result the slice's first rank sends."""
        return self.recv(shape, dtype, self.ranks[0])

    def gather(self, local: Optional[torch.Tensor], shape,
               dtype: torch.dtype) -> List[torch.Tensor]:
        """Driver: every shard's part in rank order (its own is
        ``local``); a follower sends ``local`` and gets []."""
        if not self.is_driver:
            self.send(local, DRIVER)
            return []
        return [local if r == self.rank else self.recv(shape, dtype, r)
                for r in self.ranks]

    def scatter(self, parts: Sequence[torch.Tensor]) -> Optional[torch.Tensor]:
        """Driver: send each shard its part, keep its own (returned)."""
        own = None
        for r, p in zip(self.ranks, parts):
            if r == self.rank:
                own = p
            else:
                self.send(p, r)
        return own


# gloo's point-to-point takes no bfloat16 on every build: 16-bit floats
# travel as their raw bits
_WIRE = {torch.bfloat16: torch.int16, torch.float16: torch.int16}


def make_serving_slices(n_slices: int, model_parallel: int = 1,
                        ranks: Optional[Sequence[int]] = None
                        ) -> List[MeshSlice]:
    """Carve the process group's ranks (or ``ranks``) into ``n_slices``
    disjoint slices of ``model_parallel`` ranks (``launch.mesh.
    slice_ranks``, the carving of ``make_slice_meshes``) and create
    their groups.

    Collective: every rank of the default group calls it with the same
    arguments.  The groups are created here and nowhere else, slice by
    slice, each slice's compute group before its control group, so
    every rank creates the same groups in the same order."""
    carved = slice_ranks(n_slices, model_parallel, ranks)
    dist = _dist()
    rank = dist.get_rank()
    wire = (torch.device("cuda", torch.cuda.current_device())
            if dist.get_backend() == "nccl" else torch.device("cpu"))
    if any(r >= dist.get_world_size() for rs in carved for r in rs):
        raise ValueError(f"ranks {carved} exceed the world size "
                         f"{dist.get_world_size()}")
    out = []
    for rs in carved:
        group = dist.new_group(rs) if len(rs) > 1 else None
        ctl = sorted({DRIVER, *rs})
        if len(ctl) == 1:
            control = None
        elif ctl == list(rs):
            control = group
        else:
            control = dist.new_group(ctl)
        out.append(MeshSlice(tuple(rs), rank, group, control, wire))
    return out


def shard_params(params: dict, cfg, tp: int, index: int) -> dict:
    """Shard ``index`` of ``tp`` of a full parameter tree: each leaf
    narrowed along the dim its serving spec (``models.sharding.
    serving_param_specs``) puts on the "model" axis, as a contiguous
    copy; replicated leaves (embedding, norms, LM head) are the same
    tensors.  Heads are laid out group-contiguous, so the column slice
    of wq / wk / wv holds whole KV heads and their query groups."""
    specs = serving_param_specs(
        params, cfg,
        SimpleNamespace(shape={"data": 1, "model": tp},
                        axis_names=("data", "model")))

    def take(leaf, spec):
        if isinstance(leaf, dict):
            return {k: take(leaf[k], spec[k]) for k in leaf}
        out = leaf
        for d, ax in enumerate(spec):
            if ax is None:
                continue
            if ax != "model":
                raise ValueError(f"serving spec {spec}: axis {ax!r}")
            n = leaf.shape[d] // tp
            out = out.narrow(d, index * n, n)
        return out if out is leaf else out.contiguous()

    return take(params, specs)


def raw_kv(kv: np.ndarray) -> torch.Tensor:
    """Host KV blocks (``read_blocks``' numpy, ``uint16`` bits for
    bfloat16) as a tensor that travels and writes back bit for bit."""
    kv = np.ascontiguousarray(kv)
    if kv.dtype in (np.uint16, np.int16):
        return torch.from_numpy(kv.view(np.int16))
    return torch.from_numpy(kv)
