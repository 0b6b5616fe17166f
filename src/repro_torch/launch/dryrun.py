"""Multi-pod dry-run on DTensor: run one step of every (architecture x
input shape x mesh) combination as rank 0 of a 256- or 512-rank cluster,
and account what that rank holds, moves and computes.

Each combination runs at published widths over a fake process group
(``torch.testing``'s ``FakeStore`` with the ``"fake"`` backend: every
collective returns at once), with the params, optimizer state, caches
and inputs made as DTensors of fake tensors under ``FakeTensorMode``,
sharded by :mod:`repro_torch.models.sharding`.  The step itself (the
train step, prefill, or one decode token at position ``s - 1``) runs
under ``CommDebugMode`` in place of the reference's lower-and-compile,
and a dispatch mode below DTensor tallies rank 0's local tensors:

* ``memory.argument_bytes``: the sum of rank 0's local shards of every
  argument (exact);
* ``memory.output_bytes``: the same for the step's outputs;
* ``memory.peak_bytes``: the most bytes rank 0's live local tensors held
  at once over the step, each storage rounded up to the 512-byte block
  of the CUDA caching allocator (``peak_bytes_estimated``: a tally, not
  a measurement; kernels' internal scratch is not in it);
* ``collectives``: bytes per rank under the reference's five names, the
  result size of each dispatched collective (on the CPU mesh DTensor
  stands an all-gather and a chunk in for an all-to-all: counted as the
  all-to-all it replaces);
* ``cost.flops``: rank 0's FLOPs, by the formulas of
  ``torch.utils.flop_counter``.

It allocates nothing on any device, so it needs no card: it runs on the
CPU, as ``repro_torch.cluster_sim`` does.  The process group exists only
inside :func:`dryrun_one` (torn down in a ``finally``); importing this
module changes no environment variable and no global torch state.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape decode_32k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out experiments/dryrun.json
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import sys
import time
import traceback
import weakref
from typing import Dict, Optional

import torch

from repro_torch.configs import (
    ARCH_IDS,
    INPUT_SHAPES,
    ModelConfig,
    ShapeConfig,
    get_config,
    shape_applicable,
)
from repro_torch.device import resolve_device
from repro_torch.models import build_model, spmd
from repro_torch.models.sharding import (
    NamedSharding,
    P,
    batch_pspec,
    cache_pspecs,
    param_shardings,
    should_fsdp,
)
from repro_torch.training.optimizer import make_train_step, tree_map

COLLECTIVE_OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                  "collective-permute")
BLOCK = 512   # the CUDA caching allocator's smallest block


def enc_len_for(cfg: ModelConfig, shape: ShapeConfig) -> int:
    if shape.kind in ("train", "prefill"):
        return shape.seq_len // 2
    return min(4096, shape.seq_len // 2)


def dec_len_for(cfg: ModelConfig, shape: ShapeConfig) -> int:
    if cfg.is_encdec and shape.kind in ("train", "prefill"):
        return shape.seq_len // 2
    return shape.seq_len


def input_specs(arch: str, shape, cfg: Optional[ModelConfig] = None
                ) -> Dict[str, torch.Tensor]:
    """Meta-tensor stand-ins for every model input (no allocation).
    ``shape`` is a name of INPUT_SHAPES or a ShapeConfig; ``cfg``
    overrides the arch's config."""
    cfg = cfg or get_config(arch)
    shape = INPUT_SHAPES[shape] if isinstance(shape, str) else shape
    b = shape.global_batch

    def meta(dims, dtype):
        return torch.empty(dims, dtype=dtype, device="meta")

    if shape.kind in ("train", "prefill"):
        s = dec_len_for(cfg, shape)
        spec = {"tokens": meta((b, s), torch.int32)}
        if shape.kind == "train":
            spec["labels"] = meta((b, s), torch.int32)
        if cfg.is_encdec:
            spec["frames"] = meta((b, enc_len_for(cfg, shape), cfg.d_model),
                                  torch.bfloat16)
        return spec
    # decode: ONE new token against a cache of seq_len
    return {"tokens": meta((b, 1), torch.int32)}


def layout_notes(cfg: ModelConfig, shape: ShapeConfig, mesh) -> list:
    """Where rank 0's numbers include a layout of the port's own, not one
    a deployment would choose: each a line for the record's
    ``layout_notes`` (empty: none known).  ``mesh`` is duck-typed
    (``shape[name]``, ``axis_names``)."""
    model = mesh.shape["model"] if "model" in mesh.axis_names else 1
    notes = []
    heads = cfg.d_model // cfg.rwkv_head_dim
    if "rwkv" in cfg.layer_kinds and heads % model \
            and shape.kind != "decode":
        notes.append(
            f"rwkv: {heads} heads do not divide over the {model}-way model "
            f"axis; gathered, so every model rank runs the whole WKV "
            f"recurrence (and in training keeps every chunk's decays)")
    if cfg.moe is not None and shape.kind != "decode":
        notes.append(
            "moe: every rank all-gathers the step's tokens over the data "
            "axes to fill its block of the expert buffer, and scatters its "
            "outputs into a buffer of all of them, where a deployment "
            "exchanges only its slots' rows (an all-to-all)")
    return notes


# --------------------------------------------------------------------------- #
# rank 0's tally
# --------------------------------------------------------------------------- #


def _collective_names():
    ops = torch.ops._c10d_functional
    return {ops.all_reduce: "all-reduce",
            ops.all_gather_into_tensor: "all-gather",
            ops.reduce_scatter_tensor: "reduce-scatter",
            ops.all_to_all_single: "all-to-all"}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def local_tensors(obj) -> list:
    """The local tensors (this rank's shards of DTensors) of nested dicts,
    lists and tuples."""
    from torch.distributed.tensor import DTensor
    if isinstance(obj, dict):
        obj = list(obj.values())
    if isinstance(obj, (list, tuple)):
        return [t for o in obj for t in local_tensors(o)]
    if isinstance(obj, DTensor):
        return [obj.to_local()]
    return [obj] if isinstance(obj, torch.Tensor) else []


def local_bytes(tree) -> int:
    """Sum of rank 0's local shard bytes over a tree's tensors."""
    return sum(_nbytes(t) for t in local_tensors(tree))


# DTensor functions the tally knows by name on the stack (see RankTally):
# (module, class or None, name prefix).  They are private, so each run
# first checks they still exist; a torch that renamed one would let the
# tally count global-shape fakes as rank 0's memory without a failure.
_STACK_NAMES = (
    ("torch.distributed.tensor._sharding_prop", "ShardingPropagator",
     "_propagate_tensor_meta"),
    ("torch.distributed.tensor._collective_utils", None,
     "shard_dim_alltoall"),
)


def _check_stack_names() -> None:
    import importlib
    for module, cls, prefix in _STACK_NAMES:
        owner = importlib.import_module(module)
        owner = getattr(owner, cls) if cls else owner
        if not any(n.startswith(prefix) for n in dir(owner)):
            raise RuntimeError(
                f"torch {torch.__version__} has no {module}."
                f"{cls + '.' if cls else ''}{prefix}*: the dry-run's tally "
                f"cannot tell its ops apart")


def _called_from(prefix: str) -> bool:
    """Whether a function whose name starts with ``prefix`` is on the
    stack of the op being dispatched."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_name.startswith(prefix):
            return True
        f = f.f_back
    return False


def _make_tally_mode():
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten
    from torch.utils.flop_counter import flop_registry

    collectives = _collective_names()
    wait_tensor = torch.ops._c10d_functional.wait_tensor

    class RankTally(TorchDispatchMode):
        """Sees every local op under DTensor (it declines DTensor-level
        ops, as CommDebugMode does, so DTensor desugars them first) and
        tallies rank 0's FLOPs, collective bytes and live storage."""

        def __init__(self):
            super().__init__()
            self.flops = 0
            self.collectives = {op: 0 for op in COLLECTIVE_OPS}
            self.live = 0
            self.peak = 0
            self._refs = {}

        def _gone(self, key, ref):
            entry = self._refs.get(key)
            if entry is not None and entry[0] is ref:
                del self._refs[key]
                self.live -= entry[1]

        def _tracked(self, st):
            entry = self._refs.get(id(st))
            return entry is not None and entry[0]() is st

        def track(self, t: torch.Tensor) -> None:
            st = t.untyped_storage()
            if self._tracked(st):
                return
            size = -(-st.nbytes() // BLOCK) * BLOCK
            ref = weakref.ref(st, lambda r, k=id(st): self._gone(k, r))
            self._refs[id(st)] = (ref, size)
            self.live += size
            self.peak = max(self.peak, self.live)

        def untrack(self, t: torch.Tensor) -> None:
            st = t.untyped_storage()
            if self._tracked(st):
                self._gone(id(st), self._refs[id(st)][0])

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            # DTensor's sharding propagation runs the op on global-shape
            # fakes to learn its output's shape: no rank holds those
            if _called_from("_propagate_tensor_meta"):
                return out
            packet = func._overloadpacket
            if packet in flop_registry:
                self.flops += flop_registry[packet](*args, **kwargs,
                                                    out_val=out)
            name = collectives.get(packet)
            if name is not None:
                nbytes = _nbytes(out)
                if name == "all-gather" and _called_from("shard_dim_alltoall"):
                    # on a CPU mesh DTensor moves a shard between dims by
                    # an all-gather and a chunk (gloo has no all-to-all);
                    # on CUDA it is an all-to-all of the input's size
                    name, nbytes = "all-to-all", _nbytes(args[0])
                self.collectives[name] += nbytes
            if packet is wait_tensor:
                # on a card the wait hands back the collective's own
                # buffer; a fake one makes a new storage: counted once
                self.untrack(args[0])
            for t in tree_flatten(out)[0]:
                if isinstance(t, torch.Tensor):
                    self.track(t)
            return out

    return RankTally()


@contextlib.contextmanager
def fake_process_group(world_size: int):
    """A ``world_size``-rank fake process group, this process rank 0; torn
    down on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


# --------------------------------------------------------------------------- #
# building one step
# --------------------------------------------------------------------------- #


def shard_tensor(t: torch.Tensor, sharding: NamedSharding):
    """``t`` as a DTensor on the sharding's mesh, its local tensor this
    rank's shard (``t`` itself where the shard is the whole)."""
    return spmd.distribute(t, sharding.mesh.device_mesh, sharding.placements)


def _shard_tree(tree, shardings):
    return tree_map(lambda t, s: shard_tensor(t, s)
                    if isinstance(t, torch.Tensor) else t, tree, shardings)


def build_step(arch: str, shape, mesh, cfg: Optional[ModelConfig] = None,
               device=None, seed: int = 0):
    """-> (step_fn, args): ``step_fn(*args)`` runs one step on DTensors of
    the arguments sharded over ``mesh`` (a NamedMesh).  Under
    ``FakeTensorMode`` it is a dry-run (nothing is allocated); otherwise
    the weights, state and tokens are drawn on ``device`` (None: the
    card) from ``seed`` and the step runs.  ``shape`` is a name of
    INPUT_SHAPES or a ShapeConfig; ``cfg`` overrides the arch's config."""
    device = resolve_device(device)
    cfg = cfg or get_config(arch)
    shape = INPUT_SHAPES[shape] if isinstance(shape, str) else shape
    model = build_model(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    fsdp = should_fsdp(cfg, shape.kind)
    specs = input_specs(arch, shape, cfg)
    bspec = batch_pspec(shape, mesh)
    ns = lambda p: NamedSharding(mesh, p)
    # pin (B, S, d) activations at every layer boundary (see model.py)
    model.act_sharding = ns(P(*bspec, None))

    def inputs(names):
        out = {}
        for k in names:
            v = specs[k]
            full = (torch.zeros(v.shape, dtype=v.dtype, device=device)
                    if v.dtype.is_floating_point else
                    torch.randint(0, cfg.vocab_size, v.shape,
                                  dtype=v.dtype, device=device,
                                  generator=gen))
            out[k] = shard_tensor(full, ns(bspec if v.ndim == 2
                                           else P(*bspec, None)))
        return out

    if shape.kind == "train":
        opt = "adafactor" if cfg.param_count() > 100e9 else "adam"
        init_state, train_step = make_train_step(model, opt)
        state = init_state(gen, device)
        state = _shard_tree(state, param_shardings(state, cfg, mesh,
                                                   fsdp=fsdp))
        return train_step, (state, inputs(specs))

    params = model.init_params(gen, device)
    params = _shard_tree(params, param_shardings(params, cfg, mesh,
                                                 fsdp=fsdp))
    if shape.kind == "prefill":
        return model.prefill, (params, *inputs(specs).values())

    # decode (serve_step): one token, full-context cache
    b = shape.global_batch
    s = dec_len_for(cfg, shape)
    if cfg.is_encdec:
        cache = model.init_cache(b, s, enc_len_for(cfg, shape), device)
    else:
        cache = model.init_cache(b, s, device)
    pspecs = cache_pspecs(cfg, shape, mesh, cache)
    cache = {k: shard_tensor(v, ns(pspecs[k]))
             if isinstance(v, torch.Tensor) else v for k, v in cache.items()}

    # decoding starts at position s-1 (cache holds s-1 tokens of context)
    def serve_step(params, cache, tokens):
        return model.decode_step(params, dict(cache, pos=s - 1), tokens)

    return serve_step, (params, cache, inputs(["tokens"])["tokens"])


def run_step(step_fn, args):
    """Run ``step_fn(*args)`` under CommDebugMode and rank 0's tally ->
    (outputs, the tally, CommDebugMode's count per collective)."""
    from torch.distributed.tensor.debug import CommDebugMode
    _check_stack_names()
    tally = _make_tally_mode()
    for leaf in local_tensors(args):
        tally.track(leaf)
    comm = CommDebugMode()
    with comm, tally:
        out = step_fn(*args)
    counts = {str(k): v for k, v in comm.get_comm_counts().items()}
    return out, tally, counts


def dryrun_one(arch: str, shape, multi_pod: bool, *,
               cfg: Optional[ModelConfig] = None, mesh_shape=None) -> Dict:
    """One combination's record.  ``mesh_shape`` (data, model) replaces
    the production mesh, as for a one-rank run held against the card."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
    t0 = time.time()
    cfg = cfg or get_config(arch)
    shape = INPUT_SHAPES[shape] if isinstance(shape, str) else shape
    production = mesh_shape is None
    if production:
        mesh_shape = (2, 16, 16) if multi_pod else (16, 16)
    n = math.prod(mesh_shape)
    rec: Dict = {"arch": arch, "shape": shape.name,
                 "mesh": "x".join(str(d) for d in mesh_shape),
                 "n_devices": n}
    if not shape_applicable(cfg, shape):
        rec["status"] = "skipped (sub-quadratic required, see DESIGN.md §4)"
        rec["elapsed_s"] = 0.0
        return rec
    try:
        with contextlib.ExitStack() as stack:
            stack.enter_context(fake_process_group(n))
            # the mesh reads its rank grid, so it is built on real tensors
            mesh = (make_production_mesh(multi_pod=multi_pod) if production
                    else make_local_mesh(mesh_shape[1]))
            stack.enter_context(FakeTensorMode(allow_non_fake_inputs=True))
            step_fn, args = build_step(arch, shape, mesh, cfg, device="cpu")
            arg_bytes = local_bytes(args)
            out, tally, counts = run_step(step_fn, args)
            rec["memory"] = {
                "argument_bytes": arg_bytes,
                "output_bytes": local_bytes(out),
                "peak_bytes": tally.peak,
                "peak_bytes_estimated": True,
            }
            rec["cost"] = {"flops": float(tally.flops)}
            rec["collectives"] = dict(tally.collectives)
            rec["collective_counts"] = counts
            rec["layout_notes"] = layout_notes(cfg, shape, mesh)
            rec["status"] = "ok"
    except Exception as e:
        rec["status"] = f"FAILED: {type(e).__name__}: {e}"[:2000]
        rec["traceback"] = traceback.format_exc()[-2000:]
    rec["elapsed_s"] = round(time.time() - t0, 1)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", action="append", default=None)
    ap.add_argument("--shape", action="append", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    archs = args.arch or (list(ARCH_IDS) if args.all else ["llama3.2-3b"])
    shapes = args.shape or (list(INPUT_SHAPES) if args.all else ["decode_32k"])
    meshes = [False, True] if (args.both_meshes or args.all) else [args.multi_pod]

    records = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                rec = dryrun_one(arch, shape, mp)
                records.append(rec)
                mem = rec.get("memory", {}) or {}
                peak = mem.get("peak_bytes")
                peak_s = f"{peak/2**30:.2f}GiB/dev" if peak else "n/a"
                flops = (rec.get("cost", {}) or {}).get("flops")
                fl_s = f"{flops:.3g}F/dev" if flops else ""
                print(f"[{rec['status'][:40]:40s}] {arch:22s} {shape:12s} "
                      f"{rec['mesh']:8s} {peak_s:14s} {fl_s} ({rec['elapsed_s']}s)",
                      flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
        print(f"wrote {args.out}")
    n_fail = sum(1 for r in records if r["status"].startswith("FAILED"))
    print(f"\n{len(records) - n_fail}/{len(records)} combinations compiled")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
