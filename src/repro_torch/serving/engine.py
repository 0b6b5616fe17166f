"""LLM engine instance: paged-KV model runner + continuous batching.

``PagedModelRunner`` executes real tokens against the paged KV pool: one
fused step per engine iteration, with the CUDA attention kernels on the
card and their plain PyTorch versions on the CPU.  The legacy per-chunk
path (one step per prefill chunk plus a padded decode step) and the
block-granular KV transfer that live migration uses sit beside it.
``LLMEngine`` implements vLLM-style continuous batching with dynamic
memory allocation and preemption-by-recompute — the behaviours the
paper's dispatcher is designed around (§2.2.3).

Engines expose the *status monitor* surface Kairos polls (§3 overview):
KV memory in use / capacity, running/waiting counts, preemption counter.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.scheduler import SchedulerPolicy
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import (
    embed_tokens,
    layer_slice,
    lm_logits,
    rms_norm,
    swiglu,
)
from repro_torch.models.model import LanguageModel, ffn_block
from repro_torch.models.sharding import validate_serving_tp
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import NULL_TRACER, Tracer
from repro_torch.serving.batch_scheduler import (
    BatchScheduler,
    IterationBatch,
    SchedStats,
    TokenPrefixMatcher,
    flatten_plan,
)
from repro_torch.serving.faults import InstanceCrashed
from repro_torch.serving.kv_cache import BlockManager
from repro_torch.serving.prefix_cache import PrefixCache
from repro_torch.serving.request import Request
from repro_torch.serving.tensor_parallel import (
    DRIVER,
    MeshSlice,
    Op,
    raw_kv,
    shard_params,
)


# =============================================================================
# Paged model runner (uniform-attention architectures)
# =============================================================================


def _layer_qkv(lp, x, sin, cos, cfg):
    """Transformer-layer head: pre-norm, QKV projection with qk-norm, RoPE
    on q/k."""
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    q, k, v = attn_mod._project_qkv(lp["attn"], h, h, cfg)
    return attn_mod.apply_rope(q, sin, cos), attn_mod.apply_rope(k, sin, cos), v


def _layer_finish(x, o, lp, cfg, reduce=None):
    """Transformer-layer tail: attention output projection and the FFN or
    MoE block (``models.model.ffn_block``), both residual.  ``o`` is
    (..., H*hd).

    ``reduce`` is a tensor-parallel slice's all-reduce.  ``o`` then holds
    the shard's local heads and ``wo`` the matching rows, and the FFN's
    ``w_down`` its rows of the shard's ``d_ff`` columns, so both products
    are partial sums: the two megatron all-reduces of a layer.  Each is
    formed and summed in fp32 and rounded to the activation dtype once,
    after the whole contraction, as the reference's
    ``preferred_element_type=f32`` products and ``psum`` do.  Without
    ``reduce`` the ops are the unsharded ones, unchanged."""
    if reduce is None:
        x = x + o @ lp["attn"]["wo"]
        return x + ffn_block(lp, rms_norm(x, lp["ln2"], cfg.norm_eps), cfg)
    x = x + reduce(o.float() @ lp["attn"]["wo"].float()).to(x.dtype)
    h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + reduce(swiglu(h2, **lp["ffn"], out_float=True)).to(x.dtype)


# IterationBatch arrays uploaded to the device, in order
_BATCH_FIELDS = ("tokens_p", "positions_p", "tables_p", "tokens_d",
                 "positions_d", "tables_d", "write_slots", "sample_rows",
                 "cow_src", "cow_dst")
_SAMPLE_ROWS = _BATCH_FIELDS.index("sample_rows")


def _shape_words(shapes) -> List[int]:
    """The batch arrays' shapes (1-D or 2-D) as two header words each."""
    words = []
    for shp in shapes:
        if not 1 <= len(shp) <= 2:
            raise ValueError(f"batch array of shape {shp}")
        words += [shp[0], shp[1] if len(shp) == 2 else -1]
    return words


def _shapes_of(words) -> List[Tuple[int, ...]]:
    """Inverse of :func:`_shape_words` (the header's trailing words are
    padding)."""
    words = words[:2 * len(_BATCH_FIELDS)]
    return [(a,) if b < 0 else (a, b)
            for a, b in zip(words[0::2], words[1::2])]


class PagedModelRunner:
    """Runs a :class:`LanguageModel` against a paged KV pool.

    Pool: ``self.pool`` of shape (L, 2, num_blocks, block_size, n_kv, hd).
    Decode is batched across sequences at arbitrary positions via block
    tables.

    **In-place pool** (``donate_pool``, default on).  The pool is one
    tensor allocated once per runner and updated in place by every step
    (``index_copy_`` for the KV scatters, the copy-on-write block copies
    and ``write_blocks``), so ``pool_address()`` — its ``data_ptr()`` —
    is stable for the runner's lifetime and no step copies the pool.
    ``donate_pool=False`` is the out-of-place baseline, as XLA's
    undonated output is: every pool-writing step first copies the whole
    pool into a fresh tensor and writes there, so ``pool_address()``
    changes at each such step (``pool_bytes_copied`` counts the bytes);
    the tokens are the same.  Its storage holds one spare block per
    (layer, K/V) past the ``num_blocks`` the :class:`BlockManager` hands
    out: a batch's padding rows carry write slot ``num_blocks *
    block_size`` and copy-on-write destination ``num_blocks``, and land
    in that spare block.  That carries the JAX scatters' ``mode="drop"``
    over with no host-side filtering and no device sync; block tables
    never point at the spare block, so nothing reads it.

    **Device.**  ``device=None`` means the CUDA card and raises when CUDA
    is absent; tests pass ``device="cpu"``.  ``params`` must already live
    on that device.  ``backend`` picks the attention kernels of the fused
    step (``kernels.ops``): ``"cuda"`` (the default on the card) or
    ``"ref"`` (the plain versions, the default on the CPU).
    ``ragged_backend`` picks the lowering of the prefill-chunk attention
    separately (``"cuda"``, ``"ref"``, or the flatten-and-repeat
    ``"flat"``/``"flat_ref"``); it defaults to ``backend``.  The legacy
    path's ``decode_batch`` attends through ``backend`` too;
    ``prefill_suffix`` attends densely over the gathered resident pages,
    as the reference's suffix step does.

    **Tensor parallelism** (``mesh``, a :class:`~repro_torch.serving.
    tensor_parallel.MeshSlice`).  Each rank of the slice builds the
    runner with the same arguments and the FULL ``params``; it keeps its
    megatron shard of the layer weights (``tensor_parallel.
    shard_params``: QKV and FFN gate/up columns, O and FFN down rows; the
    embedding, norms and LM head replicated), a pool of its own
    ``n_kv / tp`` KV heads, and runs the same step bodies on a local
    config (``num_heads / tp``, ``num_kv_heads / tp``), so both attention
    kernels run at the local head count; the two all-reduces of each
    layer are in :func:`_layer_finish`.  Every rank computes the same
    argmax from the all-reduced activations and the replicated head.
    The block manager stays head-agnostic: block tables, batch metadata
    and ``pool_bytes`` are those of the whole pool.  The driver (global
    rank 0) builds the engine over its runner, which posts every step to
    the slice's other ranks; they run :func:`serve_follower`.  A driver
    off the slice holds no shard and receives each result from the
    slice's first rank.  ``device=None`` on rank ``r`` means card ``r %
    device_count``.  ``pool_address()`` is then the tuple of every
    shard's address, in rank order.  A one-rank slice only places the
    runner: the steps are the unsharded ones.
    """

    # the step functions whose input-shape signatures jit_cache_size counts
    _STEP_FNS = ("fused", "decode", "prefill", "scatter", "suffix", "copy",
                 "write_blocks")

    def __init__(self, model: LanguageModel, params: dict, num_blocks: int,
                 block_size: int, max_batch: int = 8,
                 backend: Optional[str] = None,
                 ragged_backend: Optional[str] = None,
                 donate_pool: bool = True,
                 device=None, mesh: Optional[MeshSlice] = None):
        cfg = model.cfg
        assert model.uniform_kind == "attn", "paged runner serves attention archs"
        assert cfg.sliding_window is None, "windowed paged decode is not ported"
        self.mesh = mesh
        self.tp = 1 if mesh is None else mesh.tp
        validate_serving_tp(cfg, self.tp)
        self.device = resolve_device(device,
                                     None if mesh is None else mesh.rank)
        self.model, self.cfg = model, cfg
        self.block_size, self.num_blocks = block_size, num_blocks
        self.max_batch = max_batch
        self.donate_pool = donate_pool
        self.backend = backend or kops.default_backend(self.device)
        self.ragged_backend = ragged_backend or self.backend
        if self.backend not in kops.PAGED_BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}")
        if self.ragged_backend not in kops.RAGGED_BACKENDS:
            raise ValueError(f"unknown ragged backend {self.ragged_backend!r}")
        # local (per-shard) config: the step bodies reshape activations by
        # head counts; head_dim is pinned so it cannot follow num_heads
        self._lcfg = (dataclasses.replace(
            cfg, num_heads=cfg.num_heads // self.tp,
            num_kv_heads=cfg.num_kv_heads // self.tp,
            head_dim=cfg.resolved_head_dim) if self.tp > 1 else cfg)
        self._reduce = mesh.all_reduce if self.tp > 1 else None
        self._holds_shard = mesh is None or mesh.is_member
        self._posts = (mesh is not None and mesh.is_driver
                       and mesh.control is not None)
        # runners of one slice (a root and its clones) are numbered alike
        # on every rank: the driver names the runner in each post
        self._rid, self._next_rid = 0, [1]
        self.params, self._layers = None, []
        self._pool_buf = self.pool = None
        if self._holds_shard:
            if params["embed"].device != self.device:
                raise ValueError(f"params live on {params['embed'].device}, "
                                 f"the runner on {self.device}")
            if self.tp > 1:
                params = shard_params(params, cfg, self.tp, mesh.index)
            self.params = params
            self._layers = [layer_slice(params["layers"], i)
                            for i in range(cfg.num_layers)]
            self._new_pool()
        self._shape_keys = {f: set() for f in self._STEP_FNS}
        # perf counters live on a metrics registry (obs.metrics);
        # n_dispatches counts the steps issued: one per fused iteration;
        # on the legacy path each prefill (2; 1 when sharded), suffix
        # chunk, copy, decode step and argmax; one per read_blocks /
        # write_blocks
        self.metrics = MetricsRegistry()
        self.n_dispatches = 0
        # the engine that drives this runner sets these: its spans go to
        # the engine's ring
        self.tracer: Tracer = NULL_TRACER
        self.instance_id = -1

    def _new_pool(self) -> None:
        """Fresh zeroed pool of this shard's KV heads, with the spare
        padding block (see class docstring)."""
        lcfg = self._lcfg
        self._set_pool(torch.zeros(
            (lcfg.num_layers, 2, self.num_blocks + 1, self.block_size,
             lcfg.num_kv_heads, lcfg.resolved_head_dim),
            dtype=self.model.dtype, device=self.device))

    def _set_pool(self, buf: torch.Tensor) -> None:
        self._pool_buf = buf
        self.pool = buf[:, :, :self.num_blocks]

    def _writable_pool(self) -> torch.Tensor:
        """The pool storage a pool-writing step writes into: the resident
        buffer itself, or under ``donate_pool=False`` a fresh copy of it
        that replaces it (the old buffer is freed once nothing holds
        it)."""
        if not self.donate_pool:
            self._set_pool(self._pool_buf.clone())
            self.metrics.inc("pool_bytes_copied", self._pool_buf.numel()
                             * self._pool_buf.element_size())
        return self._pool_buf

    def _called(self, fn: str, *key) -> None:
        """Record the input-shape signature of one step-function call."""
        self._shape_keys[fn].add(key)

    def _post(self, op: Op, *words: int, payload=None) -> None:
        """Driver: send one step to the slice's followers (no-op on a
        runner without any)."""
        if self._posts:
            self.mesh.post(op, self._rid, *words, payload=payload)

    def _result(self, out, shape, dtype: torch.dtype):
        """A step's result on this rank: ``out``, computed here (and sent
        on to the driver when this rank relays), or on a driver that holds
        no shard the slice's first rank's."""
        if self.mesh is not None:
            if not self._holds_shard:
                return self.mesh.from_first(shape, dtype)
            if self.mesh.relays:
                self.mesh.send(out, DRIVER)
        return out

    @property
    def blocks_host(self) -> bool:
        """A step waits on the host for other processes: a sharded step's
        host-staged all-reduces, or a result received from the first rank
        of a slice this process holds no shard of.  Any other step only
        enqueues work on the device."""
        return self._reduce is not None or not self._holds_shard

    @property
    def n_dispatches(self) -> int:
        """Alias over ``metrics.counter("n_dispatches")``."""
        return int(self.metrics.counter("n_dispatches").value)

    @n_dispatches.setter
    def n_dispatches(self, v: int):
        self.metrics.counter("n_dispatches").value = float(v)

    def metrics_snapshot(self) -> dict:
        """Registry snapshot with the derived gauges refreshed (step-shape
        signatures seen, resident pool bytes: the whole pool's, every
        shard's, spare block included)."""
        cfg = self.cfg
        self.metrics.set("jit_cache_size", self.jit_cache_size())
        self.metrics.set("pool_bytes", cfg.num_layers * 2
                         * (self.num_blocks + 1) * self.block_size
                         * cfg.num_kv_heads * cfg.resolved_head_dim
                         * self.model.dtype.itemsize)
        return self.metrics.snapshot()

    def pool_address(self):
        """Device address of the pool (``data_ptr()``): stable for the
        runner's lifetime, since every update is in place — unless
        ``donate_pool=False``, where every pool-writing step moves it.
        A sharded runner returns the tuple of every shard's address, in
        rank order, each of which must be stable.  Call between synced
        iterations only."""
        if self.mesh is None:
            return self._pool_buf.data_ptr()
        self._post(Op.ADDRESS)
        return self._address()

    def _address(self):
        local = (torch.tensor([self._pool_buf.data_ptr()], dtype=torch.int64)
                 if self._holds_shard else None)
        addrs = tuple(int(a) for a in self.mesh.gather(local, (1,),
                                                       torch.int64))
        return addrs if self.tp > 1 or not addrs else addrs[0]

    def jit_cache_size(self) -> int:
        """Distinct input-shape signatures the runner's step functions
        have been called with, summed over the functions (shared with
        clones, as the reference's compiled functions are).  Eager torch
        compiles nothing; this counts what a compiler would specialise
        on, so it reads as the reference's recompile counter does: a
        drain over bucketed shapes it has seen leaves it unchanged."""
        return sum(len(k) for k in self._shape_keys.values())

    # -- block-granular KV transfer (live request migration) ------------------
    def read_blocks(self, block_ids: Sequence[int]) -> np.ndarray:
        """Gather the KV of ``block_ids`` to host: a numpy array of shape
        (L, 2, n_blocks, block_size, n_kv, hd) holding the exact bits —
        float32 for a float32 pool; for a bfloat16 pool, which numpy
        cannot hold, the raw bits as ``uint16`` (``write_blocks`` takes
        them back as such).  A sharded runner gathers every shard's KV
        heads to the driver.  The pool is only *read*: ``pool_address()``
        is unchanged.  Must run between synced iterations."""
        self.n_dispatches += 1
        ids = torch.as_tensor(np.asarray(block_ids, np.int32))
        self._post(Op.READ, payload=ids)
        return self._read(ids)

    def _read(self, ids: torch.Tensor) -> Optional[np.ndarray]:
        kv = None
        if self._holds_shard:
            kv = self.pool.index_select(
                2, ids.to(self.device, torch.long)).cpu()
        if self.mesh is not None:
            lcfg = self._lcfg
            parts = self.mesh.gather(
                kv, (lcfg.num_layers, 2, len(ids), self.block_size,
                     lcfg.num_kv_heads, lcfg.resolved_head_dim),
                self.model.dtype)
            if not parts:                      # a follower's part is sent
                return None
            kv = torch.cat(parts, dim=4)       # along the KV heads
        if kv.dtype == torch.bfloat16:
            return kv.view(torch.int16).numpy().view(np.uint16)
        return kv.numpy()

    def write_blocks(self, kv: np.ndarray, block_ids: Sequence[int]):
        """Scatter transferred KV into ``block_ids``, in place — the
        restore half of a live migration; ``kv`` is what ``read_blocks``
        returns (``uint16`` raw bits for a bfloat16 pool).  One step: the
        host-to-device copy and one ``index_copy_`` through the pool
        view, so ``pool_address()`` is unchanged (under
        ``donate_pool=True``).  A sharded runner splits ``kv`` along the
        KV heads and sends each shard its part."""
        assert kv.shape[2] == len(block_ids)
        self.n_dispatches += 1
        self._called("write_blocks", len(block_ids))
        src = raw_kv(kv)
        if src.dtype == torch.int16 and self.model.dtype != torch.bfloat16:
            raise TypeError("raw 16-bit KV needs a bfloat16 pool")
        ids = torch.as_tensor(np.asarray(block_ids, np.int32))
        if self.mesh is None:
            return self._write(src, ids)
        if src.dtype != torch.int16:
            src = src.float()
        self._post(Op.WRITE, int(src.dtype == torch.int16), payload=ids)
        own = self.mesh.scatter(src.chunk(self.tp, dim=4))
        if own is not None:
            self._write(own, ids)

    def _write(self, src: torch.Tensor, ids: torch.Tensor) -> None:
        if src.dtype == torch.int16:
            src = src.view(torch.bfloat16)
        src = src.to(self.device, self.model.dtype)
        self._writable_pool().index_copy_(
            2, ids.to(self.device, torch.long), src)

    # -- legacy per-chunk path -------------------------------------------------
    def prefill(self, tokens: torch.Tensor, block_table: List[int]):
        """tokens (S,) int32 -> last-token logits (V,).  Fills the pool.

        Two steps: the model's dense prefill, then the scatter of its
        contiguous KV into the prompt's pages.  A sharded runner routes
        through :meth:`prefill_suffix` with nothing cached instead (one
        step), as the reference does: the dense prefill makes full-head
        KV, which no shard can scatter."""
        if self.tp > 1:
            return self.prefill_suffix(tokens, block_table, 0)
        tokens = torch.as_tensor(tokens).cpu().to(torch.int32)
        s = int(tokens.shape[0])
        nb = -(-s // self.block_size)
        self.n_dispatches += 2
        self._called("prefill", s)
        self._called("scatter", s, nb)
        meta = torch.cat([tokens, torch.as_tensor(block_table[:nb],
                                                  dtype=torch.int32)])
        self._post(Op.PREFILL, s, payload=meta)
        return self._prefill(meta, s)

    @torch.no_grad()
    def _prefill(self, meta: torch.Tensor, s: int):
        out = None
        if self._holds_shard:
            bs = self.block_size
            meta = meta.to(self.device)
            tokens, bt = meta[:s], meta[s:].long()
            nb = bt.shape[0]
            logits, cache = self.model.prefill(self.params, tokens[None])
            kv = cache["kv"][:, :, 0]                     # (L, 2, S, KV, hd)
            kv = torch.nn.functional.pad(kv, (0, 0, 0, 0, 0, nb * bs - s))
            kv = kv.reshape(kv.shape[0], 2, nb, bs, *kv.shape[3:])
            self._writable_pool().index_copy_(2, bt, kv)
            out = logits[0]
        return self._result(out, (self.cfg.vocab_size,), self.model.dtype)

    def prefill_suffix(self, tokens: torch.Tensor, block_table: List[int],
                       n_cached: int):
        """tokens (S,) = the next prompt chunk; block_table covers the
        whole prompt.  The chunk attends densely over the ``n_cached``
        tokens already resident in the pool (a shared cached prefix
        and/or earlier chunks of this prompt) plus itself; only the
        chunk's KV is written, at its exact token slots, so chunk
        boundaries need not align to blocks.  Returns the chunk's
        last-token logits (V,)."""
        bs = self.block_size
        tokens = torch.as_tensor(tokens).cpu().to(torch.int32)
        s = int(tokens.shape[0])
        assert s > 0 and 0 <= n_cached
        n_ctx_blocks = -(-n_cached // bs)
        self.n_dispatches += 1
        self._called("suffix", s, n_ctx_blocks, n_cached)
        write_idx = [block_table[p // bs] * bs + p % bs
                     for p in range(n_cached, n_cached + s)]
        meta = torch.cat([tokens, torch.as_tensor(
            list(block_table[:n_ctx_blocks]) + write_idx,
            dtype=torch.int32)])
        self._post(Op.SUFFIX, s, n_cached, payload=meta)
        return self._suffix(meta, s, n_cached)

    @torch.no_grad()
    def _suffix(self, meta: torch.Tensor, s: int, n_cached: int):
        out = None
        if self._holds_shard:
            cfg = self._lcfg
            hd, n_kv = cfg.resolved_head_dim, cfg.num_kv_heads
            meta = meta.to(self.device)
            tokens = meta[:s]
            ctx_bt, write_idx = meta[s:-s].long(), meta[-s:].long()
            positions = n_cached + torch.arange(s, device=self.device)
            sin, cos = attn_mod.rope_at(positions, hd, cfg.rope_theta)
            k_pos = torch.arange(n_cached + s, device=self.device)
            bias = attn_mod._mask_bias(positions, k_pos)
            x = embed_tokens(self.params, tokens[None]).to(self.model.dtype)
            pool = self._writable_pool()
            for i, lp in enumerate(self._layers):
                q, k, v = _layer_qkv(lp, x, sin, cos, cfg)  # (1, S, ., hd)
                # resident K/V: the covering pages (roped at write), first
                # n_cached rows — the last page may be partially filled
                pk = pool[i, 0][ctx_bt].reshape(-1, n_kv, hd)[:n_cached]
                pv = pool[i, 1][ctx_bt].reshape(-1, n_kv, hd)[:n_cached]
                kf = torch.cat([pk[None], k], dim=1)         # (1, P+S, KV, hd)
                vf = torch.cat([pv[None], v], dim=1)
                probs = torch.softmax(attn_mod._gqa_scores(q, kf) + bias,
                                      dim=-1)
                o = attn_mod._gqa_out(probs, vf).reshape(1, s, -1)
                pool[i, 0].view(-1, n_kv, hd).index_copy_(0, write_idx, k[0])
                pool[i, 1].view(-1, n_kv, hd).index_copy_(0, write_idx, v[0])
                x = _layer_finish(x, o, lp, cfg, self._reduce)
            x = rms_norm(x, self.params["final_norm"], cfg.norm_eps)
            out = lm_logits(self.params, x[:, -1], cfg)[0]
        return self._result(out, (self.cfg.vocab_size,), self.model.dtype)

    def copy_block(self, src: int, dst: int):
        """Copy-on-write data path: duplicate one physical block, in
        place (one step)."""
        self.n_dispatches += 1
        self._called("copy")
        self._post(Op.COPY, src, dst)
        self._copy(src, dst)

    def _copy(self, src: int, dst: int) -> None:
        if self._holds_shard:
            pool = self._writable_pool()
            pool[:, :, dst] = pool[:, :, src]

    def decode_batch(self, tokens: np.ndarray, positions: np.ndarray,
                     block_tables: np.ndarray, live: np.ndarray):
        """One decode token per row, every input padded to a fixed batch;
        returns logits (B, V).  Dead rows (``live`` False) attend with
        context 1 and write their KV into the spare block, which no table
        names; on the card the attention is the CUDA paged kernel."""
        self.n_dispatches += 1
        b, nbmax = np.shape(block_tables)
        self._called("decode", b, nbmax)
        arrays = [np.asarray(a, np.int32).ravel()
                  for a in (tokens, positions, block_tables, live)]
        flat = torch.from_numpy(np.concatenate(arrays))
        self._post(Op.DECODE, b, nbmax, payload=flat)
        return self._decode(flat, b, nbmax)

    def _decode(self, flat: torch.Tensor, b: int, nbmax: int):
        out = None
        if self._holds_shard:
            flat = flat.to(self.device)
            tokens_t, positions_t = flat[:b], flat[b:2 * b]
            tables = flat[2 * b:2 * b + b * nbmax].view(b, nbmax)
            live_t = flat[2 * b + b * nbmax:].bool()
            out = self._decode_step(tokens_t, positions_t, tables, live_t)
        return self._result(out, (b, self.cfg.vocab_size), self.model.dtype)

    @torch.no_grad()
    def _decode_step(self, tokens, positions, block_tables, live):
        cfg = self._lcfg
        hd, n_kv, bs = cfg.resolved_head_dim, cfg.num_kv_heads, self.block_size
        g = cfg.num_heads // n_kv
        b = tokens.shape[0]
        pool = self._writable_pool()
        x = embed_tokens(self.params, tokens).to(self.model.dtype)   # (B, d)
        ctx = torch.where(live, positions + 1, 1).to(torch.int32)
        sin, cos = attn_mod.rope_at(positions, hd, cfg.rope_theta)
        slots = (block_tables[torch.arange(b, device=self.device),
                              (positions // bs).long()].long() * bs
                 + positions % bs)
        slots = torch.where(live, slots, self.num_blocks * bs)
        for i, lp in enumerate(self._layers):
            q, k, v = _layer_qkv(lp, x, sin, cos, cfg)
            kp, vp = pool[i, 0], pool[i, 1]
            kp.view(-1, n_kv, hd).index_copy_(0, slots, k)
            vp.view(-1, n_kv, hd).index_copy_(0, slots, v)
            o = kops.paged_attention(q.reshape(b, n_kv, g, hd), kp, vp,
                                     block_tables, ctx, backend=self.backend)
            x = _layer_finish(x, o.reshape(b, cfg.num_heads * hd), lp, cfg,
                              self._reduce)
        x = rms_norm(x, self.params["final_norm"], cfg.norm_eps)
        return lm_logits(self.params, x, cfg)

    def clone(self) -> "PagedModelRunner":
        """A new runner over the same model and params (shared, not
        copied) with a fresh zeroed pool of its own.  The step-shape
        signatures are shared, as the reference's clones share their
        compiled step functions.  A sharded runner clones on every rank
        of its slice: each shard shares its params and owns a fresh
        pool."""
        c = object.__new__(PagedModelRunner)
        c.model, c.cfg, c.params = self.model, self.cfg, self.params
        c.device, c._layers = self.device, self._layers
        c.block_size, c.num_blocks = self.block_size, self.num_blocks
        c.max_batch, c.backend = self.max_batch, self.backend
        c.ragged_backend = self.ragged_backend
        c.donate_pool = self.donate_pool
        c.mesh, c.tp, c._lcfg = self.mesh, self.tp, self._lcfg
        c._reduce, c._holds_shard = self._reduce, self._holds_shard
        c._posts, c._next_rid = self._posts, self._next_rid
        c._rid = self._next_rid[0]
        self._next_rid[0] += 1
        self._post(Op.CLONE, c._rid)
        c._shape_keys = self._shape_keys
        c._pool_buf = c.pool = None
        if c._holds_shard:
            c._new_pool()
        c.metrics = MetricsRegistry()
        c.n_dispatches = 0
        c.tracer, c.instance_id = self.tracer, self.instance_id
        return c

    def shutdown(self) -> None:
        """Driver: end the loops of the slice's followers (they serve
        this runner and every clone of it).  No-op without followers."""
        self._post(Op.SHUTDOWN)

    def _serve(self, op: Op, words: List[int],
               payload: Optional[torch.Tensor]) -> None:
        """Follower: run one posted step on this rank's shard."""
        if op == Op.FUSED:
            self._fused(payload, _shapes_of(words))
        elif op == Op.PREFILL:
            self._prefill(payload, words[0])
        elif op == Op.SUFFIX:
            self._suffix(payload, words[0], words[1])
        elif op == Op.DECODE:
            self._decode(payload, words[0], words[1])
        elif op == Op.COPY:
            self._copy(words[0], words[1])
        elif op == Op.READ:
            self._read(payload)
        elif op == Op.WRITE:
            lcfg = self._lcfg
            src = self.mesh.recv(
                (lcfg.num_layers, 2, len(payload), self.block_size,
                 lcfg.num_kv_heads, lcfg.resolved_head_dim),
                torch.int16 if words[0] else torch.float32, DRIVER)
            self._write(src, payload)
        elif op == Op.ADDRESS:
            self._address()
        else:
            raise ValueError(f"follower: unexpected {op!r}")

    @classmethod
    def from_config(cls, model: LanguageModel, params: dict, config,
                    backend: Optional[str] = None,
                    device=None, mesh: Optional[MeshSlice] = None
                    ) -> "PagedModelRunner":
        """Build a runner from a :class:`~repro_torch.serving.config.
        ServingConfig` (the device and the mesh slice, being placement
        rather than configuration, are supplied separately)."""
        return cls(model, params, backend=backend, device=device, mesh=mesh,
                   **config.runner_kwargs())

    # -- fused ragged iteration: one step per engine iteration ----------------
    def run_iteration(self, batch: IterationBatch) -> torch.Tensor:
        """Execute a whole :class:`IterationBatch` — every prefill chunk,
        every decode token, and the plan's copy-on-write block copies — as
        one fused step, returning next-token argmax ids (S,) for every
        segment row as a device tensor.  On the card the call only
        enqueues work: the batch metadata goes over in one non-blocking
        copy from pinned memory, nothing here waits on the device, and
        the caller syncs (one transfer) when it consumes the tokens.  A
        sharded runner first posts the batch's one flat int32 buffer to
        its followers.  Traced, the call is two spans: ``runner.upload``
        up to the device copy's enqueue, ``runner.launch`` the step."""
        tr = self.tracer
        sp = tr.begin("runner.upload", self.instance_id) if tr.enabled else None
        self.n_dispatches += 1
        arrays = [np.asarray(getattr(batch, f), np.int32)
                  for f in _BATCH_FIELDS]
        shapes = [a.shape for a in arrays]
        self._called("fused", *shapes)
        flat = torch.from_numpy(np.concatenate([a.ravel() for a in arrays]))
        self._post(Op.FUSED, *_shape_words(shapes), payload=flat)
        return self._fused(flat, shapes, sp)

    def _fused(self, flat: torch.Tensor, shapes, sp=None):
        """Upload and step; ``sp``, an open ``runner.upload`` span, ends at
        the upload, and ``runner.launch`` times the step."""
        out = None
        try:
            if self._holds_shard:
                args = self._upload(flat, shapes)
                if sp is not None:
                    self.tracer.end(sp)
                    sp = self.tracer.begin("runner.launch", self.instance_id)
                out = self._step(*args)
        finally:
            if sp is not None:
                self.tracer.end(sp)
        return self._result(out, shapes[_SAMPLE_ROWS], torch.int32)

    def _upload(self, flat: torch.Tensor, shapes) -> List[torch.Tensor]:
        """The batch's int32 arrays as device tensors, via ONE host-to-
        device copy of their concatenation ``flat``."""
        if self.device.type == "cuda":
            # pinned staging makes the copy truly asynchronous; the
            # caching host allocator keeps the buffer alive until the copy
            # has run
            flat = flat.pin_memory().to(self.device, non_blocking=True)
        out, o = [], 0
        for shp in shapes:
            n = int(np.prod(shp))
            out.append(flat[o:o + n].view(shp))
            o += n
        return out

    @torch.no_grad()
    def _step(self, tokens_p, positions_p, tables_p, tokens_d, positions_d,
              tables_d, write_slots, sample_rows, cow_src, cow_dst):
        cfg = self._lcfg
        hd, n_kv = cfg.resolved_head_dim, cfg.num_kv_heads
        g = cfg.num_heads // n_kv
        pool = self._writable_pool()
        # copy-on-write first: decode rows write into the copies.  dst
        # never aliases another pair's src (dsts come off the free list,
        # srcs are shared), and index_select materializes every source
        # before any write, so one vectorized copy is exact; padding
        # pairs copy block 0 into the spare block
        if cow_dst.numel():
            pool.index_copy_(2, cow_dst.long(), pool.index_select(2, cow_src))
        sp, lmax = tokens_p.shape
        tp = sp * lmax
        tokens = torch.cat([tokens_p.reshape(-1), tokens_d])
        positions = torch.cat([positions_p.reshape(-1), positions_d])
        x = embed_tokens(self.params, tokens).to(self.model.dtype)   # (T, d)
        sin, cos = attn_mod.rope_at(positions, hd, cfg.rope_theta)
        slots = write_slots.long()
        context_d = positions_d + 1
        for i, lp in enumerate(self._layers):
            q, k, v = _layer_qkv(lp, x, sin, cos, cfg)
            kp, vp = pool[i, 0], pool[i, 1]
            # scatter every fresh K/V into its pool slot BEFORE attending:
            # a token then reads earlier same-iteration tokens (its own
            # chunk's prefix, or another chunk that shares its
            # cached-prefix blocks) straight from the pool
            kp.view(-1, n_kv, hd).index_copy_(0, slots, k)
            vp.view(-1, n_kv, hd).index_copy_(0, slots, v)
            qg = q.reshape(-1, n_kv, g, hd)
            # chunk rows attend as dense (Sp, L) tiles through their
            # short per-chunk tables; decode rows through their full
            # tables via the paged decode kernel
            op = kops.ragged_segment_attention(
                qg[:tp].reshape(sp, lmax, n_kv, g, hd), kp, vp, tables_p,
                positions_p, backend=self.ragged_backend)
            od = kops.paged_attention(qg[tp:], kp, vp, tables_d, context_d,
                                      backend=self.backend)
            o = torch.cat([op.reshape(tp, n_kv, g, hd), od])
            x = _layer_finish(x, o.reshape(-1, cfg.num_heads * hd), lp, cfg,
                              self._reduce)
        x = rms_norm(x, self.params["final_norm"], cfg.norm_eps)
        logits = lm_logits(self.params, x[sample_rows.long()], cfg)  # (S, V)
        return torch.argmax(logits, dim=-1).to(torch.int32)


def serve_follower(runner: PagedModelRunner) -> dict:
    """A follower rank's loop: run every step the driver posts to
    ``runner``'s slice — on ``runner`` or on a clone of it, made here when
    the driver clones — until the driver's :meth:`PagedModelRunner.
    shutdown`.  Returns the runners served, by id (0 is ``runner``)."""
    mesh = runner.mesh
    if mesh is None or mesh.is_driver or not mesh.is_member:
        raise ValueError("serve_follower runs on a follower rank of a "
                         "mesh slice")
    runners = {runner._rid: runner}
    while True:
        op, words, payload = mesh.receive()
        if op == Op.SHUTDOWN:
            return runners
        r = runners[words[0]]
        if op == Op.CLONE:
            c = r.clone()
            if c._rid != words[1]:
                raise RuntimeError(f"clone {c._rid} here, {words[1]} on the "
                                   "driver")
            runners[c._rid] = c
        else:
            r._serve(op, words[1:], payload)


# =============================================================================
# Deferred host sync: lazy next-token references
# =============================================================================


class TokenBuffer:
    """The next-token ids of one fused step, synced to host lazily.

    ``run_iteration`` returns a device tensor whose compute may still be
    in flight.  The wait for the producing step happens only when a token
    value is actually consumed (:meth:`host`): fed into a later
    iteration's flatten, checked against ``eos_token``, or materialized
    at request finish.  On the card the copy to host is enqueued when the
    buffer is made, at the end of the step's dispatch: a non-blocking
    copy into pinned host memory on the launching stream, with an event
    behind it, so :meth:`host` waits for this step alone and not for work
    launched after it on the same stream (another engine's step).  Off
    the card :meth:`host` copies (``.cpu()``) on first access.  The held
    tensor is the step's fresh argmax output, never a view of the pool,
    so a deferred read is safe however many later iterations have
    updated the pool."""

    __slots__ = ("_src", "_host", "_copied")

    def __init__(self, dev: torch.Tensor):
        self._host: Optional[np.ndarray] = None
        self._copied = None
        if dev.is_cuda:
            stream = torch.cuda.current_stream(dev.device)
            pinned = torch.empty(dev.shape, dtype=dev.dtype, pin_memory=True)
            pinned.copy_(dev, non_blocking=True)
            self._copied = torch.cuda.Event()
            self._copied.record(stream)
            dev = pinned
        self._src = dev

    def host(self) -> np.ndarray:
        if self._host is None:
            src = self._src               # local ref: a concurrent host()
            if src is not None:           # call can never hand us None
                if self._copied is not None:
                    self._copied.synchronize()
                self._host = src.cpu().numpy()
                self._src = None          # release the buffer early
        return self._host


class TokenRef:
    """One row of a :class:`TokenBuffer`: a not-yet-synced token id.

    Converts to ``int`` on demand (``__int__``/``__index__``), so host
    code that stores pending tokens — the engine's next-token map, a
    request's ``output_tokens`` while it is still running — never blocks
    on the device until the value is observed.  Comparison syncs too:
    equality against a plain int is value equality."""

    __slots__ = ("buf", "row")

    def __init__(self, buf: TokenBuffer, row: int):
        self.buf = buf
        self.row = row

    def __int__(self) -> int:
        return int(self.buf.host()[self.row])

    __index__ = __int__

    def __eq__(self, other) -> bool:
        try:
            return int(self) == int(other)
        except (TypeError, ValueError):
            return NotImplemented

    def __hash__(self) -> int:
        return hash(int(self))

    def __repr__(self) -> str:
        return f"TokenRef({int(self)})"


# =============================================================================
# Continuous-batching engine
# =============================================================================


class LLMEngine:
    """One LLM instance: a :class:`BatchScheduler` drives the runner.

    All scheduling decisions — admission order (``policy``, default
    FCFS), prefix-cache matching, block accounting, growth / eviction /
    preemption, and chunked-prefill batch composition
    (``prefill_chunk_tokens``: per-iteration prefill token budget,
    ``None`` = monolithic) — live in
    :class:`repro_torch.serving.batch_scheduler.BatchScheduler`; this
    class only executes the plans with real tokens.

    Execution model (``fused_iteration``, default on): each composed
    :class:`IterationPlan` is flattened into one ragged
    :class:`IterationBatch` and executed by a single fused step
    (:meth:`PagedModelRunner.run_iteration`) returning every segment's
    next token in one transfer.  A request finishing its prefill starts
    decoding the *next* iteration (its first token is this step's
    argmax), so generated tokens are identical to the legacy per-chunk
    path — kept behind ``fused_iteration=False`` for differential
    testing — which issues one step per prefill chunk plus a padded
    decode step, with a blocking argmax sync after every completed chunk
    and after the decode step."""

    def __init__(self, runner: PagedModelRunner, instance_id: int = 0,
                 max_batch: int = 8, eos_token: int = -1,
                 clock: Callable[[], float] = time.monotonic,
                 enable_prefix_cache: bool = False,
                 policy: Optional[SchedulerPolicy] = None,
                 prefill_chunk_tokens: Optional[int] = None,
                 fused_iteration: bool = True,
                 tracer: Tracer = NULL_TRACER,
                 role: str = "general"):
        self.runner = runner
        self.fused_iteration = fused_iteration
        self._pending: Optional[Tuple[IterationBatch, TokenBuffer]] = None
        self._pending_finished: Optional[List[Request]] = None
        self.bm = BlockManager(runner.num_blocks, runner.block_size)
        self.prefix_cache = (PrefixCache(runner.block_size)
                             if enable_prefix_cache else None)
        self.instance_id = instance_id
        self.max_batch = max_batch
        self.eos_token = eos_token
        self.clock = clock
        self.tracer = tracer
        runner.tracer, runner.instance_id = tracer, instance_id
        # iterations issued; the last one's number is n_iterations - 1
        self.n_iterations = 0
        self._next_tok: dict[int, int] = {}
        # fault plane (serving/faults.py): wired by the cluster; when set,
        # every composed iteration consults the injector mid-dispatch
        self.faults = None
        # wall seconds of the last dispatch plus its own wait in sync,
        # written by the cluster step — recovery's step-deadline check
        # reads it post-collect
        self.last_step_wall = 0.0
        self.sched = BatchScheduler(
            self.bm, policy=policy, prefix_cache=self.prefix_cache,
            matcher=TokenPrefixMatcher(), max_running=max_batch,
            max_batch=runner.max_batch,
            prefill_chunk_tokens=prefill_chunk_tokens,
            # bound to the token map, not to the engine: no reference
            # cycle, so a discarded engine (and its pool) is freed as soon
            # as the last reference to it goes, without the collector
            on_preempt=lambda r, toks=self._next_tok: toks.pop(r.req_id,
                                                                 None),
            tracer=tracer, instance_id=instance_id, role=role)

    @classmethod
    def from_config(cls, runner: PagedModelRunner, config, *,
                    instance_id: int = 0, eos_token: int = -1,
                    clock: Callable[[], float] = time.monotonic,
                    policy: Optional[SchedulerPolicy] = None,
                    tracer: Tracer = NULL_TRACER,
                    role: Optional[str] = None) -> "LLMEngine":
        """Build an engine from a :class:`~repro_torch.serving.config.
        ServingConfig` (identity, clock, policy object and tracer are
        runtime wiring, not configuration).  ``role`` overrides
        ``config.role_of(instance_id)``."""
        if role is None:
            role = config.role_of(instance_id)
        return cls(runner, instance_id=instance_id, eos_token=eos_token,
                   clock=clock, policy=policy, tracer=tracer, role=role,
                   **config.engine_kwargs())

    @property
    def role(self) -> str:
        return self.sched.role

    @property
    def waiting(self) -> List[Request]:
        return self.sched.waiting

    @property
    def running(self) -> List[Request]:
        return self.sched.running

    # ------------------------------------------------- pending-token surface
    # (live migration moves a mid-decode request's sampled-but-not-yet-fed
    # token between engines; these keep it off _next_tok)
    def pending_token(self, req_id: int) -> Optional[int]:
        """The request's sampled-but-not-yet-fed next token, materialized
        to a plain int (syncs a deferred :class:`TokenRef`), or None for a
        request still mid-prefill."""
        tok = self._next_tok.get(req_id)
        return None if tok is None else int(tok)

    def set_pending_token(self, req_id: int, tok: int):
        self._next_tok[req_id] = int(tok)

    def drop_pending_token(self, req_id: int):
        self._next_tok.pop(req_id, None)

    @property
    def stats(self) -> SchedStats:
        return self.sched.stats

    # ---------------------------------------------------------------- monitor
    @property
    def kv_capacity_tokens(self) -> int:
        return self.bm.num_blocks * self.bm.block_size

    @property
    def kv_used_tokens(self) -> int:
        return sum(r.total_len for r in self.running)

    @property
    def kv_cached_tokens(self) -> int:
        """Tokens parked in zero-ref prefix-cache blocks (reclaimable)."""
        return self.bm.cached_blocks * self.bm.block_size

    def memory_free_fraction(self) -> float:
        return self.bm.free_blocks / self.bm.num_blocks

    def poll_oom(self) -> bool:
        oom, self.stats.recent_oom = self.stats.recent_oom, False
        return oom

    def metrics_snapshot(self) -> dict:
        """One flat dict of this instance's counters and gauges: the
        runner's registry (dispatches, pool bytes, iteration histograms)
        plus scheduler occupancy and prefix-cache stats."""
        m = self.runner.metrics
        m.set("queue_depth", len(self.waiting))
        m.set("running", len(self.running))
        m.set("kv_used_tokens", self.kv_used_tokens)
        m.set("kv_cached_tokens", self.kv_cached_tokens)
        m.set("n_finished", self.stats.n_finished)
        m.set("n_preempted", self.stats.n_preempted)
        m.set("n_admitted", self.stats.n_admitted)
        m.set("prefill_tokens", self.stats.prefill_tokens)
        m.set("prefill_tokens_saved", self.stats.prefill_tokens_saved)
        if self.prefix_cache is not None:
            m.set("prefix_cache_hit_rate", self.prefix_cache.stats.hit_rate())
        return self.runner.metrics_snapshot()

    # ---------------------------------------------------------------- intake
    def submit(self, req: Request):
        req.instance_id = self.instance_id
        self.sched.submit(req)

    # ---------------------------------------------------------------- stepping
    def step(self) -> List[Request]:
        """One continuous-batching iteration; returns finished requests.
        Dispatch + collect back-to-back, with the host sync forced."""
        self.dispatch_iteration()
        return self.collect(force_sync=True)

    @property
    def has_pending(self) -> bool:
        """A dispatched-but-not-collected iteration is in flight."""
        return self._pending is not None or self._pending_finished is not None

    def dispatch_iteration(self) -> bool:
        """Compose this engine's next iteration and issue its fused step
        WITHOUT waiting for the result: the next-token ids stay on device
        until :meth:`collect` — or a later consumer — needs them.  Returns
        True iff an iteration was issued.  On the legacy per-chunk path
        there is no single step to defer; the iteration executes
        synchronously here and ``collect`` just hands back its
        finishers.  Traced, the call is an ``engine.dispatch`` span around
        ``sched.plan``, ``engine.flatten`` and the runner's spans."""
        assert not self.has_pending, "collect() the previous iteration first"
        tr = self.tracer
        sp = tr.begin("engine.dispatch", self.instance_id) if tr.enabled else None
        try:
            if sp is not None:
                psp = tr.begin("sched.plan", self.instance_id)
            plan = self.sched.plan(self.clock())
            if sp is not None:
                sp.iteration = -1 if plan is None else self.n_iterations
                tr.end(psp, iteration=sp.iteration)
            if plan is None:
                return False
            self.n_iterations += 1
            if self.faults is not None:
                # mid-dispatch fault point: the plan has already mutated
                # scheduler state (chunk bookkeeping, decode growth), which is
                # exactly what a real worker death leaves behind.  Non-crash
                # effects land first so a storm of ooms still fences.
                eff = self.faults.on_dispatch(self.instance_id)
                if eff.oom:
                    self.sched.stats.recent_oom = True
                if eff.delay_s > 0.0:
                    time.sleep(eff.delay_s)
                if eff.crash is not None:
                    raise InstanceCrashed(self.instance_id, eff.crash.step)
            if not self.fused_iteration:
                self._pending_finished = self._execute_per_chunk(plan)
                return True
            if sp is not None:
                fsp = tr.begin("engine.flatten", self.instance_id)
            batch = flatten_plan(plan, self.bm, self._next_tok)
            if sp is not None:
                tr.end(fsp)
            self.runner.metrics.observe("iteration_tokens", batch.n_tokens)
            self._pending = (batch, TokenBuffer(self.runner.run_iteration(batch)))
            return True
        finally:
            if sp is not None:
                tr.end(sp)

    def sync(self):
        """Block until the in-flight iteration's next-token ids are
        host-resident (no-op when nothing is pending)."""
        if self._pending is not None:
            tr = self.tracer
            sp = (tr.begin("engine.sync", self.instance_id) if tr.enabled
                  else None)
            try:
                self._pending[1].host()
            finally:
                if sp is not None:
                    tr.end(sp, iteration=self.n_iterations - 1)

    def collect(self, force_sync: bool = False) -> List[Request]:
        """Book the dispatched iteration's results; returns finished
        requests.  All bookkeeping is host-side metadata: new tokens are
        recorded as :class:`TokenRef`s, so nothing blocks on the device
        unless a request finished (its output materializes), EOS checking
        demands token values, or ``force_sync`` asks for it.  Traced, a
        collect that books an iteration is an ``engine.collect`` span."""
        if self._pending_finished is not None:
            finished, self._pending_finished = self._pending_finished, None
            return finished
        if self._pending is None:
            return []
        tr = self.tracer
        sp = tr.begin("engine.collect", self.instance_id) if tr.enabled else None
        try:
            (batch, toks), self._pending = self._pending, None
            if force_sync or self.eos_token >= 0:
                toks.host()
            finished = []
            now = self.clock()
            traced = tr.enabled
            for j, seg in enumerate(batch.segments):
                r = seg.req
                if seg.kind == "prefill":
                    if seg.emits_token:
                        self._next_tok[r.req_id] = TokenRef(toks, j)
                        # the final chunk's argmax IS the first generated
                        # token — TTFT is timed at its collection
                        if r.first_token_time < 0:
                            r.first_token_time = now
                        if traced:
                            self.tracer.emit("first-token", req_id=r.req_id,
                                             instance_id=self.instance_id,
                                             agent=r.agent_name,
                                             msg_id=r.msg_id, ts=now)
                    continue
                fed = self._next_tok[r.req_id]
                r.output_tokens.append(fed)
                r.output_len += 1
                self._next_tok[r.req_id] = TokenRef(toks, j)
                if traced:
                    self.tracer.emit("decode", req_id=r.req_id,
                                     instance_id=self.instance_id,
                                     agent=r.agent_name, msg_id=r.msg_id, ts=now)
                done = (r.output_len >= r.max_new_tokens
                        or (self.eos_token >= 0
                            and int(toks.host()[j]) == self.eos_token))
                if done:
                    r.output_tokens[:] = [int(t) for t in r.output_tokens]
                    self.sched.finish(r, self.clock())
                    self._next_tok.pop(r.req_id, None)
                    finished.append(r)
            return finished
        finally:
            if sp is not None:
                tr.end(sp, iteration=self.n_iterations - 1)

    def _execute_per_chunk(self, plan) -> List[Request]:
        """Legacy differential-testing path: one step per prefill chunk
        (plus a blocking argmax sync for each completed prompt) and a
        separate padded decode step."""
        runner = self.runner
        # prefill chunks, in plan order: a chunk may attend shared blocks
        # written by an earlier chunk of this very iteration
        for c in plan.chunks:
            toks = torch.as_tensor(
                np.asarray(c.req.prompt_tokens, np.int32)[c.start:c.end])
            table = self.bm.block_table(c.req.req_id)
            if c.start == 0 and c.is_last:
                logits = runner.prefill(toks, table)
            else:
                logits = runner.prefill_suffix(toks, table, c.start)
            if c.is_last:
                # the argmax is its own step, and int() blocks on it — one
                # round-trip per completed prompt (the fused path folds
                # every argmax into its one step and one transfer)
                runner.n_dispatches += 1
                self._next_tok[c.req.req_id] = int(torch.argmax(logits))
                if c.req.first_token_time < 0:
                    c.req.first_token_time = self.clock()
                if self.tracer.enabled:
                    self.tracer.emit("first-token", req_id=c.req.req_id,
                                     instance_id=self.instance_id,
                                     agent=c.req.agent_name,
                                     msg_id=c.req.msg_id,
                                     ts=c.req.first_token_time)
        for src, dst in plan.cow:
            runner.copy_block(src, dst)
        if not plan.decode:
            return []
        b = runner.max_batch
        batch = plan.decode
        nbmax = max(len(self.bm.block_table(r.req_id)) + 1 for r in batch)
        tokens = np.zeros((b,), np.int32)
        positions = np.zeros((b,), np.int32)
        tables = np.zeros((b, nbmax), np.int32)
        live = np.zeros((b,), bool)
        for i, r in enumerate(batch):
            t = self.bm.block_table(r.req_id)
            tables[i, :len(t)] = t
            tokens[i] = self._next_tok[r.req_id]
            positions[i] = r.total_len
            live[i] = True
        logits = runner.decode_batch(tokens, positions, tables, live)
        runner.n_dispatches += 1
        nxt = torch.argmax(logits, -1).cpu().numpy()
        finished = []
        for i, r in enumerate(batch):
            r.output_tokens.append(int(tokens[i]))
            r.output_len += 1
            self._next_tok[r.req_id] = int(nxt[i])
            done = (r.output_len >= r.max_new_tokens
                    or (self.eos_token >= 0 and int(nxt[i]) == self.eos_token))
            if done:
                self.sched.finish(r, self.clock())
                self._next_tok.pop(r.req_id, None)
                finished.append(r)
        return finished

    def run_until_drained(self, max_steps: int = 10_000) -> List[Request]:
        out = []
        for _ in range(max_steps):
            out.extend(self.step())
            if not self.running and not self.waiting:
                break
        return out
