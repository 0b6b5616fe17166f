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
from repro_torch.models.model import LanguageModel
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


# =============================================================================
# Paged model runner (uniform-attention architectures)
# =============================================================================


def _layer_qkv(lp, x, sin, cos, cfg):
    """Transformer-layer head: pre-norm, QKV projection with qk-norm, RoPE
    on q/k."""
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    q, k, v = attn_mod._project_qkv(lp["attn"], h, h, cfg)
    return attn_mod.apply_rope(q, sin, cos), attn_mod.apply_rope(k, sin, cos), v


def _layer_finish(x, o, lp, cfg):
    """Transformer-layer tail: attention output projection and the FFN,
    both residual.  ``o`` is (T, H*hd)."""
    x = x + o @ lp["attn"]["wo"]
    h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + swiglu(h2, **lp["ffn"])


# IterationBatch arrays uploaded to the device, in order
_BATCH_FIELDS = ("tokens_p", "positions_p", "tables_p", "tokens_d",
                 "positions_d", "tables_d", "write_slots", "sample_rows",
                 "cow_src", "cow_dst")


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
    """

    # the step functions whose input-shape signatures jit_cache_size counts
    _STEP_FNS = ("fused", "decode", "prefill", "scatter", "suffix", "copy",
                 "write_blocks")

    def __init__(self, model: LanguageModel, params: dict, num_blocks: int,
                 block_size: int, max_batch: int = 8,
                 backend: Optional[str] = None,
                 ragged_backend: Optional[str] = None,
                 donate_pool: bool = True,
                 device=None):
        cfg = model.cfg
        assert model.uniform_kind == "attn", "paged runner serves attention archs"
        assert cfg.sliding_window is None, "windowed paged decode is not ported"
        self.device = resolve_device(device)
        if params["embed"].device != self.device:
            raise ValueError(f"params live on {params['embed'].device}, "
                             f"the runner on {self.device}")
        self.model, self.cfg, self.params = model, cfg, params
        self.block_size, self.num_blocks = block_size, num_blocks
        self.max_batch = max_batch
        self.donate_pool = donate_pool
        self.backend = backend or kops.default_backend(self.device)
        self.ragged_backend = ragged_backend or self.backend
        if self.backend not in kops.PAGED_BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}")
        if self.ragged_backend not in kops.RAGGED_BACKENDS:
            raise ValueError(f"unknown ragged backend {self.ragged_backend!r}")
        self._layers = [layer_slice(params["layers"], i)
                        for i in range(cfg.num_layers)]
        self._new_pool()
        self._shape_keys = {f: set() for f in self._STEP_FNS}
        # perf counters live on a metrics registry (obs.metrics);
        # n_dispatches counts the steps issued: one per fused iteration;
        # on the legacy path each prefill (2), suffix chunk, copy, decode
        # step and argmax; one per read_blocks / write_blocks
        self.metrics = MetricsRegistry()
        self.n_dispatches = 0

    def _new_pool(self) -> None:
        """Fresh zeroed pool, with the spare padding block (see class
        docstring)."""
        cfg = self.cfg
        self._set_pool(torch.zeros(
            (cfg.num_layers, 2, self.num_blocks + 1, self.block_size,
             cfg.num_kv_heads, cfg.resolved_head_dim),
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

    @property
    def n_dispatches(self) -> int:
        """Alias over ``metrics.counter("n_dispatches")``."""
        return int(self.metrics.counter("n_dispatches").value)

    @n_dispatches.setter
    def n_dispatches(self, v: int):
        self.metrics.counter("n_dispatches").value = float(v)

    def metrics_snapshot(self) -> dict:
        """Registry snapshot with the derived gauges refreshed (step-shape
        signatures seen, resident pool bytes)."""
        self.metrics.set("jit_cache_size", self.jit_cache_size())
        self.metrics.set("pool_bytes", self._pool_buf.numel()
                         * self._pool_buf.element_size())
        return self.metrics.snapshot()

    def pool_address(self) -> int:
        """Device address of the pool (``data_ptr()``): stable for the
        runner's lifetime, since every update is in place — unless
        ``donate_pool=False``, where every pool-writing step moves it.
        Call between synced iterations only."""
        return self._pool_buf.data_ptr()

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
        them back as such).  The pool is only *read*: ``pool_address()``
        is unchanged.  Must run between synced iterations."""
        self.n_dispatches += 1
        idx = torch.as_tensor(np.asarray(block_ids, np.int64),
                              device=self.device)
        kv = self.pool.index_select(2, idx)
        if kv.dtype == torch.bfloat16:
            return kv.view(torch.int16).cpu().numpy().view(np.uint16)
        return kv.cpu().numpy()

    def write_blocks(self, kv: np.ndarray, block_ids: Sequence[int]):
        """Scatter transferred KV into ``block_ids``, in place — the
        restore half of a live migration; ``kv`` is what ``read_blocks``
        returns (``uint16`` raw bits for a bfloat16 pool).  One step: the
        host-to-device copy and one ``index_copy_`` through the pool
        view, so ``pool_address()`` is unchanged (under
        ``donate_pool=True``)."""
        assert kv.shape[2] == len(block_ids)
        self.n_dispatches += 1
        self._called("write_blocks", len(block_ids))
        kv = np.ascontiguousarray(kv)
        if kv.dtype in (np.uint16, np.int16):
            if self.model.dtype != torch.bfloat16:
                raise TypeError("raw 16-bit KV needs a bfloat16 pool")
            src = torch.from_numpy(kv.view(np.int16)).view(torch.bfloat16)
        else:
            src = torch.from_numpy(kv)
        src = src.to(self.device, self.model.dtype)
        idx = torch.as_tensor(np.asarray(block_ids, np.int64),
                              device=self.device)
        self._writable_pool().index_copy_(2, idx, src)

    # -- legacy per-chunk path -------------------------------------------------
    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, block_table: List[int]):
        """tokens (S,) int32 -> last-token logits (V,).  Fills the pool.

        Two steps: the model's dense prefill, then the scatter of its
        contiguous KV into the prompt's pages."""
        tokens = torch.as_tensor(tokens, device=self.device)
        s, bs = int(tokens.shape[0]), self.block_size
        nb = -(-s // bs)
        self.n_dispatches += 2
        self._called("prefill", s)
        self._called("scatter", s, nb)
        logits, cache = self.model.prefill(self.params, tokens[None])
        kv = cache["kv"][:, :, 0]                         # (L, 2, S, KV, hd)
        kv = torch.nn.functional.pad(kv, (0, 0, 0, 0, 0, nb * bs - s))
        kv = kv.reshape(kv.shape[0], 2, nb, bs, *kv.shape[3:])
        bt = torch.as_tensor(block_table[:nb], dtype=torch.long,
                             device=self.device)
        self._writable_pool().index_copy_(2, bt, kv)
        return logits[0]

    @torch.no_grad()
    def prefill_suffix(self, tokens: torch.Tensor, block_table: List[int],
                       n_cached: int):
        """tokens (S,) = the next prompt chunk; block_table covers the
        whole prompt.  The chunk attends densely over the ``n_cached``
        tokens already resident in the pool (a shared cached prefix
        and/or earlier chunks of this prompt) plus itself; only the
        chunk's KV is written, at its exact token slots, so chunk
        boundaries need not align to blocks.  Returns the chunk's
        last-token logits (V,)."""
        cfg = self.cfg
        hd, n_kv, bs = cfg.resolved_head_dim, cfg.num_kv_heads, self.block_size
        tokens = torch.as_tensor(tokens, device=self.device)
        s = int(tokens.shape[0])
        assert s > 0 and 0 <= n_cached
        n_ctx_blocks = -(-n_cached // bs)
        self.n_dispatches += 1
        self._called("suffix", s, n_ctx_blocks, n_cached)
        ctx_bt = torch.as_tensor(block_table[:n_ctx_blocks],
                                 dtype=torch.long, device=self.device)
        write_idx = torch.as_tensor(
            [block_table[p // bs] * bs + p % bs
             for p in range(n_cached, n_cached + s)],
            dtype=torch.long, device=self.device)
        positions = n_cached + torch.arange(s, device=self.device)
        sin, cos = attn_mod.rope_at(positions, hd, cfg.rope_theta)
        k_pos = torch.arange(n_cached + s, device=self.device)
        bias = attn_mod._mask_bias(positions, k_pos)
        x = embed_tokens(self.params, tokens[None]).to(self.model.dtype)
        pool = self._writable_pool()
        for i, lp in enumerate(self._layers):
            q, k, v = _layer_qkv(lp, x, sin, cos, cfg)    # (1, S, ., hd)
            # resident K/V: the covering pages (roped at write), first
            # n_cached rows — the last page may be partially filled
            pk = pool[i, 0][ctx_bt].reshape(-1, n_kv, hd)[:n_cached]
            pv = pool[i, 1][ctx_bt].reshape(-1, n_kv, hd)[:n_cached]
            kf = torch.cat([pk[None], k], dim=1)           # (1, P+S, KV, hd)
            vf = torch.cat([pv[None], v], dim=1)
            probs = torch.softmax(attn_mod._gqa_scores(q, kf) + bias, dim=-1)
            o = attn_mod._gqa_out(probs, vf).reshape(1, s, -1)
            pool[i, 0].view(-1, n_kv, hd).index_copy_(0, write_idx, k[0])
            pool[i, 1].view(-1, n_kv, hd).index_copy_(0, write_idx, v[0])
            x = _layer_finish(x, o, lp, cfg)
        x = rms_norm(x, self.params["final_norm"], cfg.norm_eps)
        return lm_logits(self.params, x[:, -1], cfg)[0]

    def copy_block(self, src: int, dst: int):
        """Copy-on-write data path: duplicate one physical block, in
        place (one step)."""
        self.n_dispatches += 1
        self._called("copy")
        pool = self._writable_pool()
        pool[:, :, dst] = pool[:, :, src]

    @torch.no_grad()
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
        flat = torch.from_numpy(np.concatenate(arrays)).to(self.device)
        tokens_t, positions_t = flat[:b], flat[b:2 * b]
        tables = flat[2 * b:2 * b + b * nbmax].view(b, nbmax)
        live_t = flat[2 * b + b * nbmax:].bool()
        return self._decode_step(tokens_t, positions_t, tables, live_t)

    def _decode_step(self, tokens, positions, block_tables, live):
        cfg = self.cfg
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
            x = _layer_finish(x, o.reshape(b, cfg.num_heads * hd), lp, cfg)
        x = rms_norm(x, self.params["final_norm"], cfg.norm_eps)
        return lm_logits(self.params, x, cfg)

    def clone(self) -> "PagedModelRunner":
        """A new runner over the same model and params (shared, not
        copied) with a fresh zeroed pool of its own.  The step-shape
        signatures are shared, as the reference's clones share their
        compiled step functions."""
        c = object.__new__(PagedModelRunner)
        c.model, c.cfg, c.params = self.model, self.cfg, self.params
        c.device, c._layers = self.device, self._layers
        c.block_size, c.num_blocks = self.block_size, self.num_blocks
        c.max_batch, c.backend = self.max_batch, self.backend
        c.ragged_backend = self.ragged_backend
        c.donate_pool = self.donate_pool
        c._shape_keys = self._shape_keys
        c._new_pool()
        c.metrics = MetricsRegistry()
        c.n_dispatches = 0
        return c

    @classmethod
    def from_config(cls, model: LanguageModel, params: dict, config,
                    backend: Optional[str] = None,
                    device=None) -> "PagedModelRunner":
        """Build a runner from a :class:`~repro_torch.serving.config.
        ServingConfig` (the device, being placement rather than
        configuration, is supplied separately)."""
        return cls(model, params, backend=backend, device=device,
                   **config.runner_kwargs())

    # -- fused ragged iteration: one step per engine iteration ----------------
    def run_iteration(self, batch: IterationBatch) -> torch.Tensor:
        """Execute a whole :class:`IterationBatch` — every prefill chunk,
        every decode token, and the plan's copy-on-write block copies — as
        one fused step, returning next-token argmax ids (S,) for every
        segment row as a device tensor.  On the card the call only
        enqueues work: the batch metadata goes over in one non-blocking
        copy from pinned memory, nothing here waits on the device, and
        the caller syncs (one transfer) when it consumes the tokens."""
        self.n_dispatches += 1
        arrays = self._upload(batch)
        self._called("fused", *(tuple(a.shape) for a in arrays))
        return self._step(*arrays)

    def _upload(self, batch: IterationBatch) -> List[torch.Tensor]:
        """The batch's int32 arrays as device tensors, via ONE host-to-
        device copy of their concatenation."""
        arrays = [np.asarray(getattr(batch, f), np.int32)
                  for f in _BATCH_FIELDS]
        flat = torch.from_numpy(np.concatenate([a.ravel() for a in arrays]))
        if self.device.type == "cuda":
            # pinned staging makes the copy truly asynchronous; the
            # caching host allocator keeps the buffer alive until the copy
            # has run
            flat = flat.pin_memory().to(self.device, non_blocking=True)
        out, o = [], 0
        for a in arrays:
            out.append(flat[o:o + a.size].view(a.shape))
            o += a.size
        return out

    @torch.no_grad()
    def _step(self, tokens_p, positions_p, tables_p, tokens_d, positions_d,
              tables_d, write_slots, sample_rows, cow_src, cow_dst):
        cfg = self.cfg
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
            x = _layer_finish(x, o.reshape(-1, cfg.num_heads * hd), lp, cfg)
        x = rms_norm(x, self.params["final_norm"], cfg.norm_eps)
        logits = lm_logits(self.params, x[sample_rows.long()], cfg)  # (S, V)
        return torch.argmax(logits, dim=-1).to(torch.int32)


# =============================================================================
# Deferred host sync: lazy next-token references
# =============================================================================


class TokenBuffer:
    """The next-token ids of one fused step, synced to host lazily.

    ``run_iteration`` returns a device tensor whose compute may still be
    in flight.  The buffer copies it to host (``.cpu()``) exactly once, on
    first access — so the device->host round-trip (and the wait for the
    producing step) happens only when a token value is actually consumed:
    fed into a later iteration's flatten, checked against ``eos_token``,
    or materialized at request finish.  The held tensor is the step's
    fresh argmax output, never a view of the pool, so a deferred read is
    safe however many later iterations have updated the pool."""

    __slots__ = ("_dev", "_host")

    def __init__(self, dev: torch.Tensor):
        self._dev = dev
        self._host: Optional[np.ndarray] = None

    def host(self) -> np.ndarray:
        if self._host is None:
            dev = self._dev               # local ref: a concurrent host()
            if dev is not None:           # call can never hand us None
                self._host = dev.cpu().numpy()
                self._dev = None          # release the device buffer early
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
        self._next_tok: dict[int, int] = {}
        # fault plane (serving/faults.py): wired by the cluster; when set,
        # every composed iteration consults the injector mid-dispatch
        self.faults = None
        # wall seconds of the last dispatch+sync, written by the stepping
        # thread — recovery's step-deadline check reads it post-collect
        self.last_step_wall = 0.0
        self.sched = BatchScheduler(
            self.bm, policy=policy, prefix_cache=self.prefix_cache,
            matcher=TokenPrefixMatcher(), max_running=max_batch,
            max_batch=runner.max_batch,
            prefill_chunk_tokens=prefill_chunk_tokens,
            on_preempt=lambda r: self._next_tok.pop(r.req_id, None),
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
        finishers."""
        assert not self.has_pending, "collect() the previous iteration first"
        plan = self.sched.plan(self.clock())
        if plan is None:
            return False
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
        batch = flatten_plan(plan, self.bm, self._next_tok)
        self.runner.metrics.observe("iteration_tokens", batch.n_tokens)
        self.runner.metrics.observe("batch_occupancy", len(batch.segments))
        self._pending = (batch, TokenBuffer(self.runner.run_iteration(batch)))
        return True

    def sync(self):
        """Block until the in-flight iteration's next-token ids are
        host-resident (no-op when nothing is pending)."""
        if self._pending is not None:
            self._pending[1].host()

    def collect(self, force_sync: bool = False) -> List[Request]:
        """Book the dispatched iteration's results; returns finished
        requests.  All bookkeeping is host-side metadata: new tokens are
        recorded as :class:`TokenRef`s, so nothing blocks on the device
        unless a request finished (its output materializes), EOS checking
        demands token values, or ``force_sync`` asks for it."""
        if self._pending_finished is not None:
            finished, self._pending_finished = self._pending_finished, None
            return finished
        if self._pending is None:
            return []
        (batch, toks), self._pending = self._pending, None
        if force_sync or self.eos_token >= 0:
            toks.host()
        finished = []
        now = self.clock()
        traced = self.tracer.enabled
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

    def _execute_per_chunk(self, plan) -> List[Request]:
        """Legacy differential-testing path: one step per prefill chunk
        (plus a blocking argmax sync for each completed prompt) and a
        separate padded decode step."""
        runner = self.runner
        # prefill chunks, in plan order: a chunk may attend shared blocks
        # written by an earlier chunk of this very iteration
        for c in plan.chunks:
            toks = torch.as_tensor(
                np.asarray(c.req.prompt_tokens, np.int32)[c.start:c.end],
                device=runner.device)
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
