"""LLM engine instance: paged-KV model runner + continuous batching.

``PagedModelRunner`` executes real tokens against the paged KV pool: one
fused step per engine iteration, with the CUDA attention kernels on the
card and their plain PyTorch versions on the CPU.  ``LLMEngine``
implements vLLM-style continuous batching with dynamic memory allocation
and preemption-by-recompute — the behaviours the paper's dispatcher is
designed around (§2.2.3).

Engines expose the *status monitor* surface Kairos polls (§3 overview):
KV memory in use / capacity, running/waiting counts, preemption counter.
"""
from __future__ import annotations

import time
from typing import Callable, List, Optional, Tuple

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

    **In-place pool.**  The pool is one tensor allocated once per runner
    and updated in place by every iteration (``index_copy_`` for the KV
    scatter and the copy-on-write block copies), so ``pool_address()`` —
    its ``data_ptr()`` — is stable for the runner's lifetime and no
    iteration copies the pool.  Its storage holds one spare block per
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
    ``"flat"``/``"flat_ref"``); it defaults to ``backend``.
    """

    def __init__(self, model: LanguageModel, params: dict, num_blocks: int,
                 block_size: int, max_batch: int = 8,
                 backend: Optional[str] = None,
                 ragged_backend: Optional[str] = None,
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
        self.backend = backend or kops.default_backend(self.device)
        self.ragged_backend = ragged_backend or self.backend
        if self.backend not in kops.PAGED_BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}")
        if self.ragged_backend not in kops.RAGGED_BACKENDS:
            raise ValueError(f"unknown ragged backend {self.ragged_backend!r}")
        self._layers = [layer_slice(params["layers"], i)
                        for i in range(cfg.num_layers)]
        self._new_pool()
        # perf counters live on a metrics registry (obs.metrics);
        # n_dispatches counts fused steps issued (one per iteration)
        self.metrics = MetricsRegistry()
        self.n_dispatches = 0

    def _new_pool(self) -> None:
        """Fresh zeroed pool, with the spare padding block (see class
        docstring)."""
        cfg = self.cfg
        self._pool_buf = torch.zeros(
            (cfg.num_layers, 2, self.num_blocks + 1, self.block_size,
             cfg.num_kv_heads, cfg.resolved_head_dim),
            dtype=self.model.dtype, device=self.device)
        self.pool = self._pool_buf[:, :, :self.num_blocks]

    @property
    def n_dispatches(self) -> int:
        """Alias over ``metrics.counter("n_dispatches")``."""
        return int(self.metrics.counter("n_dispatches").value)

    @n_dispatches.setter
    def n_dispatches(self, v: int):
        self.metrics.counter("n_dispatches").value = float(v)

    def metrics_snapshot(self) -> dict:
        """Registry snapshot with the resident pool bytes refreshed."""
        self.metrics.set("pool_bytes", self._pool_buf.numel()
                         * self._pool_buf.element_size())
        return self.metrics.snapshot()

    def pool_address(self) -> int:
        """Device address of the pool (``data_ptr()``): stable for the
        runner's lifetime, since every update is in place."""
        return self._pool_buf.data_ptr()

    def clone(self) -> "PagedModelRunner":
        """A new runner over the same model and params (shared, not
        copied) with a fresh zeroed pool of its own."""
        c = object.__new__(PagedModelRunner)
        c.model, c.cfg, c.params = self.model, self.cfg, self.params
        c.device, c._layers = self.device, self._layers
        c.block_size, c.num_blocks = self.block_size, self.num_blocks
        c.max_batch, c.backend = self.max_batch, self.backend
        c.ragged_backend = self.ragged_backend
        c._new_pool()
        c.metrics = MetricsRegistry()
        c.n_dispatches = 0
        return c

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
        return self._step(*self._upload(batch))

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
        pool = self._pool_buf
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

    Execution model: each composed :class:`IterationPlan` is flattened
    into one ragged :class:`IterationBatch` and executed by a single fused
    step (:meth:`PagedModelRunner.run_iteration`) returning every
    segment's next token in one transfer.  A request finishing its
    prefill starts decoding the *next* iteration (its first token is this
    step's argmax)."""

    def __init__(self, runner: PagedModelRunner, instance_id: int = 0,
                 max_batch: int = 8, eos_token: int = -1,
                 clock: Callable[[], float] = time.monotonic,
                 enable_prefix_cache: bool = False,
                 policy: Optional[SchedulerPolicy] = None,
                 prefill_chunk_tokens: Optional[int] = None,
                 tracer: Tracer = NULL_TRACER,
                 role: str = "general"):
        self.runner = runner
        self._pending: Optional[Tuple[IterationBatch, TokenBuffer]] = None
        self.bm = BlockManager(runner.num_blocks, runner.block_size)
        self.prefix_cache = (PrefixCache(runner.block_size)
                             if enable_prefix_cache else None)
        self.instance_id = instance_id
        self.max_batch = max_batch
        self.eos_token = eos_token
        self.clock = clock
        self.tracer = tracer
        self._next_tok: dict[int, int] = {}
        self.sched = BatchScheduler(
            self.bm, policy=policy, prefix_cache=self.prefix_cache,
            matcher=TokenPrefixMatcher(), max_running=max_batch,
            max_batch=runner.max_batch,
            prefill_chunk_tokens=prefill_chunk_tokens,
            on_preempt=lambda r: self._next_tok.pop(r.req_id, None),
            tracer=tracer, instance_id=instance_id, role=role)

    @property
    def role(self) -> str:
        return self.sched.role

    @property
    def waiting(self) -> List[Request]:
        return self.sched.waiting

    @property
    def running(self) -> List[Request]:
        return self.sched.running

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
        return self._pending is not None

    def dispatch_iteration(self) -> bool:
        """Compose this engine's next iteration and issue its fused step
        WITHOUT waiting for the result: the next-token ids stay on device
        until :meth:`collect` — or a later consumer — needs them.  Returns
        True iff an iteration was issued."""
        assert not self.has_pending, "collect() the previous iteration first"
        plan = self.sched.plan(self.clock())
        if plan is None:
            return False
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

    def run_until_drained(self, max_steps: int = 10_000) -> List[Request]:
        out = []
        for _ in range(max_steps):
            out.extend(self.step())
            if not self.running and not self.waiting:
                break
        return out
