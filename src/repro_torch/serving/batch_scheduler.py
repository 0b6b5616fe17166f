"""Instance-level batch scheduler shared by the real engine and the simulator.

Kairos' workflow-aware priorities (§5) used to stop at the load balancer:
once dispatched, both :class:`~repro_torch.serving.engine.LLMEngine` and the
simulator's ``SimInstance`` fell back to FCFS deques with monolithic
prefill, so a long prompt head-of-line-blocked every running decode for a
full iteration.  This module owns every instance-side scheduling decision
— admission, prefix-cache matching, block accounting, growth / eviction /
preemption, and per-iteration batch composition — so that the real JAX
engine and the discrete-event simulator are thin *execution backends* of
one policy implementation instead of two drifting copies.

Two capabilities live here:

* **Priority-ordered instance queues** — the waiting queue is ordered by a
  :class:`~repro_torch.core.scheduler.SchedulerPolicy` (FCFS for baselines,
  ``KairosScheduler`` for kairos runs), and admission is *strict*: the
  policy-first request that does not fit blocks everything behind it, so
  low-priority work can never slip past a high-priority request under
  memory pressure.  Preemption picks ``max`` by the policy's
  ``victim_key`` — by default the latest arrival (the classic vLLM
  recompute victim, least progress lost), independent of admission order.

* **Chunked prefill** (Sarathi-style) — with ``prefill_chunk_tokens`` set,
  prompts are prefilled in budget-sized chunks interleaved with decode
  steps instead of one monolithic pass, bounding the per-iteration stall a
  long prompt can inflict on running decodes.  ``prefill_chunk_tokens=None``
  reproduces monolithic prefill exactly (token-identical, same block
  accounting).

The scheduler composes an :class:`IterationPlan` per step; the engine
executes it with :class:`~repro_torch.serving.engine.PagedModelRunner` (real
tokens), the simulator prices it with
:meth:`~repro_torch.sim.cost_model.CostModel.iteration_time`.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np

from repro_torch.core.scheduler import FCFSScheduler, SchedulerPolicy
from repro_torch.obs.trace import NULL_TRACER, Tracer
from repro_torch.serving.kv_cache import BlockManager
from repro_torch.serving.prefix_cache import PrefixCache
from repro_torch.serving.request import Request, RequestPhase, RequestState


# =============================================================================
# prefix matchers (how a request's shareable prefix is identified)
# =============================================================================


class TokenPrefixMatcher:
    """Real engine: hash the actual prompt tokens (full blocks only)."""

    def __call__(self, req: Request, cache: PrefixCache,
                 bm: BlockManager) -> Tuple[List[int], List[int]]:
        if req.prefix_hashes is None:
            req.prefix_hashes = PrefixCache.hash_tokens(
                req.prompt_tokens, bm.block_size)
        hashes = req.prefix_hashes
        cached = cache.match(
            hashes[:cache.usable_prefix_blocks(req.prompt_len)], bm)
        return hashes, cached


class KeyPrefixMatcher:
    """Simulator: synthetic hash chain from the declared ``cache_key`` /
    ``shared_prefix_len`` (only the agent system prompt is known to be
    content-identical across calls)."""

    def __call__(self, req: Request, cache: PrefixCache,
                 bm: BlockManager) -> Tuple[List[int], List[int]]:
        if not req.cache_key or req.shared_prefix_len <= 0:
            return [], []
        n_blocks = min(req.prompt_len - 1, req.shared_prefix_len) \
            // bm.block_size
        hashes = PrefixCache.key_chain(req.cache_key, n_blocks)
        return hashes, cache.match(hashes, bm)


# =============================================================================
# iteration plan
# =============================================================================


@dataclasses.dataclass
class PrefillChunk:
    """One prompt segment to prefill this iteration: tokens
    ``[start, end)`` of ``req.prompt_tokens``, attending over the
    ``start`` resident tokens already in the pool (cached prefix +
    earlier chunks).  ``is_last`` marks the chunk that completes the
    prompt and yields next-token logits."""
    req: Request
    start: int
    end: int
    is_last: bool


@dataclasses.dataclass
class IterationPlan:
    """What one continuous-batching iteration executes.

    ``prefill_tokens`` — newly computed prompt tokens (sum of chunk sizes);
    ``context_tokens`` — resident tokens those chunks attend over (prices
    the re-read cost of chunked prefill; for monolithic prefill it equals
    the admission cache hit);
    ``cow`` — (src, dst) physical block copies the backend must perform
    before decoding (copy-on-write of shared pages).
    """
    chunks: List[PrefillChunk]
    decode: List[Request]
    cow: List[Tuple[int, int]]
    prefill_tokens: int
    context_tokens: int


# =============================================================================
# flat iteration batch (fused single-dispatch execution)
# =============================================================================

# Bucket floors for the padded static shapes of an IterationBatch.  Every
# dimension is rounded up to floor * 2^k, so the set of distinct compiled
# shapes grows logarithmically with the largest iteration ever composed —
# the jit cache is bounded by a few dozen entries no matter the workload
# (guarded by tests/test_fused_iteration.py).
TOKEN_BUCKET_FLOOR = 4      # chunk-tile length L
CHUNK_SEG_FLOOR = 1         # chunk-tile rows Sp (each padded row costs a
#                             whole L of dead compute, so start at 1)
SEGMENT_BUCKET_FLOOR = 4    # decode rows / sample rows
TABLE_BUCKET_FLOOR = 4      # block-table width
COW_BUCKET_FLOOR = 4        # copy-on-write pairs


def pad_bucket(n: int, floor: int) -> int:
    """Smallest floor * 2^k >= n; 0 stays 0 (an absent part of the batch
    keeps zero-sized static shapes, so e.g. decode-only iterations compile
    away the prefill computation entirely)."""
    if n == 0:
        return 0
    b = floor
    while b < n:
        b *= 2
    return b


@dataclasses.dataclass
class Segment:
    """Host-side metadata for one row of an :class:`IterationBatch`:
    which request the row belongs to and whether its argmax row yields a
    token the backend must consume (final prefill chunk -> pending first
    token; decode -> next token)."""
    req: Request
    kind: str                  # "prefill" | "decode"
    emits_token: bool


@dataclasses.dataclass
class IterationBatch:
    """One iteration flattened into a single ragged device batch.

    All prefill-chunk tokens (arbitrary mid-block start/end, attending
    cached-prefix KV already resident in the pool) are concatenated with
    all decode tokens into one flat token batch; per-token metadata maps
    each row to its segment's block table, absolute position, and KV
    write slot, so the backend executes the whole iteration in ONE
    dispatch (segment-blocked causal mask, one KV scatter, one argmax
    transfer) instead of one dispatch per chunk plus a decode dispatch.

    The batch keeps the prefill part and the decode part as *separate
    arrays* (concatenated on device): chunk tokens are tiled dense
    (Sp, L) so each chunk's pages are gathered once — through the short
    tables covering its own prompt extent — while single decode tokens
    attend through their full (long) tables via the classic paged decode
    kernel.  A shared per-token layout would force every chunk token to
    gather the longest decode context (measured 3-4x more page-copy
    traffic).  The device row layout is
    ``[chunk s token j -> s*L + j | decode i -> Sp*L + i]``.

    Arrays are padded to a small set of static bucket shapes
    (:func:`pad_bucket`) to bound jit recompilation; padding token rows
    carry an out-of-range ``write_slots`` entry (scatters drop them) and
    padding segment rows are never consumed (``segments`` covers only
    real rows: chunks in plan order, then decodes).  An absent part
    (decode-only or prefill-only iteration) has zero-sized shapes and
    compiles away.
    """
    # -- prefill part: chunks tiled dense (Sp segments x L tokens) -----------
    tokens_p: np.ndarray      # (Sp, L) int32 prompt-chunk token ids
    positions_p: np.ndarray   # (Sp, L) int32 absolute position in the sequence
    tables_p: np.ndarray      # (Sp, nbp) int32: blocks covering each chunk's
    #                           prompt extent [0, end)
    # -- decode part (Td rows; each row is its own segment) ------------------
    tokens_d: np.ndarray      # (Td,) int32 pending next tokens
    positions_d: np.ndarray   # (Td,) int32 write/attend position (total_len)
    tables_d: np.ndarray      # (Td, nbd) int32 full sequence tables
    # -- shared --------------------------------------------------------------
    write_slots: np.ndarray   # (Sp*L+Td,) int32 flat pool slot (block*bs+off)
    #                           in device layout; padding -> n_slots (dropped)
    sample_rows: np.ndarray   # (S,) int32 device-layout row whose logits give
    #                           each segment's next token (padding -> 0)
    cow_src: np.ndarray       # (C,) int32 copy-on-write sources (padding -> 0)
    cow_dst: np.ndarray       # (C,) int32 destinations (padding -> num_blocks,
    #                           dropped by the copy scatter)
    segments: List[Segment]   # host metadata, one per REAL segment row
    n_tokens: int             # real (unpadded) token count

    @property
    def shape_key(self) -> Tuple[int, ...]:
        """The static shapes a jit specializes on — distinct keys bound
        the compile count."""
        return (*self.tokens_p.shape, self.tables_p.shape[1],
                len(self.tokens_d), self.tables_d.shape[1],
                len(self.sample_rows), len(self.cow_src))


def flatten_plan(plan: IterationPlan, bm: BlockManager,
                 next_token: Mapping[int, int]) -> IterationBatch:
    """Flatten an :class:`IterationPlan` into a single ragged
    :class:`IterationBatch`.

    ``next_token`` maps req_id -> pending decode token (the backend's
    sampled-but-not-yet-fed token; any ``int()``-convertible value,
    including the engine's deferred ``TokenRef``).  A request whose
    *final* prefill
    chunk is in this very plan has no pending token yet — its first
    decode token is the argmax of that chunk's logits, computed by this
    same dispatch — so its decode entry is deferred to the next
    iteration (classic prefill->decode pipelining; the generated token
    values are unchanged, only the iteration they land in shifts by one).
    """
    bs = bm.block_size
    n_slots = bm.num_blocks * bs
    segments: List[Segment] = []

    # prefill part: chunks tiled dense (Sp, L), tables trimmed per chunk
    chunks = plan.chunks
    sp = pad_bucket(len(chunks), CHUNK_SEG_FLOOR)
    lp = pad_bucket(max((c.end - c.start for c in chunks), default=0),
                    TOKEN_BUCKET_FLOOR)
    nbp = pad_bucket(max((bm.blocks_needed(c.end) for c in chunks), default=0),
                     TABLE_BUCKET_FLOOR)
    # decode part: one row per running sequence, full tables
    just_completed = {c.req.req_id for c in chunks if c.is_last}
    decode = [r for r in plan.decode if r.req_id not in just_completed]
    td = pad_bucket(len(decode), SEGMENT_BUCKET_FLOOR)
    nbd = pad_bucket(max((len(bm.block_table(r.req_id)) for r in decode),
                         default=0), TABLE_BUCKET_FLOOR)

    tokens_p = np.zeros((sp, lp), np.int32)
    positions_p = np.zeros((sp, lp), np.int32)
    tables_p = np.zeros((sp, nbp), np.int32)
    write_slots = np.full(sp * lp + td, n_slots, np.int32)
    sample_rows = np.zeros(pad_bucket(len(chunks) + len(decode),
                                      SEGMENT_BUCKET_FLOOR), np.int32)
    for s, c in enumerate(chunks):
        table = np.asarray(bm.block_table(c.req.req_id), np.int32)
        n = c.end - c.start
        pos = np.arange(c.start, c.end, dtype=np.int32)
        tokens_p[s, :n] = np.asarray(c.req.prompt_tokens, np.int32)[c.start:c.end]
        positions_p[s, :n] = pos
        tables_p[s, :bm.blocks_needed(c.end)] = table[:bm.blocks_needed(c.end)]
        write_slots[s * lp:s * lp + n] = table[pos // bs] * bs + pos % bs
        sample_rows[s] = s * lp + n - 1
        segments.append(Segment(c.req, "prefill", c.is_last))

    tokens_d = np.zeros(td, np.int32)
    positions_d = np.zeros(td, np.int32)
    tables_d = np.zeros((td, nbd), np.int32)
    for i, r in enumerate(decode):
        table = bm.block_table(r.req_id)
        # int() materializes deferred tokens (engine.TokenRef): feeding a
        # previous iteration's on-device argmax into this batch is the
        # one host sync of the pipelined execution model — by now the
        # producing dispatch has typically drained, so it's a copy, not
        # a stall
        tokens_d[i] = int(next_token[r.req_id])
        positions_d[i] = r.total_len
        tables_d[i, :len(table)] = table
        write_slots[sp * lp + i] = table[r.total_len // bs] * bs \
            + r.total_len % bs
        sample_rows[len(chunks) + i] = sp * lp + i
        segments.append(Segment(r, "decode", True))

    c_pad = pad_bucket(len(plan.cow), COW_BUCKET_FLOOR)
    cow_src = np.zeros(c_pad, np.int32)
    cow_dst = np.full(c_pad, bm.num_blocks, np.int32)
    for i, (src, dst) in enumerate(plan.cow):
        cow_src[i], cow_dst[i] = src, dst
    n_tokens = sum(c.end - c.start for c in chunks) + len(decode)
    return IterationBatch(tokens_p, positions_p, tables_p,
                          tokens_d, positions_d, tables_d,
                          write_slots, sample_rows, cow_src, cow_dst,
                          segments, n_tokens)


@dataclasses.dataclass
class SchedStats:
    n_finished: int = 0
    n_preempted: int = 0
    n_admitted: int = 0
    recent_oom: bool = False      # set on preemption; cleared by monitor reads
    prefill_tokens: int = 0       # prompt tokens actually computed
    prefill_tokens_saved: int = 0  # prompt tokens served from the prefix cache
    n_migrated_out: int = 0       # live requests released to another instance
    n_migrated_in: int = 0        # live requests adopted from another instance


# =============================================================================
# the scheduler
# =============================================================================


class BatchScheduler:
    """Admission + batch composition for one LLM instance.

    Parameters
    ----------
    bm:
        The instance's :class:`BlockManager` (owned by the backend so it
        can also expose monitor surfaces).
    policy:
        Ordering of the waiting queue and preemption-victim choice.
        Default FCFS (vLLM/Parrot semantics).
    prefix_cache / matcher:
        Shared-prefix KV reuse; ``matcher`` maps a request to its hash
        chain + cached blocks (token-hashing for the engine, key-chain
        for the simulator).
    max_running:
        Admission cap: how many requests may hold KV concurrently.
    max_batch:
        Per-iteration execution cap (decode slots).  Defaults to
        ``max_running``.
    prefill_chunk_tokens:
        Per-iteration prefill token budget.  ``None`` = monolithic
        prefill (a prompt is fully prefilled at admission, exactly the
        pre-refactor behaviour).
    watermark:
        Admission high-watermark on *hard* (non-reclaimable) block usage,
        vLLM-style hysteresis against growth thrash.
    on_preempt:
        Backend hook called with the victim request (e.g. the engine
        drops its pending next-token).
    tracer / instance_id:
        Observability: lifecycle events (admit, prefill-chunk, preempt,
        evict, finish) are emitted onto ``tracer``'s ring for
        ``instance_id``.  Defaults to the disabled :data:`NULL_TRACER` —
        every emit site is guarded on ``tracer.enabled`` so un-traced
        runs pay one branch.
    role:
        Disaggregation role of the owning instance.  ``"general"``
        (default) admits and decodes freely — the flat-cluster
        behaviour.  ``"prefill"`` runs chunked prefill only: requests
        whose prompt completes are expected to be handed off
        (``serving/handoff.py``) and are excluded from the decode set
        unless :meth:`allow_colocated_decode` marked them stranded (the
        lossless fallback when every decode pool is full).  ``"decode"``
        never admits from its waiting queue — work arrives exclusively
        through :meth:`adopt`.
    """

    def __init__(self, bm: BlockManager, *,
                 policy: Optional[SchedulerPolicy] = None,
                 prefix_cache: Optional[PrefixCache] = None,
                 matcher=None,
                 max_running: int = 16,
                 max_batch: Optional[int] = None,
                 prefill_chunk_tokens: Optional[int] = None,
                 watermark: float = 0.95,
                 on_preempt: Optional[Callable[[Request], None]] = None,
                 tracer: Tracer = NULL_TRACER,
                 instance_id: int = -1,
                 role: str = "general"):
        assert prefill_chunk_tokens is None or prefill_chunk_tokens > 0
        assert role in ("prefill", "decode", "general"), role
        self.role = role
        # req_ids a prefill-role instance may decode colocated: the
        # handoff driver strands a request here when no decode-capable
        # target can adopt it (retried with exponential backoff up to a
        # cap; decoding meanwhile loses nothing — migration is
        # bit-identical mid-decode)
        self.stranded: set = set()
        # strand-retry control (serving/handoff.py): failed-handoff count
        # per req_id, the sweep number before which a stranded request is
        # not re-offered, and the driver's sweep counter.  Past the cap a
        # request stops being offered at all — permanent colocation
        # instead of re-probing a full decode pool every sweep.
        self.strand_attempts: Dict[int, int] = {}
        self._strand_next: Dict[int, int] = {}
        self._handoff_sweep = 0
        self.bm = bm
        self.policy = policy or FCFSScheduler()
        self.prefix_cache = prefix_cache
        self.matcher = matcher or TokenPrefixMatcher()
        self.max_running = max_running
        self.max_batch = max_batch if max_batch is not None else max_running
        self.prefill_chunk_tokens = prefill_chunk_tokens
        self.watermark = watermark
        self.on_preempt = on_preempt
        self.tracer = tracer
        self.instance_id = instance_id
        self._now = 0.0          # timestamp of the current plan() step, so
        #                          preempt/evict emissions inside it are stamped
        self.waiting: List[Request] = []
        self.running: List[Request] = []
        self.stats = SchedStats()
        # hash chain of requests admitted with chunking still in flight:
        # blocks are registered with the cache only once their KV exists
        self._pending_hashes: Dict[int, List[int]] = {}
        self._inserted_blocks: Dict[int, int] = {}
        # monolithic mode indexes blocks at admission, before the backend
        # executes the prefill (so same-plan admissions can share them);
        # the (hash, block) pairs are provisional until the chunk that
        # writes them is composed, and are retracted if the request is
        # preempted first
        self._provisional: Dict[int, List[tuple]] = {}

    # ------------------------------------------------------------------ intake
    def submit(self, req: Request):
        req.state = RequestState.WAITING
        self.waiting.append(req)

    @property
    def has_work(self) -> bool:
        return bool(self.running or self.waiting)

    def can_admit(self, req: Request,
                  watermark: Optional[float] = None) -> bool:
        """Dispatcher probe: immediate admission capacity — batch slot +
        prompt memory below a high-watermark.  Zero-ref cached blocks are
        reclaimable, so they don't count against the watermark.  The
        probe defaults to the admission watermark minus a 0.05 hysteresis
        margin, so it always answers consistently with what ``_admit``
        will actually do."""
        if watermark is None:
            watermark = self.watermark - 0.05
        if self.role == "decode":
            return False          # decode instances admit only via adopt()
        if len(self.running) + len(self.waiting) >= self.max_running:
            return False
        pending = sum(r.prompt_len + 1 for r in self.waiting)
        need = self.bm.blocks_needed(req.prompt_len + 1 + pending)
        if not self.running and not self.waiting:
            # idle-instance bypass, mirroring _admit: an oversized prompt
            # may commit the whole pool rather than never dispatching
            return need <= self.bm.num_blocks - self.bm.hard_used_blocks
        budget = int(self.bm.num_blocks * watermark) - self.bm.hard_used_blocks
        return need <= budget

    # --------------------------------------------------------------- admission
    def _admit(self, now: float):
        """Admit waiting requests in strict policy order.  The first
        request that does not fit (memory watermark or free blocks)
        blocks admission — priority order is preserved even under
        pressure.  Admission is *not* gated on the prefill budget: an
        admitted prompt holds exactly the memory the monolithic path
        would, and the chunk budget below only shapes when its compute
        happens."""
        if not self.waiting or self.role == "decode":
            return
        watermark_blocks = int(self.bm.num_blocks * self.watermark)
        admitted: List[Request] = []
        for req in self.policy.order(self.waiting):
            if len(self.running) >= self.max_running:
                break
            hashes: List[int] = []
            cached: List[int] = []
            if self.prefix_cache is not None:
                hashes, cached = self.matcher(req, self.prefix_cache, self.bm)
            need = self.bm.blocks_needed(req.prompt_len + 1) - len(cached)
            # watermark first: it ignores reclaimable cached blocks, so
            # eviction can't satisfy it — evicting before checking would
            # trash the warm cache for nothing.  It only applies while
            # something is running: an idle instance may commit the whole
            # pool to one huge prompt (otherwise a prompt needing more
            # than watermark_blocks would starve forever)
            if (self.running
                    and self.bm.hard_used_blocks + need > watermark_blocks):
                for b in cached:
                    self.bm.ref_release(b)
                break
            if need > self.bm.free_blocks and self.prefix_cache is not None:
                n_ev = self.prefix_cache.evict(self.bm,
                                               need - self.bm.free_blocks)
                if n_ev and self.tracer.enabled:
                    self.tracer.emit("evict", instance_id=self.instance_id,
                                     ts=now, n=int(n_ev))
            if need > self.bm.free_blocks:
                for b in cached:          # abort: hand the refs back
                    self.bm.ref_release(b)
                break
            n_cached = len(cached) * self.bm.block_size
            if cached:
                table = self.bm.allocate_shared(req.req_id, cached,
                                                req.prompt_len + 1)
            else:
                table = self.bm.allocate(req.req_id, req.prompt_len + 1)
            if self.prefix_cache is not None:
                self.prefix_cache.note_admitted(len(cached), bool(hashes))
                if hashes and self.prefill_chunk_tokens is None:
                    # monolithic: the whole prompt is prefilled this very
                    # iteration, in admission order — later admissions may
                    # immediately share these blocks
                    self._provisional[req.req_id] = self.prefix_cache.insert(
                        hashes, table[:len(hashes)], self.bm)
                elif hashes:
                    # chunked: blocks become shareable only once written
                    self._pending_hashes[req.req_id] = list(hashes)
                    self._inserted_blocks[req.req_id] = \
                        n_cached // self.bm.block_size
            req.cached_prefix_len = n_cached
            req.prefilled_len = n_cached
            if req.exec_start_time < 0:
                req.exec_start_time = now
            req.state = RequestState.RUNNING
            self.running.append(req)
            admitted.append(req)
            self.stats.n_admitted += 1
            if self.tracer.enabled:
                self.tracer.emit("admit", req_id=req.req_id,
                                 instance_id=self.instance_id,
                                 agent=req.agent_name, msg_id=req.msg_id,
                                 ts=now, cached=n_cached)
            # prefill_tokens is charged as chunks are composed (so a
            # request preempted mid-prefill counts only executed tokens);
            # cache savings are realized here, at the match
            self.stats.prefill_tokens_saved += n_cached
        if admitted:
            gone = {r.req_id for r in admitted}
            self.waiting = [r for r in self.waiting if r.req_id not in gone]

    # -------------------------------------------------------------- preemption
    def _preempt_one(self):
        """Recompute policy: victim = ``max`` by the policy's
        ``victim_key``.  Every shipped policy inherits the default —
        latest arrival, i.e. the running request that loses the least
        decode progress to recompute."""
        self._preempt(max(self.running, key=self.policy.victim_key))

    def _preempt(self, victim: Request):
        self.running.remove(victim)
        # retract cache entries this request indexed at admission whose
        # KV was never executed: they must not outlive it as
        # matchable-but-garbage blocks
        pairs = self._provisional.pop(victim.req_id, None)
        dropped = (self.prefix_cache.retract(pairs, self.bm)
                   if pairs and self.prefix_cache is not None else [])
        self.bm.free(victim.req_id)
        self._pending_hashes.pop(victim.req_id, None)
        self._inserted_blocks.pop(victim.req_id, None)
        victim.state = RequestState.PREEMPTED
        victim.n_preemptions += 1
        if self.tracer.enabled:
            self.tracer.emit("preempt", req_id=victim.req_id,
                             instance_id=self.instance_id,
                             agent=victim.agent_name, msg_id=victim.msg_id,
                             ts=self._now,
                             lost=victim.prefilled_len + victim.output_len)
        victim.output_len = 0                      # recompute from scratch
        victim.output_tokens.clear()
        victim.prefilled_len = 0
        victim.first_token_time = -1.0             # recompute re-times TTFT
        victim.phase = RequestPhase.PREFILL        # prompt KV gone: re-prefill
        self.stranded.discard(victim.req_id)
        self.strand_attempts.pop(victim.req_id, None)
        self._strand_next.pop(victim.req_id, None)
        self.waiting.append(victim)
        self.stats.n_preempted += 1
        self.stats.recent_oom = True
        if self.on_preempt is not None:
            self.on_preempt(victim)
        if dropped:
            # cascade: a same-plan admission that matched the retracted
            # blocks holds references to KV that will never be written
            # (possible when the policy admits out of arrival order)
            garbage = set(dropped)
            for r in [r for r in self.running
                      if garbage.intersection(self.bm.block_table(r.req_id))]:
                if r in self.running:
                    self._preempt(r)

    def _ensure_growable(self):
        """The whole executing batch needs room to grow one token this
        step (cumulative blocks, not per-request).  Under pressure, cold
        cached blocks are evicted before any running request is preempted
        — recompute is far costlier than losing a cache entry."""
        def deficit():
            need = sum(
                max(self.bm.blocks_needed(r.total_len + 1)
                    - len(self.bm.block_table(r.req_id)), 0)
                for r in self.running[: self.max_batch])
            return need - self.bm.free_blocks

        while self.running and deficit() > 0:
            if self.prefix_cache is not None:
                n = self.prefix_cache.evict(self.bm, deficit())
                if n:
                    if self.tracer.enabled:
                        self.tracer.emit("evict",
                                         instance_id=self.instance_id,
                                         ts=self._now, n=int(n))
                    continue
            self._preempt_one()

    # ------------------------------------------------------------ composition
    def plan(self, now: float) -> Optional[IterationPlan]:
        """Compose one continuous-batching iteration: admit, make the
        batch growable, then hand out prefill chunks under the token
        budget and pick the decode set.  Returns None when idle."""
        budget = self.prefill_chunk_tokens
        self._now = now
        self._admit(now)
        if not self.running:
            return None
        self._ensure_growable()
        if not self.running:
            return None

        chunks: List[PrefillChunk] = []
        prefill_tokens = 0
        context_tokens = 0
        left = budget
        # budget is handed out in admission order (FIFO over the running
        # set), NOT re-sorted by policy each iteration: admission is
        # already policy-ordered, and run-to-completion finishes the
        # earliest-admitted prefill soonest — re-prioritizing mid-flight
        # processor-shares the budget across prompts, which measurably
        # delays every prefill completion (benchmarks/chunked_prefill.py
        # regresses ~17% p99 with policy-order handout)
        for r in self.running:
            rem = r.prompt_len - r.prefilled_len
            if rem <= 0:
                continue
            take = rem if left is None else min(rem, left)
            if take <= 0:
                break
            start = r.prefilled_len
            if take < rem:
                # align the chunk END (start + take) to a block boundary:
                # the engine's suffix-prefill jit cache is keyed on
                # (chunk_len, resident_len), and end-alignment makes those
                # pairs recur across requests even when leftover budget
                # spills a sub-budget first chunk into the next prompt.
                # A budget below block_size cannot align and simply pays
                # one compile per shape.
                aligned = take - (start + take) % self.bm.block_size
                if aligned > 0:
                    take = aligned
            chunks.append(PrefillChunk(r, start, start + take,
                                       is_last=start + take == r.prompt_len))
            if self.tracer.enabled:
                self.tracer.emit("prefill-chunk", req_id=r.req_id,
                                 instance_id=self.instance_id,
                                 agent=r.agent_name, msg_id=r.msg_id, ts=now,
                                 start=start, end=start + take,
                                 last=start + take == r.prompt_len)
            r.prefilled_len = start + take
            prefill_tokens += take
            context_tokens += start
            self.stats.prefill_tokens += take
            if left is not None:
                left -= take
            self._register_written_blocks(r)
            if start + take == r.prompt_len:
                # the chunk completing the prompt executes this very
                # iteration: admission-time inserts are now backed by KV
                self._provisional.pop(r.req_id, None)
                r.phase = RequestPhase.DECODE

        decode: List[Request] = []
        cow: List[Tuple[int, int]] = []
        for r in self.running[: self.max_batch]:
            if r.prefilled_len < r.prompt_len:
                continue
            if self.role == "prefill" and r.req_id not in self.stranded:
                # prefill instances never grow decode batches: this
                # request is leaving through the handoff driver (or will
                # be stranded here explicitly if no target can take it)
                continue
            self.bm.allocate(r.req_id, r.total_len + 1)
            if self.prefix_cache is not None:
                # decode writes at r.total_len: that page must be private
                pair = self.bm.copy_on_write(
                    r.req_id, r.total_len // self.bm.block_size)
                if pair is not None:
                    cow.append(pair)
            decode.append(r)
        if not chunks and not decode:
            return None
        if self.tracer.enabled:
            self.tracer.emit("iteration", instance_id=self.instance_id,
                             ts=now, n_chunks=len(chunks),
                             n_decode=len(decode),
                             n_tokens=prefill_tokens + len(decode))
        return IterationPlan(chunks, decode, cow, prefill_tokens,
                             context_tokens)

    def _register_written_blocks(self, req: Request) -> List[tuple]:
        """Chunked prefill: once a prompt block's KV is fully computed it
        may be shared — register it with the prefix cache.  (Admission
        matches run before chunk composition, so a match can never see a
        block whose KV has not been executed by the backend.)  Returns
        the ``(hash, block)`` pairs newly indexed, for callers that
        register ahead of the KV actually landing (:meth:`adopt`)."""
        hashes = self._pending_hashes.get(req.req_id)
        if hashes is None:
            return []
        done = min(req.prefilled_len // self.bm.block_size, len(hashes))
        ins = self._inserted_blocks[req.req_id]
        pairs: List[tuple] = []
        if done > ins:
            table = self.bm.block_table(req.req_id)
            pairs = self.prefix_cache.insert(hashes[ins:done],
                                             table[ins:done], self.bm)
            self._inserted_blocks[req.req_id] = done
        if req.prefilled_len >= req.prompt_len:
            self._pending_hashes.pop(req.req_id, None)
            self._inserted_blocks.pop(req.req_id, None)
        return pairs

    # ----------------------------------------------------------- disaggregation
    def handoff_ready(self) -> List[Request]:
        """Requests whose prompt KV is fully resident and that this
        instance will not decode itself — the prefill→decode handoff
        set.  Empty on non-prefill roles (general instances decode their
        own prefills; decode instances never prefill).  Stranded
        requests stay eligible: the driver retries them every step and
        migrates mid-decode once a target frees up (bit-identical)."""
        if self.role != "prefill":
            return []
        return [r for r in self.running if r.prefilled_len >= r.prompt_len]

    def handoff_offers(self, retry_cap: int) -> List[Request]:
        """:meth:`handoff_ready` filtered by strand-retry control, for
        one driver sweep (advances the sweep counter).  A stranded
        request backing off is withheld until its next-offer sweep; one
        past ``retry_cap`` failed offers is withheld permanently —
        colocated decode is its final home, so a full decode pool stops
        costing a probe per request per sweep."""
        self._handoff_sweep += 1
        out = []
        for r in self.handoff_ready():
            a = self.strand_attempts.get(r.req_id, 0)
            if a > retry_cap:
                continue
            if self._strand_next.get(r.req_id, 0) > self._handoff_sweep:
                continue
            out.append(r)
        return out

    def note_strand(self, req: Request, retry_cap: int) -> bool:
        """Book one failed handoff offer for ``req``: bump its attempt
        count and schedule its next offer exponentially later.  Returns
        True when the cap is now exceeded (the strand is permanent)."""
        a = self.strand_attempts.get(req.req_id, 0) + 1
        self.strand_attempts[req.req_id] = a
        self._strand_next[req.req_id] = self._handoff_sweep + (
            1 << min(a, 6))
        return a > retry_cap

    def allow_colocated_decode(self, req: Request) -> None:
        """Lossless fallback when no decode-capable instance can adopt
        ``req``: let this prefill instance decode it in place rather
        than stall it (or worse, preempt-and-recompute)."""
        self.stranded.add(req.req_id)

    # --------------------------------------------------------------- migration
    def release(self, req: Request) -> None:
        """Detach a live request WITHOUT resetting its progress — the
        source half of a live migration.  Unlike :meth:`_preempt`, the
        request keeps ``prefilled_len`` / ``output_len`` /
        ``output_tokens`` / ``first_token_time``: its KV is about to be
        rebuilt verbatim on another instance, not recomputed.  Blocks are
        freed here (shared/cached blocks merely lose a reference);
        provisional cache entries whose KV was never executed are
        retracted exactly as preemption would, including the cascade onto
        same-plan admissions that matched them."""
        if req in self.waiting:
            self.waiting.remove(req)
            req.state = RequestState.QUEUED
            return
        assert req in self.running, f"req {req.req_id} not on this scheduler"
        pairs = self._provisional.pop(req.req_id, None)
        dropped = (self.prefix_cache.retract(pairs, self.bm)
                   if pairs and self.prefix_cache is not None else [])
        self.bm.free(req.req_id)
        self._pending_hashes.pop(req.req_id, None)
        self._inserted_blocks.pop(req.req_id, None)
        self.stranded.discard(req.req_id)
        self.strand_attempts.pop(req.req_id, None)
        self._strand_next.pop(req.req_id, None)
        self.running.remove(req)
        req.state = RequestState.QUEUED
        self.stats.n_migrated_out += 1
        if dropped:
            garbage = set(dropped)
            for r in [r for r in self.running
                      if garbage.intersection(self.bm.block_table(r.req_id))]:
                if r in self.running:
                    self._preempt(r)

    def preempt(self, req: Request) -> None:
        """Public recompute-requeue of one running request (migration
        fallback when no instance can adopt it): progress resets, the
        request re-enters a waiting queue from scratch."""
        self._preempt(req)

    def can_adopt(self, req: Request, cached_blocks: int = 0) -> bool:
        """Whether :meth:`adopt` would succeed right now: a batch slot
        plus blocks for the request's resident KV and admission-style
        reserve (zero-ref parked cache blocks count — adopt may evict)."""
        if len(self.running) >= self.max_running:
            return False
        need = self.bm.blocks_needed(
            max(req.total_len + 1, req.prompt_len + 1)) - cached_blocks
        return need <= self.bm.free_blocks + self.bm.cached_blocks

    def adopt(self, req: Request, now: float,
              cached: Optional[List[int]] = None,
              hashes: Optional[List[int]] = None) -> List[int]:
        """Attach a migrated request to this scheduler's running set — the
        target half of a live migration — and return its block table for
        the caller to restore KV into.  ``cached`` seeds the table with
        prefix blocks already resident here (references acquired by the
        caller, e.g. ``PrefixCache.match``); ``hashes`` is the request's
        full-block hash chain, re-registered so the transferred prefix is
        shareable on this instance too (and, for a mid-prefill request,
        so later chunks keep registering as they execute).  Raises
        :class:`~repro_torch.serving.kv_cache.NoFreeBlocks` when capacity is
        insufficient — probe :meth:`can_adopt` first."""
        cached = list(cached or [])
        reserve = max(req.total_len + 1, req.prompt_len + 1)
        need = self.bm.blocks_needed(reserve) - len(cached)
        if need > self.bm.free_blocks and self.prefix_cache is not None:
            self.prefix_cache.evict(self.bm, need - self.bm.free_blocks)
        if cached:
            table = self.bm.allocate_shared(req.req_id, cached, reserve)
        else:
            table = self.bm.allocate(req.req_id, reserve)
        req.state = RequestState.RUNNING
        if req.exec_start_time < 0:
            req.exec_start_time = now
        self.running.append(req)
        self.stats.n_migrated_in += 1
        if hashes and self.prefix_cache is not None:
            self._pending_hashes[req.req_id] = list(hashes)
            self._inserted_blocks[req.req_id] = len(cached)
            # indexed ahead of the migration's KV transfer: provisional
            # until the caller confirms the write landed, so a rolled-back
            # adoption cannot leave matchable-but-garbage blocks behind
            pairs = self._register_written_blocks(req)
            if pairs:
                self._provisional[req.req_id] = pairs
        return table

    def confirm_adoption(self, req: Request) -> None:
        """The migration's KV transfer landed: cache entries indexed by
        :meth:`adopt` are now backed by real KV and must survive a later
        release (wave-2 handoffs re-share them)."""
        self._provisional.pop(req.req_id, None)

    # ------------------------------------------------------------------ finish
    def finish(self, req: Request, t: float):
        """Backend reports a completed request: release memory + book it."""
        req.state = RequestState.FINISHED
        req.finish_time = t
        if self.tracer.enabled:
            self.tracer.emit("finish", req_id=req.req_id,
                             instance_id=self.instance_id,
                             agent=req.agent_name, msg_id=req.msg_id, ts=t,
                             out=req.output_len)
        self.bm.free(req.req_id)
        self.running.remove(req)
        self._pending_hashes.pop(req.req_id, None)
        self._inserted_blocks.pop(req.req_id, None)
        self._provisional.pop(req.req_id, None)
        self.stranded.discard(req.req_id)
        self.strand_attempts.pop(req.req_id, None)
        self._strand_next.pop(req.req_id, None)
        self.stats.n_finished += 1
