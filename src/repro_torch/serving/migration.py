"""Live request migration: move a mid-flight request between engines.

The elastic cluster (``serving/autoscaler.py``) retires instances by
*draining them through migration*: every running request's state is
serialized into a block-granular :class:`RequestSnapshot` and rebuilt on
a surviving engine, so scale-down loses no progress and the continued
token stream is bit-identical to an unmigrated run (CI-gated exact by
``benchmarks/autoscale_burst.py``).

What a snapshot carries, and why it is sufficient:

* **Paged KV blocks** — the request's resident KV, gathered to host with
  :meth:`PagedModelRunner.read_blocks` (numpy has no bfloat16, so a
  bfloat16 pool's blocks travel as their raw bits in a ``uint16`` array:
  slicing, concatenation and ``nbytes`` hold on it unchanged).  Resident
  means positions ``[0, prefilled_len + output_len)``: a decoding
  request's pending (sampled-but-not-yet-fed) token has no KV yet — it is
  carried as a plain int and fed on the target, which writes its KV
  there.  Only the
  blocks covering resident tokens transfer; growth-reserve blocks are
  re-allocated by the target's scheduler.
* **Prefix-cache chain** — the prompt's full-block hash chain.  On
  restore, blocks the *target* already holds (hash match) are shared via
  ``allocate_shared`` instead of re-written, and the transferred prefix
  re-registers in the target's cache so later requests share it there;
  existing COW machinery keeps cache-registered blocks immutable under
  subsequent decode writes.
* **Generated tokens + scheduler position** — ``output_tokens`` /
  ``output_len`` / ``prefilled_len`` / timestamps live on the
  :class:`Request` object itself, which travels with the snapshot;
  :meth:`BatchScheduler.release` detaches it WITHOUT the progress reset
  preemption does, and :meth:`BatchScheduler.adopt` re-attaches it.

**The donated-pool address witness makes the transfer boundary explicit
and testable**: ``read_blocks`` only *reads* the source pool (its
device buffer address is unchanged — asserted here on every snapshot)
and ``write_blocks`` donates the target pool (its address is unchanged
too), so a migration moves exactly the gathered block bytes and neither
side ever materializes a second pool buffer.  Both calls must run
between synced iterations (no in-flight dispatch), which the cluster's
step loop guarantees.

**Batched transfers** (:func:`migrate_many`): N requests moving to one
target concatenate their non-cached block slices along the block axis
and land in ONE gathered donated ``write_blocks`` dispatch instead of
N — scale-down drains and multi-request prefill→decode handoffs
(``serving/handoff.py``) pay one dispatch per (source, target) pair,
not one per request.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from repro_torch.serving.engine import LLMEngine
from repro_torch.serving.faults import TransferFault
from repro_torch.serving.prefix_cache import PrefixCache
from repro_torch.serving.request import Request


class MigrationError(RuntimeError):
    """The migration could not be performed — either refused up front
    (e.g. the target cannot adopt) or rolled back after a transfer
    failure.  Both ways the refusal is LOSSLESS: the request is running
    on its source with identical progress, and the target holds none of
    its blocks (``_rollback_adoptions`` re-homes already-adopted
    requests before this is raised)."""


@dataclasses.dataclass
class RequestSnapshot:
    """A request's transferable state, block-granular and host-resident."""
    req: Request
    kv: np.ndarray                 # (L, 2, n_blocks, block_size, n_kv, hd);
    #                                a bfloat16 pool's exact bits as uint16
    hashes: List[int]              # full-block prompt hash chain (may be [])
    n_resident_tokens: int         # prefilled_len + output_len at snapshot
    pending_token: Optional[int]   # sampled-but-not-fed token (None mid-prefill)
    source_instance_id: int
    source_pool_address: object    # donated-pool witness at snapshot time
    n_cached_blocks: int = 0       # filled at restore: blocks served from the
    #                                target's prefix cache instead of the wire

    @property
    def n_blocks(self) -> int:
        return int(self.kv.shape[2])

    @property
    def n_bytes(self) -> int:
        """Bytes actually moved by this migration (the gathered blocks)."""
        return int(self.kv.size * self.kv.dtype.itemsize)


def snapshot_request(engine: LLMEngine, req: Request) -> RequestSnapshot:
    """Serialize a RUNNING request off ``engine`` and release its
    resources there.  Must run between synced iterations (no pending
    dispatch).  After this call the request belongs to nobody — pass the
    snapshot to :func:`restore_request` to re-home it."""
    assert not engine.has_pending, \
        "snapshot requires a synced engine (collect the iteration first)"
    assert req in engine.sched.running, \
        f"req {req.req_id} is not running on instance {engine.instance_id}"
    bm = engine.bm
    addr_before = engine.runner.pool_address()
    n_resident = req.prefilled_len + req.output_len
    table = bm.block_table(req.req_id)[:bm.blocks_needed(n_resident)]
    kv = engine.runner.read_blocks(table)
    assert isinstance(kv, np.ndarray), "snapshot KV must be host-resident"
    addr_after = engine.runner.pool_address()
    assert addr_after == addr_before, \
        "read_blocks must not disturb the donated pool buffer"
    hashes = req.prefix_hashes
    if hashes is None and req.prompt_tokens is not None:
        hashes = PrefixCache.hash_tokens(req.prompt_tokens, bm.block_size)
        req.prefix_hashes = hashes
    pending = engine.pending_token(req.req_id)
    engine.sched.release(req)
    engine.drop_pending_token(req.req_id)
    return RequestSnapshot(req=req, kv=kv, hashes=list(hashes or []),
                           n_resident_tokens=n_resident,
                           pending_token=pending,
                           source_instance_id=engine.instance_id,
                           source_pool_address=addr_before)


def restore_request(engine: LLMEngine, snap: RequestSnapshot,
                    now: Optional[float] = None) -> int:
    """Rebuild a snapshot on ``engine``: share what its prefix cache
    already holds, write the rest of the KV in one donated dispatch, and
    adopt the request into the scheduler mid-flight.  Returns the number
    of blocks served from the target's cache (not re-written)."""
    assert not engine.has_pending, \
        "restore requires a synced engine (collect the iteration first)"
    req = snap.req
    assert engine.instance_id != snap.source_instance_id or \
        req.req_id not in engine.bm.owned_seqs(), \
        "cannot restore onto the engine that still owns the request"
    now = engine.clock() if now is None else now
    bm = engine.bm
    n_res_blocks = bm.blocks_needed(snap.n_resident_tokens)
    cached: List[int] = []
    if engine.prefix_cache is not None and snap.hashes:
        # only fully-resident blocks can be served from the target cache:
        # a match beyond the transferred KV would leave holes
        matchable = min(len(snap.hashes),
                        snap.n_resident_tokens // bm.block_size)
        cached = engine.prefix_cache.match(snap.hashes[:matchable], bm)
    addr_before = engine.runner.pool_address()
    table = engine.sched.adopt(req, now, cached=cached, hashes=snap.hashes)
    if n_res_blocks > len(cached):
        engine.runner.write_blocks(snap.kv[:, :, len(cached):n_res_blocks],
                                   table[len(cached):n_res_blocks])
    addr_after = engine.runner.pool_address()
    assert addr_after == addr_before, \
        "write_blocks must donate the target pool in place"
    engine.sched.confirm_adoption(req)
    if snap.pending_token is not None:
        engine.set_pending_token(req.req_id, snap.pending_token)
    req.instance_id = engine.instance_id
    snap.n_cached_blocks = len(cached)
    return len(cached)


def _rollback_adoptions(source: LLMEngine, target: LLMEngine,
                        snaps: List[RequestSnapshot], now: float):
    """Undo a failed gathered transfer: release every adopted request's
    target-side blocks and re-home its snapshot on the source (which just
    released exactly the blocks it needs, so re-adoption cannot fail).
    After this, block accounting balances on BOTH managers and every
    request is RUNNING on the source with identical progress — the
    lossless-refusal invariant ``tests/test_migration.py`` witnesses."""
    for snap in reversed(snaps):
        req = snap.req
        if req.req_id in target.bm.owned_seqs():
            target.sched.release(req)
        target.drop_pending_token(req.req_id)
        restore_request(source, snap, now)


def migrate_many(source: LLMEngine, target: LLMEngine,
                 reqs: List[Request],
                 now: Optional[float] = None,
                 faults=None,
                 ) -> tuple:
    """Migrate every feasible request of ``reqs`` from ``source`` to
    ``target`` with ONE gathered donated ``write_blocks`` dispatch.

    Each request is probed (``can_adopt``), snapshotted, cache-matched
    and adopted individually — adoption updates the target's block
    accounting, so feasibility stays accurate as the batch grows — but
    the KV bytes of the whole batch are concatenated along the block
    axis and written in a single dispatch.  Requests the target cannot
    take are skipped untouched (still running on the source).

    Returns ``(snapshots, skipped)``: snapshots of the migrated requests
    (sum their ``n_bytes`` for transfer accounting; the whole batch cost
    at most one dispatch) and the requests left behind.

    **Partial-failure hardening**: the gathered write is the transfer's
    point of no return, and every adoption before it is provisional — if
    it raises (or ``faults`` injects a planned
    :class:`~repro_torch.serving.faults.TransferFault` at that exact point),
    all target-side adoptions are rolled back and every snapshot is
    restored onto the source before :class:`MigrationError` surfaces.
    No block leaks on either side, no request lost."""
    if target is source:
        raise MigrationError("migration target must differ from source")
    assert not target.has_pending, \
        "migrate_many requires a synced target (collect the iteration first)"
    now = target.clock() if now is None else now
    bm = target.bm
    snaps: List[RequestSnapshot] = []
    skipped: List[Request] = []
    kv_parts: List[np.ndarray] = []
    table_parts: List[int] = []
    addr_before = target.runner.pool_address()
    for req in list(reqs):
        if not target.sched.can_adopt(req):
            skipped.append(req)
            continue
        snap = snapshot_request(source, req)
        n_res_blocks = bm.blocks_needed(snap.n_resident_tokens)
        cached: List[int] = []
        if target.prefix_cache is not None and snap.hashes:
            matchable = min(len(snap.hashes),
                            snap.n_resident_tokens // bm.block_size)
            cached = target.prefix_cache.match(snap.hashes[:matchable], bm)
        table = target.sched.adopt(req, now, cached=cached,
                                   hashes=snap.hashes)
        if n_res_blocks > len(cached):
            kv_parts.append(snap.kv[:, :, len(cached):n_res_blocks])
            table_parts.extend(table[len(cached):n_res_blocks])
        if snap.pending_token is not None:
            target.set_pending_token(req.req_id, snap.pending_token)
        req.instance_id = target.instance_id
        snap.n_cached_blocks = len(cached)
        snaps.append(snap)
    try:
        if faults is not None and snaps:
            spec = faults.transfer_fault(source.instance_id, now)
            if spec is not None:
                raise TransferFault(source.instance_id, spec.step)
        if kv_parts:
            target.runner.write_blocks(np.concatenate(kv_parts, axis=2),
                                       table_parts)
    except Exception as err:
        # transfer failed AFTER target allocation — the worst point.
        # Roll back to lossless refusal: the source re-adopts every
        # snapshot, the target's provisional blocks are released.
        _rollback_adoptions(source, target, snaps, now)
        raise MigrationError(
            f"gathered transfer {source.instance_id}->"
            f"{target.instance_id} failed and was rolled back: {err}"
        ) from err
    assert target.runner.pool_address() == addr_before, \
        "gathered write_blocks must donate the target pool in place"
    for snap in snaps:
        target.sched.confirm_adoption(snap.req)
    return snaps, skipped


def migrate(source: LLMEngine, target: LLMEngine, req: Request,
            now: Optional[float] = None,
            faults=None) -> RequestSnapshot:
    """Snapshot ``req`` off ``source`` and restore it on ``target``.

    Feasibility is probed BEFORE anything is released (a refused
    migration leaves the request untouched on the source), and a restore
    that fails mid-way — or a planned transfer fault — is rolled back to
    the source (same lossless-refusal contract as :func:`migrate_many`).
    The snapshot is returned so callers can account transfer bytes."""
    if target is source:
        raise MigrationError("migration target must differ from source")
    if not target.sched.can_adopt(req):
        raise MigrationError(
            f"instance {target.instance_id} cannot adopt req {req.req_id}")
    snap = snapshot_request(source, req)
    try:
        if faults is not None:
            spec = faults.transfer_fault(source.instance_id, now)
            if spec is not None:
                raise TransferFault(source.instance_id, spec.step)
        restore_request(target, snap, now)
    except Exception as err:
        _rollback_adoptions(source, target, [snap],
                            target.clock() if now is None else now)
        raise MigrationError(
            f"transfer {source.instance_id}->{target.instance_id} of req "
            f"{req.req_id} failed and was rolled back: {err}") from err
    return snap
