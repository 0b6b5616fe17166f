"""Prefill→decode handoff: the disaggregation data path.

A role-typed cluster (``ServingConfig.roles``) splits instances into
``prefill`` engines — chunked prefill only, never growing decode batches
— and ``decode`` engines, which admit work exclusively through
:meth:`BatchScheduler.adopt`.  This module is the bridge between them:
when a prompt's last chunk completes on a prefill instance (the request
flips to :class:`RequestPhase.DECODE` and its first sampled token sits
in the engine's pending-token buffer), the driver moves its resident KV
block-granularly to a decode-capable instance through the migration
layer.

Handoff invariants (all inherited from ``serving/migration.py`` and
CI-gated by ``benchmarks/disagg.py``):

* **One gathered donated dispatch per (source, target) batch** — every
  request handed to the same target in a step shares a single
  ``write_blocks`` call (:func:`migrate_many`); both pool buffers are
  address-witnessed, so neither side ever copies its pool.
* **Token-bit-identity** — the pending first token travels as a plain
  int and the transferred prefix re-registers in the target's cache, so
  the decoded stream equals the colocated run bit for bit.
* **Lossless refusal** — when no decode-capable target can adopt a
  request, it is *stranded*: the prefill instance decodes it colocated
  (:meth:`BatchScheduler.allow_colocated_decode`) and the driver retries
  with exponential backoff, migrating mid-decode once capacity frees up.
  Past ``ServingConfig.handoff_retry_cap`` failed offers the strand is
  *permanent* — a durably full decode pool degrades to colocated decode
  instead of paying a probe per request per sweep forever.

Placement is memory-aware: the most-free decode target wins (dedicated
``decode`` instances preferred over ``general`` ones), OOM-fenced
instances are excluded.  Transfer faults (``serving/faults.py``) and
real ``write_blocks`` failures surface as :class:`MigrationError` from
the migration layer *after lossless rollback* — the sweep skips the
failed target and the requests stay intact on the source.
"""
from __future__ import annotations

from typing import List, Optional

from repro_torch.serving.engine import LLMEngine
from repro_torch.serving.migration import MigrationError, migrate, migrate_many
from repro_torch.serving.request import Request, RequestPhase


class HandoffError(RuntimeError):
    """The request is not in a handoff-able state (still mid-prefill)."""


def handoff(source: LLMEngine, target: LLMEngine, req: Request,
            now: Optional[float] = None):
    """Hand one prefill-complete request from ``source`` to ``target``.

    Thin phase-checked wrapper over :func:`migrate` for callers moving a
    single request; the cluster driver batches per target via
    :func:`migrate_many` instead.  Raises :class:`HandoffError` if the
    prompt is not fully resident, :class:`MigrationError` if the target
    refuses — both before any source state is released."""
    if req.prefilled_len < req.prompt_len:
        raise HandoffError(
            f"req {req.req_id} is mid-prefill "
            f"({req.prefilled_len}/{req.prompt_len} tokens resident)")
    snap = migrate(source, target, req, now)
    req.phase = RequestPhase.DECODE
    return snap


def decode_targets(cluster, source: LLMEngine, now: float) -> List[LLMEngine]:
    """Decode-capable engines able to receive ``source``'s handoffs:
    dedicated ``decode`` instances first, then ``general`` ones, most
    free KV (free + reclaimable cached blocks) first within each class;
    OOM-fenced instances excluded."""
    out = [e for e in cluster.engines
           if e is not source and e.role != "prefill"
           and not cluster.dispatcher.is_fenced(e.instance_id, now)]
    out.sort(key=lambda e: (e.role != "decode",
                            -(e.bm.free_blocks + e.bm.cached_blocks)))
    return out


def drive_handoffs(cluster, now: float) -> dict:
    """One handoff sweep over the cluster's prefill instances.

    Called by ``ServingCluster.step`` after every engine has collected
    (all pools synced — the only legal transfer point).  For each
    prefill instance, every offerable prefill-complete request
    (:meth:`BatchScheduler.handoff_offers` — strand backoff/cap applied)
    is offered to decode-capable targets most-free-first; each (source,
    target) batch costs one gathered donated ``write_blocks`` dispatch.
    A target whose transfer fails (injected fault or real write error)
    is skipped after the migration layer's lossless rollback.  Requests
    no target can take are stranded for colocated decode and re-offered
    with exponential backoff up to ``handoff_retry_cap`` attempts, then
    permanently colocated.  Returns the sweep's accounting (handoffs,
    bytes, dispatches, strandings, strand retries) — the cluster folds
    it into its metrics."""
    stats = {"n_handoffs": 0, "handoff_bytes": 0,
             "handoff_dispatches": 0, "n_stranded": 0,
             "n_strand_retries": 0}
    tracer = cluster.tracer
    cap = (cluster.config.handoff_retry_cap
           if getattr(cluster, "config", None) is not None else 4)
    faults = getattr(cluster, "faults", None)
    for src in cluster.engines:
        if src.role != "prefill":
            continue
        remaining = src.sched.handoff_offers(cap)
        if not remaining:
            continue
        for tgt in decode_targets(cluster, src, now):
            if not remaining:
                break
            d0 = tgt.runner.n_dispatches
            try:
                snaps, remaining = migrate_many(src, tgt, remaining, now,
                                                faults=faults)
            except MigrationError:
                # transfer failed after target allocation: the migration
                # layer rolled everything back onto the source — skip
                # this target, the requests are intact and re-offerable
                continue
            stats["n_handoffs"] += len(snaps)
            stats["handoff_bytes"] += sum(s.n_bytes for s in snaps)
            stats["handoff_dispatches"] += tgt.runner.n_dispatches - d0
            if tracer.enabled:
                for s in snaps:
                    tracer.emit("handoff-start", req_id=s.req.req_id,
                                instance_id=src.instance_id,
                                agent=s.req.agent_name, msg_id=s.req.msg_id,
                                ts=now, to=tgt.instance_id,
                                n_blocks=s.n_blocks, n_bytes=s.n_bytes)
                    tracer.emit("handoff-complete", req_id=s.req.req_id,
                                instance_id=tgt.instance_id,
                                agent=s.req.agent_name, msg_id=s.req.msg_id,
                                ts=now, src=src.instance_id,
                                cached=s.n_cached_blocks)
        for req in remaining:
            # full decode pool (or every target's transfer failed):
            # decode colocated rather than stall — lossless, re-offered
            # with backoff until the retry cap makes the strand final
            fresh = req.req_id not in src.sched.stranded
            permanent = src.sched.note_strand(req, cap)
            if fresh:
                stats["n_stranded"] += 1
                src.sched.allow_colocated_decode(req)
            else:
                stats["n_strand_retries"] += 1
            if tracer.enabled:
                tracer.emit("handoff-strand", req_id=req.req_id,
                            instance_id=src.instance_id,
                            agent=req.agent_name, msg_id=req.msg_id,
                            ts=now,
                            attempts=src.sched.strand_attempts[req.req_id],
                            permanent=permanent)
    return stats


__all__ = ["HandoffError", "MigrationError", "handoff", "decode_targets",
           "drive_handoffs"]
