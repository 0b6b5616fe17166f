"""Instance-failure recovery and SLO-aware load shedding.

The lossless half of the fault plane (``faults.py`` is the chaos half).
Three pieces:

**Detection** — a crash surfaces as :class:`InstanceCrashed` from the
engine's dispatch; the cluster's step loop catches it at the
synced post-collect point (the only moment pools are legal to touch) and
hands the engine here.  Stragglers are caught by a per-engine *step
deadline*: an engine whose dispatch+sync wall time exceeds
``step_deadline_s`` is fenced through the existing dispatcher OOM-fence
machinery (routed around for a cooldown, not killed).

**Reconstruction with bit-identical replay** — a dead engine's pool is
untrusted, so its RUNNING/WAITING requests cannot be migrated out; they
are *reconstructed*: progress is reset (as recompute-preemption already
does) and the request re-queued with **prompt + already-emitted tokens**
as its new prompt.  Because decoding is argmax-only and prefill(prompt +
emitted) builds the same KV state as the original decode path, the
continuation tokens are bit-identical; the emitted prefix is re-emitted
verbatim at finish.  Where the original prompt's block hashes survive in
a surviving instance's prefix cache, the re-prefill is served from cache
(the hash chain of an unchanged prefix is unchanged).  Every crash a
request survives burns one unit of its retry budget; past the budget it
surfaces as ``RequestState.FAILED`` (after exponential backoff between
attempts) instead of looping forever.

**Graceful degradation** — :class:`LoadShedder` is the overload valve:
under *sustained* overload (queue-depth + KV-pressure, the same signals
the autoscaler reads) it sheds the queued requests least likely to meet
their deadline instead of letting p99 collapse for everyone.  Service
time is priced by the :class:`~repro_torch.sim.cost_model.CostModel`, so the
real cluster and the sim shed by the same rule.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.obs.trace import NULL_TRACER, Tracer
from repro_torch.serving.request import Request, RequestPhase, RequestState


@dataclasses.dataclass
class RecoveryRecord:
    """Original identity of a reconstructed request, kept until finish so
    the extended prompt can be unwound and the replayed tokens re-emitted.
    ``replay`` accumulates across repeated crashes (a request that dies
    twice replays everything it had ever emitted)."""
    orig_prompt_tokens: object
    orig_prompt_len: int
    orig_max_new: int
    replay: List[int] = dataclasses.field(default_factory=list)
    retries: int = 0
    ready_at: float = 0.0


class RecoveryManager:
    """Failure detection + lossless request reconstruction for one
    :class:`~repro_torch.serving.cluster.ServingCluster`."""

    def __init__(self, *, max_retries: int = 3, backoff_s: float = 0.0,
                 step_deadline_s: Optional[float] = None,
                 tracer: Tracer = NULL_TRACER):
        assert max_retries >= 0
        self.max_retries = max_retries
        self.backoff_s = backoff_s
        self.step_deadline_s = step_deadline_s
        self.tracer = tracer
        self._records: Dict[int, RecoveryRecord] = {}
        self._backoff: List[Tuple[float, Request]] = []
        # counters (surfaced via metrics())
        self.n_crashes = 0
        self.n_reconstructed = 0
        self.n_failed = 0
        self.n_replayed_tokens = 0
        self.n_straggler_fences = 0

    # ------------------------------------------------------------- detection
    def check_step_deadline(self, cluster, engine, elapsed_s: float,
                            now: float) -> bool:
        """Post-collect heartbeat: fence an engine whose step blew the
        deadline (straggler).  Fencing reuses the dispatcher's OOM-fence
        — the balancer routes around it until the cooldown expires."""
        if self.step_deadline_s is None or elapsed_s <= self.step_deadline_s:
            return False
        if self.tracer.enabled:
            self.tracer.emit("failure-detected",
                             instance_id=engine.instance_id, ts=now,
                             reason="straggler", elapsed_s=elapsed_s)
        cluster.dispatcher.on_oom(engine.instance_id, now)
        self.n_straggler_fences += 1
        return True

    # -------------------------------------------------------------- recovery
    def on_crash(self, cluster, engine, now: float) -> List[Request]:
        """Handle a dead engine: permanently fence + remove it through
        the dispatcher machinery, reconstruct its in-flight requests,
        and return the ones whose retry budget is spent (surfaced as
        FAILED so drivers unblock)."""
        iid = engine.instance_id
        victims = list(engine.sched.waiting) + list(engine.sched.running)
        self.n_crashes += 1
        if self.tracer.enabled:
            self.tracer.emit("failure-detected", instance_id=iid, ts=now,
                             reason="crash", n_lost=len(victims))
        # Fence first (emits the standard oom-fence event), then remove:
        # removal is what makes the fence permanent — the instance model
        # is gone from every dispatcher map, so nothing routes to it.
        try:
            cluster.dispatcher.on_oom(iid, now)
        except KeyError:  # pragma: no cover - already removed
            pass
        removed = cluster.dispatcher.remove_instance(iid)
        removed.fenced_until = float("inf")
        cluster.discard_engine(engine)
        failed: List[Request] = []
        for req in victims:
            rec = self._records.get(req.req_id)
            if rec is None:
                rec = RecoveryRecord(req.prompt_tokens, req.prompt_len,
                                     req.max_new_tokens)
                self._records[req.req_id] = rec
            rec.retries += 1
            if rec.retries > self.max_retries:
                self._records.pop(req.req_id, None)
                req.state = RequestState.FAILED
                req.finish_time = now
                req.instance_id = -1
                self.n_failed += 1
                failed.append(req)
                continue
            self._reconstruct(req, rec, now)
            delay = self.backoff_s * (2.0 ** (rec.retries - 1))
            if delay > 0.0:
                rec.ready_at = now + delay
                self._backoff.append((rec.ready_at, req))
            else:
                cluster.balancer.enqueue(req)
        return failed

    def _reconstruct(self, req: Request, rec: RecoveryRecord, now: float):
        """Reset progress (recompute-preemption semantics) and extend the
        prompt with everything emitted so far; the argmax decode path
        then replays the stream bit-identically."""
        emitted = [int(t) for t in req.output_tokens]
        rec.replay.extend(emitted)
        self.n_replayed_tokens += len(emitted)
        self.n_reconstructed += 1
        req.output_tokens.clear()
        req.output_len = 0
        req.prefilled_len = 0
        req.cached_prefix_len = 0
        req.phase = RequestPhase.PREFILL
        req.first_token_time = -1.0
        req.state = RequestState.QUEUED
        req.instance_id = -1
        if rec.replay:
            base = np.asarray(rec.orig_prompt_tokens)
            req.prompt_tokens = np.concatenate(
                [base, np.asarray(rec.replay, dtype=base.dtype)])
            req.prompt_len = rec.orig_prompt_len + len(rec.replay)
            req.max_new_tokens = rec.orig_max_new - len(rec.replay)
            assert req.max_new_tokens >= 1
            # the prompt changed past orig_prompt_len: the memoized hash
            # chain is stale, but the *shared* original-prefix hashes are
            # unchanged — surviving caches serve them on re-prefill
            req.prefix_hashes = None
        if self.tracer.enabled:
            self.tracer.emit("recovery-replay", req_id=req.req_id, ts=now,
                             agent=req.agent_name, msg_id=req.msg_id,
                             replayed=len(rec.replay), retry=rec.retries)

    # ------------------------------------------------------------- lifecycle
    def tick(self, cluster, now: float):
        """Release backed-off reconstructions whose timers expired."""
        if not self._backoff:
            return
        due = [r for t, r in self._backoff if t <= now]
        if not due:
            return
        self._backoff = [(t, r) for t, r in self._backoff if t > now]
        for req in due:
            cluster.balancer.enqueue(req)

    def on_finish(self, req: Request):
        """Unwind a recovered request at finish: re-emit the replayed
        prefix verbatim and restore the original prompt identity (the
        CompletionRecord and every downstream consumer see the request
        exactly as if no crash had happened)."""
        rec = self._records.pop(req.req_id, None)
        if rec is None or not rec.replay:
            return
        req.output_tokens[:0] = rec.replay
        req.output_len = len(req.output_tokens)
        req.prompt_tokens = rec.orig_prompt_tokens
        req.prompt_len = rec.orig_prompt_len
        req.max_new_tokens = rec.orig_max_new
        req.prefix_hashes = None

    @property
    def pending(self) -> int:
        """Reconstructed requests still waiting out their backoff —
        drain loops must not exit while these exist."""
        return len(self._backoff)

    @property
    def backoff_deadlines(self) -> List[float]:
        """When each backed-off reconstruction becomes re-queueable
        (event-driven callers arm a timer per deadline)."""
        return [t for t, _ in self._backoff]

    def metrics(self) -> Dict[str, float]:
        return {
            "n_crashes": self.n_crashes,
            "n_reconstructed": self.n_reconstructed,
            "n_recovery_failed": self.n_failed,
            "n_replayed_tokens": self.n_replayed_tokens,
            "n_straggler_fences": self.n_straggler_fences,
            "recovery_backlog": len(self._backoff),
        }


class LoadShedder:
    """The overload valve (graceful degradation).

    Opens only under *sustained* overload — ``patience`` consecutive
    sweeps where balancer queue depth exceeds ``queue_high`` per instance
    or KV pressure exceeds ``kv_high`` with a non-empty queue (the same
    queue-depth/KV signals the autoscaler scales on).  Once open it
    sheds, deterministically:

    1. every queued request whose deadline is unreachable even if
       dispatched immediately (``now + service_time > arrival + slo``) —
       these can only waste capacity others could use;
    2. if the queue still overflows the valve line, the lowest-slack
       requests down to the line — the ones least likely to make it.

    ``service_time`` is priced by the :class:`CostModel`'s steady-state
    decode rate, so sim and real shed by one rule.
    """

    def __init__(self, *, slo_e2e_s: float, cost,
                 queue_high: float = 8.0, kv_high: float = 0.97,
                 patience: int = 3, tracer: Tracer = NULL_TRACER):
        assert slo_e2e_s > 0 and patience >= 1
        self.slo_e2e_s = slo_e2e_s
        self.cost = cost
        self.queue_high = queue_high
        self.kv_high = kv_high
        self.patience = patience
        self.tracer = tracer
        self._streak = 0
        self.n_shed = 0

    # ------------------------------------------------------------- estimates
    def service_time(self, req: Request) -> float:
        """Best-case remaining service time if dispatched right now:
        one prefill pass + steady-state decode of the full budget."""
        rate = self.cost.decode_tok_per_s()
        prefill = self.cost.iteration_time(
            n_decode=0, prefill_tokens=max(0, req.prompt_len),
            cached_tokens=0, n_prefill_seqs=1)
        return prefill + req.max_new_tokens / rate

    def slack(self, req: Request, now: float) -> float:
        return (req.arrival_time + self.slo_e2e_s) - (
            now + self.service_time(req))

    @property
    def open(self) -> bool:
        return self._streak >= self.patience

    # ----------------------------------------------------------------- sweep
    def observe(self, queue_depth: int, n_instances: int,
                max_kv_frac: float) -> bool:
        """Advance the sustained-overload streak; returns valve state."""
        line = self.queue_high * max(1, n_instances)
        overloaded = queue_depth > line or (
            queue_depth > 0 and max_kv_frac >= self.kv_high)
        self._streak = self._streak + 1 if overloaded else 0
        return self.open

    def select(self, queue: List[Request], now: float,
               n_instances: int) -> List[Request]:
        """Pick victims from an open valve's queue (pure; the caller
        removes them, marks them SHED, and surfaces them)."""
        if not self.open or not queue:
            return []
        victims = [r for r in queue if self.slack(r, now) < 0.0]
        chosen = {r.req_id for r in victims}
        line = int(self.queue_high * max(1, n_instances))
        rest = [r for r in queue if r.req_id not in chosen]
        overflow = len(rest) - line
        if overflow > 0:
            rest.sort(key=lambda r: (self.slack(r, now), r.req_id))
            victims.extend(rest[:overflow])
        return victims

    def shed(self, req: Request, now: float, queue_depth: int):
        """Book one shed request (state flip + trace + counter)."""
        req.state = RequestState.SHED
        req.finish_time = now
        self.n_shed += 1
        if self.tracer.enabled:
            self.tracer.emit("shed", req_id=req.req_id, ts=now,
                             agent=req.agent_name, msg_id=req.msg_id,
                             slack=self.slack(req, now), queued=queue_depth)
