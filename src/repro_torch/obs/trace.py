"""Request-lifecycle tracing: typed events in per-instance ring buffers.

The orchestrator's whole §4 story — "collect agent-specific information
for online workflow analysis" — presumes someone can actually *see*
where a workflow's latency goes.  This module is that someone: every
layer of the stack (load balancer, dispatcher, batch scheduler, engine,
cluster, simulator) emits :class:`Event`\\ s into a :class:`Tracer`, and
the ``obs`` siblings turn the streams into critical paths
(``critical_path.py``), SLO/goodput reports (``slo.py``), and
Chrome/Perfetto traces (``export.py``).

Design constraints, in order:

* **Near-zero overhead when disabled.**  Tracing is off by default:
  every call site holds a :data:`NULL_TRACER` whose ``enabled`` is
  ``False`` and guards the emit (``if tracer.enabled: tracer.emit(...)``)
  — the disabled cost is one attribute load and a branch, no call, no
  allocation.  A CI gate bounds the *enabled* overhead too
  (``benchmarks/latency_breakdown.py``: ``tracing_overhead_pct <= 5``).
* **Lock-free hot path.**  Events land in per-instance ring buffers
  (``instance_id`` keys a ring; control-plane events use ``-1``): an
  emit is one list-slot store plus an integer increment, no locks.
  Each ring is single-writer by construction — a cluster engine's
  events are emitted either from its dispatch worker or from the
  control-plane collect, never both concurrently (the cluster resolves
  the dispatch future before collecting), and control-plane events stay
  on the control-plane thread.
* **Bounded memory.**  Rings overwrite oldest-first past ``capacity``;
  ``dropped()`` reports how many events rolled off, so an exporter can
  say "truncated" instead of silently lying.
* **Sim/real parity.**  The simulator emits the *same* event schema with
  simulated timestamps (``emit(..., ts=now)``); the real path defaults
  to the tracer's ``clock``.  Sim-vs-real breakdowns are diffable.

Event taxonomy (``kind``):

======================  =====================================================
``submit``              request enqueued at the load balancer
``dispatch``            load balancer placed it on an instance
``migrate-candidate``   starvation valve engaged: request waited so long it
                        is force-placed (the natural seed for live migration)
``admit``               instance scheduler admitted it (KV allocated);
                        ``data['cached']`` = prefix-cache tokens served free
``prefill-chunk``       one prompt chunk composed into an iteration
                        (``data['start']/['end']/['last']``)
``first-token``         the request's first generated token was computed
``decode``              one decode token booked for the request
``iteration``           one engine iteration composed (``data['n_chunks']``,
                        ``['n_decode']``, ``['n_tokens']``)
``preempt``             request evicted by recompute-preemption
``evict``               cold prefix-cache blocks reclaimed (``data['n']``)
``oom-fence``           dispatcher fenced the instance after a real OOM
``handoff-start``       prefill finished on a prefill-role instance; its KV
                        snapshot is leaving (``data['to']`` = decode target,
                        ``['n_blocks']``/``['n_bytes']`` = transfer size)
``handoff-complete``    the decode target adopted the request
                        (``data['src']``, ``['cached']`` = prefix blocks
                        served from the target's cache instead of the wire)
``scale-up``            autoscaler minted an instance (``data['n']`` = fleet
                        size after; ``data['role']`` on role-typed clusters)
``scale-down``          autoscaler retired an instance (same ``data``)
``finish``              request completed (``data['out']`` = output tokens)
``fault-injected``      a planned :class:`~repro_torch.serving.faults.FaultSpec`
                        fired (``data['fault']`` = crash/straggle/oom/
                        transfer, ``['step']`` = instance iteration index)
``failure-detected``    recovery declared an instance dead or straggling
                        (``data['reason']``, ``['n_lost']`` = in-flight
                        requests to reconstruct on a crash)
``recovery-replay``     a lost request was reconstructed: re-queued with
                        prompt + already-emitted tokens (``data['replayed']``
                        = tokens to re-emit verbatim, ``['retry']``)
``handoff-strand``      a prefill-complete request found no decode capacity
                        and will decode colocated (``data['attempts']``,
                        ``['permanent']`` once the retry cap is spent)
``shed``                the overload valve dropped a request judged unable
                        to meet its deadline (``data['slack']``,
                        ``['queued']`` = balancer depth at shed time)
======================  =====================================================
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, NamedTuple, Optional

EVENT_KINDS = (
    "submit", "dispatch", "migrate-candidate", "admit", "prefill-chunk",
    "first-token", "decode", "iteration", "preempt", "evict", "oom-fence",
    "handoff-start", "handoff-complete", "scale-up", "scale-down",
    "finish",
    "fault-injected", "failure-detected", "recovery-replay",
    "handoff-strand", "shed",
)


class Event(NamedTuple):
    """One trace event.  ``instance_id == -1`` marks control-plane events
    (balancer/dispatcher); ``req_id == -1`` marks instance-level events
    with no single owning request (``iteration``, ``oom-fence``)."""
    ts: float
    kind: str
    req_id: int
    instance_id: int
    agent: str
    msg_id: str
    data: dict


@dataclasses.dataclass
class TraceContext:
    """Carried by a :class:`~repro_torch.serving.request.Request` once it enters
    a traced control plane: the workflow trace id (message id), this
    request's span id, and the upstream stage it descends from — enough
    for ``critical_path.py`` to stitch agent stages into a DAG without a
    global side table."""
    trace_id: str
    span_id: int
    parent_name: Optional[str] = None


class _Ring:
    """Fixed-capacity overwrite-oldest event buffer.  Single-writer: an
    append is one slot store + one int increment (GIL-atomic enough that
    concurrent *readers* see a consistent prefix)."""

    __slots__ = ("buf", "n", "cap")

    def __init__(self, cap: int):
        self.buf: List[Optional[Event]] = [None] * cap
        self.n = 0
        self.cap = cap

    def append(self, evt: Event):
        self.buf[self.n % self.cap] = evt
        self.n += 1

    def events(self) -> List[Event]:
        if self.n <= self.cap:
            return [e for e in self.buf[: self.n] if e is not None]
        i = self.n % self.cap
        return [e for e in self.buf[i:] + self.buf[:i] if e is not None]

    @property
    def dropped(self) -> int:
        return max(0, self.n - self.cap)


class Tracer:
    """Per-instance lock-free event rings behind one emit surface.

    ``enabled`` is the call-site guard flag; a :class:`NullTracer`
    (:data:`NULL_TRACER`) keeps it ``False`` so guarded call sites cost
    one branch when tracing is off.  ``clock`` stamps events on the real
    path; the simulator always passes explicit ``ts``.
    """

    enabled: bool = True

    def __init__(self, capacity_per_instance: int = 1 << 16,
                 clock=time.monotonic):
        assert capacity_per_instance > 0
        self.capacity = capacity_per_instance
        self.clock = clock
        self._rings: Dict[int, _Ring] = {}

    # ------------------------------------------------------------------ emit
    def emit(self, kind: str, req_id: int = -1, instance_id: int = -1,
             agent: str = "", msg_id: str = "",
             ts: Optional[float] = None, **data):
        assert kind in EVENT_KINDS, f"unknown event kind {kind!r}"
        ring = self._rings.get(instance_id)
        if ring is None:
            # setdefault: first-emit race between two instance threads
            # can only ever target *different* keys (rings are
            # per-instance single-writer), so this is belt-and-braces
            ring = self._rings.setdefault(instance_id, _Ring(self.capacity))
        ring.append(Event(self.clock() if ts is None else ts, kind,
                          req_id, instance_id, agent, msg_id, data))

    # ----------------------------------------------------------------- views
    def events(self, instance_id: Optional[int] = None) -> List[Event]:
        """Events oldest-first; merged across rings (stable sort by
        timestamp) unless one instance is requested."""
        if instance_id is not None:
            ring = self._rings.get(instance_id)
            return ring.events() if ring is not None else []
        out: List[Event] = []
        for ring in self._rings.values():
            out.extend(ring.events())
        out.sort(key=lambda e: e.ts)
        return out

    def instance_ids(self) -> List[int]:
        return sorted(self._rings)

    def dropped(self) -> int:
        """Events that rolled off a full ring (exporters should surface
        a non-zero value as truncation, never pretend completeness)."""
        return sum(r.dropped for r in self._rings.values())

    def clear(self):
        self._rings.clear()

    def __len__(self) -> int:
        return sum(min(r.n, r.cap) for r in self._rings.values())


class NullTracer(Tracer):
    """The disabled singleton: ``enabled`` False, ``emit`` a no-op.
    Call sites hold this by default, so un-traced runs execute one
    attribute load + branch per would-be event."""

    enabled = False

    def __init__(self):
        super().__init__(capacity_per_instance=1)

    def emit(self, *a, **kw):  # pragma: no cover - trivially nothing
        pass


NULL_TRACER = NullTracer()
