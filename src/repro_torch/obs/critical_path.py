"""Workflow critical-path analysis from agent-stage spans.

The paper's Fig. 3 agent profiles — how much of a workflow's latency is
queuing vs LLM execution per stage — were assumed inputs; this module
*measures* them.  Stage spans (one per LLM request) are stitched into a
per-workflow DAG by upstream links, and the critical path is walked back
from the last-finishing stage: at each hop the predecessor is the
upstream stage whose finish is latest among those that causally precede
this stage's arrival.  Each stage on the path decomposes into

* ``queue``    — stage arrival -> LLM execution start (balancer queue +
  instance waiting queue + any re-queueing after preemption),
* ``prefill``  — execution start -> first generated token (TTFT minus
  queueing),
* ``decode``   — first token -> finish,
* ``orch``     — predecessor finish -> this stage's arrival (agent-local
  compute + message-bus hop: the orchestration gap).

Spans come from either trace events (:func:`spans_from_events` — the
tracer's ``submit``/``admit``/``first-token``/``finish`` kinds) or
directly from finished :class:`~repro_torch.serving.request.Request` objects
(:func:`spans_from_requests`), so the same analysis runs on the real
cluster, the simulator, and stored traces.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional

from repro_torch.obs.trace import Event


@dataclasses.dataclass
class StageSpan:
    """One agent stage (one LLM request) of a workflow trace."""
    name: str                     # agent name
    msg_id: str                   # workflow trace id
    upstream: Optional[str]       # upstream agent name (None = entry stage)
    arrival: float                # arrival at the LLM service (stage start)
    exec_start: float = -1.0      # LLM execution start (admission)
    first_token: float = -1.0     # first generated token computed
    finish: float = -1.0          # request completed
    req_id: int = -1

    # ------------------------------------------------------------ breakdown
    @property
    def queue(self) -> float:
        return max(self.exec_start - self.arrival, 0.0) \
            if self.exec_start >= 0 else 0.0

    @property
    def prefill(self) -> float:
        if self.first_token < 0 or self.exec_start < 0:
            return 0.0
        return max(self.first_token - self.exec_start, 0.0)

    @property
    def decode(self) -> float:
        if self.finish < 0:
            return 0.0
        t0 = self.first_token if self.first_token >= 0 else self.exec_start
        return max(self.finish - t0, 0.0) if t0 >= 0 else 0.0

    @property
    def total(self) -> float:
        return max(self.finish - self.arrival, 0.0) if self.finish >= 0 else 0.0


def spans_from_requests(requests: Iterable) -> List[StageSpan]:
    return [StageSpan(name=r.agent_name, msg_id=r.msg_id,
                      upstream=r.upstream_name, arrival=r.arrival_time,
                      exec_start=r.exec_start_time,
                      first_token=getattr(r, "first_token_time", -1.0),
                      finish=r.finish_time, req_id=r.req_id)
            for r in requests if getattr(r, "finish_time", -1.0) >= 0]


def spans_from_events(events: Iterable[Event]) -> List[StageSpan]:
    """Rebuild stage spans from a trace-event stream.  ``submit`` opens a
    span; ``admit``/``first-token``/``finish`` fill it in.  A request
    preempted and re-admitted keeps its *first* admit as execution start
    (matching ``Request.exec_start_time``); its recompute cost shows up
    as inflated prefill/decode, which is exactly the truth."""
    spans: Dict[int, StageSpan] = {}
    for e in events:
        if e.req_id < 0:
            continue
        if e.kind == "submit":
            spans[e.req_id] = StageSpan(
                name=e.agent, msg_id=e.msg_id,
                upstream=e.data.get("upstream"), arrival=e.ts,
                req_id=e.req_id)
            continue
        s = spans.get(e.req_id)
        if s is None:
            # stream truncated (ring overwrote the submit): open a span
            # at this event so downstream stitching still works
            s = spans[e.req_id] = StageSpan(
                name=e.agent, msg_id=e.msg_id,
                upstream=e.data.get("upstream"), arrival=e.ts,
                req_id=e.req_id)
        if e.kind == "admit" and s.exec_start < 0:
            s.exec_start = e.ts
        elif e.kind == "first-token":
            s.first_token = e.ts   # last wins: preemption recomputes it
        elif e.kind == "finish":
            s.finish = e.ts
    return [s for s in spans.values() if s.finish >= 0]


@dataclasses.dataclass
class CriticalPath:
    """The longest causal chain of one workflow, entry -> last finisher."""
    msg_id: str
    stages: List[StageSpan]
    gaps: List[float]             # gaps[i] = orchestration gap BEFORE stage i

    @property
    def total(self) -> float:
        if not self.stages:
            return 0.0
        return self.stages[-1].finish - (self.stages[0].arrival - self.gaps[0])

    def breakdown(self) -> Dict[str, float]:
        """Path-wide per-category seconds; sums to ~``total``."""
        return {
            "queue": sum(s.queue for s in self.stages),
            "prefill": sum(s.prefill for s in self.stages),
            "decode": sum(s.decode for s in self.stages),
            "orch": sum(self.gaps),
            "total": self.total,
        }

    def stage_rows(self) -> List[Dict[str, float]]:
        return [{"agent": s.name, "queue": s.queue, "prefill": s.prefill,
                 "decode": s.decode, "orch": g, "total": s.total + g}
                for s, g in zip(self.stages, self.gaps)]


def critical_path(spans: Iterable[StageSpan],
                  msg_id: Optional[str] = None) -> CriticalPath:
    """Critical path of one workflow's stage spans.

    With ``msg_id`` None the spans must all share one workflow.  The walk
    starts at the stage with the latest finish and repeatedly moves to
    the causal predecessor: the span named ``upstream`` whose finish is
    <= this stage's arrival (small float slack), latest such finish
    winning — i.e. the dependency that actually gated this stage's
    start.  Fan-ins (several upstreams with the same name) resolve to
    the latest gating one, fan-outs resolve by walking only the chain
    that ends last, which is the definition of the critical path."""
    eps = 1e-9
    pool = [s for s in spans if msg_id is None or s.msg_id == msg_id]
    if not pool:
        return CriticalPath(msg_id or "", [], [])
    assert len({s.msg_id for s in pool}) == 1, \
        "critical_path expects stages of a single workflow (pass msg_id)"
    cur = max(pool, key=lambda s: s.finish)
    chain = [cur]
    while cur.upstream is not None:
        cands = [s for s in pool
                 if s.name == cur.upstream and s.finish <= cur.arrival + eps
                 and s is not cur]
        if not cands:
            # dangling upstream (trace truncation or a failed stage):
            # close the path here rather than fabricate a predecessor
            break
        cur = max(cands, key=lambda s: s.finish)
        chain.append(cur)
    chain.reverse()
    gaps = [0.0] + [max(chain[i].arrival - chain[i - 1].finish, 0.0)
                    for i in range(1, len(chain))]
    return CriticalPath(chain[0].msg_id, chain, gaps)


def stage_breakdown(spans: Iterable[StageSpan]) -> Dict[str, Dict[str, float]]:
    """Flat per-category stats over ALL spans (not just the critical
    path): mean and p99 of queue / prefill / decode seconds — the
    FCFS-vs-Kairos decomposition ``benchmarks/latency_breakdown.py``
    reports."""
    from repro_torch.obs.slo import percentile
    spans = list(spans)
    out: Dict[str, Dict[str, float]] = {}
    for cat in ("queue", "prefill", "decode", "total"):
        xs = [getattr(s, cat) for s in spans]
        out[cat] = {"mean": sum(xs) / len(xs) if xs else 0.0,
                    "p99": percentile(xs, 99) if xs else 0.0}
    return out
