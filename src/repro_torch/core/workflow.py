"""Automated online workflow analysis (§4.2).

From completed-request records (grouped by Message ID) Kairos rebuilds the
application call graph using upstream->downstream causal edges, then
classifies each node's multiple outgoing edges as *parallel* or
*sequential* with a sweep-line over the downstream execution time spans.
It also derives the per-agent **remaining end-to-end latency** samples
that drive the priority scheduler (§5).
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.core.distributions import EmpiricalDistribution
from repro_torch.serving.request import CompletionRecord


@dataclasses.dataclass
class EdgeInfo:
    count: int = 0
    parallel: int = 0      # times this edge ran concurrently with a sibling


@dataclasses.dataclass
class WorkflowGraph:
    """Aggregated call graph for one application."""
    nodes: Set[str] = dataclasses.field(default_factory=set)
    edges: Dict[Tuple[str, str], EdgeInfo] = dataclasses.field(
        default_factory=lambda: collections.defaultdict(EdgeInfo))
    roots: collections.Counter = dataclasses.field(default_factory=collections.Counter)

    def downstream(self, agent: str) -> List[str]:
        return [b for (a, b) in self.edges if a == agent]

    def edge_kind(self, a: str, b: str) -> str:
        e = self.edges.get((a, b))
        if e is None or e.count == 0:
            return "unknown"
        return "parallel" if e.parallel * 2 >= e.count else "sequential"

    def remaining_stages(self, agent: str) -> int:
        """Topology depth to a sink (Ayo's priority signal). Longest
        downstream path, cycle-safe."""
        seen: Set[str] = set()

        def depth(n: str) -> int:
            if n in seen:
                return 0
            seen.add(n)
            ds = self.downstream(n)
            d = 1 + max((depth(m) for m in ds), default=0)
            seen.discard(n)
            return d

        return depth(agent) if agent in self.nodes else 1


def _sweepline_parallel(spans: List[Tuple[str, float, float]]) -> Set[str]:
    """Given sibling downstream spans (name, start, end), return names that
    overlap some sibling (= parallel calls).  Classic sweep-line."""
    events = []
    for i, (_, s, e) in enumerate(spans):
        events.append((s, 1, i))   # close (0) before open (1) at the same
        events.append((e, 0, i))   # coordinate: touching spans are sequential
    events.sort()
    active: Set[int] = set()
    parallel: Set[int] = set()
    for _, kind, i in events:
        if kind == 1:              # open
            if active:
                parallel.add(i)
                parallel.update(active)
            active.add(i)
        else:                      # close
            active.discard(i)
    return {spans[i][0] for i in parallel}


class WorkflowAnalyzer:
    """Online call-graph reconstruction + remaining-latency collection."""

    def __init__(self):
        self.graphs: Dict[str, WorkflowGraph] = collections.defaultdict(WorkflowGraph)
        # per (app, agent) remaining end-to-end latency samples
        self.remaining: Dict[Tuple[str, str], EmpiricalDistribution] = \
            collections.defaultdict(EmpiricalDistribution)
        self._traces: Dict[str, List[CompletionRecord]] = collections.defaultdict(list)

    # ------------------------------------------------------------------ intake
    def add_record(self, rec: CompletionRecord):
        self._traces[rec.msg_id].append(rec)

    def finalize_trace(self, msg_id: str):
        """Workflow finished: fold its records into the graph + distributions."""
        recs = self._traces.pop(msg_id, [])
        if not recs:
            return
        app = recs[0].app_name
        g = self.graphs[app]
        by_upstream: Dict[Optional[str], List[CompletionRecord]] = collections.defaultdict(list)
        for r in recs:
            g.nodes.add(r.agent_name)
            by_upstream[r.upstream_name].append(r)
            if r.upstream_name is None:
                g.roots[r.agent_name] += 1
            else:
                g.edges[(r.upstream_name, r.agent_name)].count += 1
            # remaining end-to-end *execution* latency from this stage (§4.3-2):
            # this request's execution plus everything that starts at/after it.
            # Queue-independent, so congestion cannot feed back into the
            # priority signal (DESIGN.md §7 notes this refinement).
            remaining = sum(x.exec_latency for x in recs
                            if x.start_time >= r.start_time)
            self.remaining[(app, r.agent_name)].add(remaining)
        # sweep-line classification of multi-downstream fan-outs (§4.2)
        for up, children in by_upstream.items():
            if up is None or len(children) < 2:
                continue
            spans = [(c.agent_name, c.start_time, c.end_time) for c in children]
            for name in _sweepline_parallel(spans):
                g.edges[(up, name)].parallel += 1

    # ------------------------------------------------------------------ queries
    def remaining_samples(self, app: str, agent: str) -> List[float]:
        return self.remaining[(app, agent)].samples

    def agent_keys(self) -> List[Tuple[str, str]]:
        return [k for k, v in self.remaining.items() if len(v)]

    def remaining_stages(self, app: str, agent: str) -> int:
        return self.graphs[app].remaining_stages(agent)
