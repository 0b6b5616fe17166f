"""Request priority scheduling policies (§5 + baselines).

* ``KairosScheduler`` — agent-level priority from the Wasserstein+MDS
  table (§5.1), intra-agent ordering by application-level start time
  (§5.2).
* ``FCFSScheduler`` — Parrot: arrival order at the load balancer.
* ``TopoScheduler`` — Ayo: fewer remaining workflow-topology stages first.
* ``OracleScheduler`` — knows each request's true remaining execution
  time (motivation Fig. 7 / sorting-accuracy upper bound).
"""
from __future__ import annotations

from typing import Callable, List

from repro_torch.serving.request import Request


class SchedulerPolicy:
    """Shared by the load balancer (cluster queue, Fig. 10 ②) and by the
    instance-level :class:`~repro_torch.serving.batch_scheduler.BatchScheduler`
    (waiting-queue order + preemption-victim choice)."""
    name = "base"

    def sort_key(self, req: Request):
        raise NotImplementedError

    def order(self, queue: List[Request]) -> List[Request]:
        return sorted(queue, key=self.sort_key)

    def victim_key(self, req: Request):
        """Preemption picks ``max(running, key=victim_key)``.  Default:
        the latest-arrived request — the classic vLLM recompute victim,
        which has accumulated the least decode progress, so recompute
        wastes the least work.  (Preempting by admission priority instead
        repeatedly kills the most-progressed long-output requests and
        measurably inflates preemption counts.)  Policies may override to
        couple victim choice to their ordering."""
        return (req.arrival_time, req.req_id)


class FCFSScheduler(SchedulerPolicy):
    name = "fcfs"  # Parrot

    def sort_key(self, req: Request):
        return (req.arrival_time, req.req_id)


class TopoScheduler(SchedulerPolicy):
    """Ayo: priority = remaining stage count in the workflow topology."""
    name = "topo"

    def __init__(self, remaining_stages: Callable[[str, str], int]):
        self._stages = remaining_stages

    def sort_key(self, req: Request):
        return (self._stages(req.app_name, req.agent_name),
                req.arrival_time, req.req_id)


class KairosScheduler(SchedulerPolicy):
    name = "kairos"

    def __init__(self, priority_score: Callable[[str, str], float]):
        self._score = priority_score

    def sort_key(self, req: Request):
        # agent-level first (shorter remaining latency first), then
        # application-level start time (earlier == more accumulated delay)
        return (self._score(req.app_name, req.agent_name),
                req.app_start_time, req.req_id)


class OracleScheduler(SchedulerPolicy):
    name = "oracle"

    def __init__(self, true_remaining: Callable[[Request], float]):
        self._rem = true_remaining

    def sort_key(self, req: Request):
        return (self._rem(req), req.req_id)
