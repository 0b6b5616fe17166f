"""Load balancer: the queue where scheduling policy × dispatch policy meet
(Kairos Fig. 10 ①–③).  Shared verbatim by the real-engine harness and the
discrete-event simulator — only the instance objects differ.
"""
from __future__ import annotations

from typing import Callable, List

from repro_torch.core.orchestrator import Orchestrator
from repro_torch.core.scheduler import SchedulerPolicy
from repro_torch.obs.trace import NULL_TRACER, Tracer
from repro_torch.serving.request import Request, RequestState


class LoadBalancer:
    def __init__(self, scheduler: SchedulerPolicy, dispatcher,
                 orchestrator: Orchestrator,
                 submit_fn: Callable[[int, Request], None],
                 max_dispatch_per_tick: int = 64,
                 strict_head: bool = False,
                 tracer: Tracer = NULL_TRACER):
        self.scheduler = scheduler
        self.dispatcher = dispatcher
        self.orch = orchestrator
        self.submit_fn = submit_fn
        self.queue: List[Request] = []
        self.max_dispatch_per_tick = max_dispatch_per_tick
        # strict_head: FCFS/vLLM semantics — the head of the ordered queue
        # blocks everything behind it (Parrot/Ayo).  Kairos instead skips
        # undispatchable requests ("remains in the queue awaiting the next
        # scheduling round", §6), which avoids dispatch-level HoL.
        self.strict_head = strict_head
        self.tracer = tracer
        self.n_scheduled = 0

    def enqueue(self, req: Request):
        req.state = RequestState.QUEUED
        self.queue.append(req)
        if self.tracer.enabled:
            self.tracer.emit("submit", req_id=req.req_id,
                             agent=req.agent_name, msg_id=req.msg_id,
                             ts=req.arrival_time,
                             upstream=req.upstream_name)

    def tick(self, now: float):
        """One scheduling round: order queue by policy (§5), dispatch in
        order with memory awareness (§6).  Requests the dispatcher rejects
        stay queued for the next round."""
        if not self.queue:
            return
        ordered = self.scheduler.order(self.queue)
        dispatched = []
        for req in ordered[: self.max_dispatch_per_tick * 4]:
            ramp = self.orch.memory_ramp(req, now)
            # starvation valve: a request stuck for a long time is force-
            # placed on the min-peak instance (engine preemption absorbs it)
            force = (now - req.arrival_time) > 30.0
            iid = self.dispatcher.dispatch(req, ramp, now, force=force)
            if iid is None:
                if self.strict_head:
                    break
                continue
            if self.tracer.enabled:
                if force:
                    self.tracer.emit("migrate-candidate", req_id=req.req_id,
                                     agent=req.agent_name, msg_id=req.msg_id,
                                     ts=now, waited=now - req.arrival_time,
                                     to=iid)
                self.tracer.emit("dispatch", req_id=req.req_id,
                                 agent=req.agent_name, msg_id=req.msg_id,
                                 ts=now, to=iid)
            self.submit_fn(iid, req)
            dispatched.append(req)
            self.n_scheduled += 1
            if len(dispatched) >= self.max_dispatch_per_tick:
                break
        if dispatched:
            gone = {r.req_id for r in dispatched}
            self.queue = [r for r in self.queue if r.req_id not in gone]

    @property
    def queued(self) -> int:
        return len(self.queue)
