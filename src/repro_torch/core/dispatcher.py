"""Memory-aware time-slot dispatcher (§6) + baselines.

The future timeline is discretized into fixed 0.5 s slots.  Each instance
accumulates the expected KV usage of its in-flight ramps per slot
(Eq. 3).  A request is dispatchable to an instance iff no spanned slot
exceeds capacity; among feasible instances the one with the lowest
expected total **peak** usage wins.  Adaptive corrections: early
finishers release their future slots immediately; an instance reporting a
real OOM/preemption is fenced for a cooldown.

Every dispatcher implements the same contract —
``dispatch(req, ramp, now, force=False) -> Optional[int]`` plus the
``on_finish`` / ``on_oom`` feedback hooks — so the load balancer calls
them uniformly, with no signature probing.

Role-typed clusters (prefill/decode disaggregation) add one routing
axis: every :class:`InstanceModel` carries its instance's ``role`` and
:func:`role_accepts` gates placement by the request's
:class:`~repro_torch.serving.request.RequestPhase` — new (prefill-phase) work
never lands on a decode instance, decode-phase work never on a prefill
instance.  The gate is a *hard* admission rule, so it holds even under
``force`` (the starvation valve may override memory feasibility, never
the role topology).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.memory_model import MemoryRamp
from repro_torch.obs.trace import NULL_TRACER, Tracer
from repro_torch.serving.request import Request, RequestPhase

SLOT_LEN = 0.5  # seconds (§6: empirically favourable trade-off)


def role_accepts(role: str, req: Request) -> bool:
    """Whether an instance of ``role`` may receive ``req`` in its current
    phase.  General instances take anything; prefill instances take only
    prefill-phase work (their decode capacity exists solely as the
    stranded-handoff fallback); decode instances take only decode-phase
    work (arriving via handoff/migration adopt, never the balancer)."""
    if role == "general":
        return True
    if role == "prefill":
        return req.phase is not RequestPhase.DECODE
    return req.phase is RequestPhase.DECODE


def _slot_usage_matrix(ramps: List[MemoryRamp], slot_starts: np.ndarray,
                       slot_len: float) -> np.ndarray:
    """Vectorized Eq. 3: (n_ramps, n_slots) expected usage (ramp max in slot)."""
    if not ramps:
        return np.zeros((0, len(slot_starts)))
    p = np.array([r.p_tokens for r in ramps])[:, None]
    k = np.array([r.slope for r in ramps])[:, None]
    t0 = np.array([r.t_start for r in ramps])[:, None]
    t1 = np.array([r.t_end for r in ramps])[:, None]
    s0 = slot_starts[None, :]
    s1 = s0 + slot_len
    active = (s1 > t0) & (s0 < t1)
    usage = p + k * (np.minimum(s1, t1) - t0)
    return np.where(active, usage, 0.0)


@dataclasses.dataclass
class InstanceModel:
    """Dispatcher-side view of one LLM instance."""
    instance_id: int
    capacity_tokens: float
    ramps: Dict[int, MemoryRamp] = dataclasses.field(default_factory=dict)
    fenced_until: float = -1.0
    role: str = "general"          # disaggregation role (see role_accepts)

    def current_usage(self, now: float) -> float:
        return sum(r.usage(now) for r in self.ramps.values())

    def gc(self, now: float):
        dead = [k for k, r in self.ramps.items() if r.t_end <= now]
        for k in dead:
            del self.ramps[k]


class TimeSlotDispatcher:
    name = "kairos"

    def __init__(self, instances: List[InstanceModel], slot_len: float = SLOT_LEN,
                 oom_cooldown: float = 2.0, admit_probe=None,
                 tracer: Tracer = NULL_TRACER):
        self.instances = {i.instance_id: i for i in instances}
        self.slot_len = slot_len
        self.oom_cooldown = oom_cooldown
        self.admit_probe = admit_probe
        self.tracer = tracer
        self.n_rejected = 0
        # per-round occupancy cache: recomputed when `now` changes, updated
        # in place on accept — keeps a scheduling round at O(ramps) total.
        self._cache_now: float = float("nan")
        self._slot_starts: Optional[np.ndarray] = None
        self._occ: Dict[int, np.ndarray] = {}

    # --------------------------------------------------------------- elasticity
    def add_instance(self, inst: InstanceModel):
        """Autoscaler scale-up: start routing to a new instance."""
        assert inst.instance_id not in self.instances
        self.instances[inst.instance_id] = inst
        self._cache_now = float("nan")

    def remove_instance(self, instance_id: int) -> InstanceModel:
        """Autoscaler scale-down: stop routing to an instance.  Returns
        the popped model so the cluster can re-home surviving ramps via
        :meth:`adopt_ramp`.  Any OOM fence dies with the model — a later
        ``add_instance`` under the same id starts unfenced (the
        scale-down-while-fenced regression test pins this)."""
        inst = self.instances.pop(instance_id)
        self._occ.pop(instance_id, None)
        self._cache_now = float("nan")
        return inst

    def adopt_ramp(self, instance_id: int, req_id: int, ramp):
        """Live migration: re-home one in-flight request's memory ramp to
        its new instance (None ramps — e.g. already expired — are
        dropped)."""
        if ramp is not None:
            self.instances[instance_id].ramps[req_id] = ramp
            self._cache_now = float("nan")

    # ---------------------------------------------------------------- feedback
    def on_finish(self, instance_id: int, req_id: int):
        """Early/normal finish: drop the ramp's future slots (§6 adaptive).
        The instance may have been scaled away since dispatch."""
        inst = self.instances.get(instance_id)
        if inst is not None:
            inst.ramps.pop(req_id, None)
        self._cache_now = float("nan")

    def on_oom(self, instance_id: int, now: float):
        self.instances[instance_id].fenced_until = now + self.oom_cooldown
        self._cache_now = float("nan")
        if self.tracer.enabled:
            self.tracer.emit("oom-fence", instance_id=instance_id, ts=now,
                             until=now + self.oom_cooldown)

    def is_fenced(self, instance_id: int, now: float) -> bool:
        """True while the instance sits in its post-OOM cooldown — the
        cluster runtime and tests introspect fencing through this instead
        of poking at ``InstanceModel.fenced_until``.  An instance that has
        been scaled away is not fenced (its fence died with its model)."""
        inst = self.instances.get(instance_id)
        return inst is not None and now < inst.fenced_until

    # ---------------------------------------------------------------- internals
    def _refresh_cache(self, now: float, min_end: float):
        horizon_end = min_end
        for inst in self.instances.values():
            inst.gc(now)
            for r in inst.ramps.values():
                horizon_end = max(horizon_end, r.t_end)
        n_slots = min(max(1, int(math.ceil((horizon_end - now) / self.slot_len)) + 1), 4096)
        self._slot_starts = now + np.arange(n_slots) * self.slot_len
        self._occ = {
            iid: _slot_usage_matrix(list(inst.ramps.values()),
                                    self._slot_starts, self.slot_len).sum(0)
            for iid, inst in self.instances.items()}
        self._cache_now = now

    # ---------------------------------------------------------------- dispatch
    def dispatch(self, req: Request, ramp: MemoryRamp, now: float,
                 force: bool = False) -> Optional[int]:
        """Pick an instance; None => stay queued for the next round.
        ``force`` (starvation valve): ignore feasibility, pick min peak —
        the engine's own preemption handles the overflow."""
        if self._cache_now != now or self._slot_starts is None or \
                ramp.t_end > self._slot_starts[-1] + self.slot_len:
            self._refresh_cache(now, ramp.t_end)
        req_slots = _slot_usage_matrix([ramp], self._slot_starts, self.slot_len)[0]

        best_id, best_peak = None, float("inf")
        for iid, inst in self.instances.items():
            if not role_accepts(inst.role, req):
                continue           # hard topology rule, force included
            if now < inst.fenced_until and not force:
                continue
            if (self.admit_probe is not None and not force
                    and not self.admit_probe(iid, req)):
                continue
            total = self._occ[iid] + req_slots
            peak = float(total.max())
            if peak > inst.capacity_tokens and not force:
                continue
            if peak < best_peak:
                best_peak, best_id = peak, iid
        if best_id is None:
            self.n_rejected += 1
            return None
        self.instances[best_id].ramps[req.req_id] = ramp
        self._occ[best_id] = self._occ[best_id] + req_slots
        return best_id


class RoundRobinDispatcher:
    """Parrot / Ayo baseline: memory-oblivious rotation.

    An optional ``admit_probe(iid, req) -> bool`` gates dispatch on the
    engine's *current* admission capacity (batch slot + prompt memory),
    i.e. vLLM semantics — but with no awareness of future memory growth,
    which is exactly the §2.2.3 failure mode."""
    name = "round_robin"

    def __init__(self, instances: List[InstanceModel], admit_probe=None):
        self.instances = {i.instance_id: i for i in instances}
        self._order = sorted(self.instances)
        self._ptr = 0
        self.admit_probe = admit_probe

    def add_instance(self, inst: InstanceModel):
        assert inst.instance_id not in self.instances
        self.instances[inst.instance_id] = inst
        self._order = sorted(self.instances)

    def remove_instance(self, instance_id: int) -> InstanceModel:
        inst = self.instances.pop(instance_id)
        self._order = sorted(self.instances)
        if self._order:
            self._ptr %= len(self._order)
        else:
            self._ptr = 0
        return inst

    def adopt_ramp(self, instance_id: int, req_id: int, ramp):
        if ramp is not None:
            self.instances[instance_id].ramps[req_id] = ramp

    def on_finish(self, instance_id: int, req_id: int):
        inst = self.instances.get(instance_id)
        if inst is not None:
            inst.ramps.pop(req_id, None)

    def on_oom(self, instance_id: int, now: float):
        pass

    def dispatch(self, req: Request, ramp: MemoryRamp, now: float,
                 force: bool = False) -> Optional[int]:
        n = len(self._order)
        for k in range(n):
            iid = self._order[(self._ptr + k) % n]
            if not role_accepts(self.instances[iid].role, req):
                continue
            if force or self.admit_probe is None or self.admit_probe(iid, req):
                self._ptr = (self._ptr + k + 1) % n
                self.instances[iid].ramps[req.req_id] = ramp
                return iid
        return None


class BestFitOracleDispatcher:
    """Motivation §2.2.3 Oracle: knows the true output length; packs to the
    instance with the smallest resulting expected peak (no slot error)."""
    name = "oracle"

    def __init__(self, instances: List[InstanceModel], admit_probe=None):
        self.instances = {i.instance_id: i for i in instances}
        self.admit_probe = admit_probe

    def add_instance(self, inst: InstanceModel):
        assert inst.instance_id not in self.instances
        self.instances[inst.instance_id] = inst

    def remove_instance(self, instance_id: int) -> InstanceModel:
        return self.instances.pop(instance_id)

    def adopt_ramp(self, instance_id: int, req_id: int, ramp):
        if ramp is not None:
            self.instances[instance_id].ramps[req_id] = ramp

    def on_finish(self, instance_id: int, req_id: int):
        inst = self.instances.get(instance_id)
        if inst is not None:
            inst.ramps.pop(req_id, None)

    def on_oom(self, instance_id: int, now: float):
        pass

    def dispatch(self, req: Request, ramp: MemoryRamp, now: float,
                 force: bool = False) -> Optional[int]:
        best_id, best_peak = None, float("inf")
        for inst in self.instances.values():
            inst.gc(now)
            if not role_accepts(inst.role, req):
                continue
            if (self.admit_probe is not None and not force
                    and not self.admit_probe(inst.instance_id, req)):
                continue
            cur = sum(r.peak for r in inst.ramps.values())
            if cur + ramp.peak > inst.capacity_tokens and not force:
                continue
            if cur + ramp.peak < best_peak:
                best_peak, best_id = cur + ramp.peak, inst.instance_id
        if best_id is None:
            return None
        self.instances[best_id].ramps[req.req_id] = ramp
        return best_id
