"""Elastic autoscaling: queue-depth / KV-pressure driven instance count.

Public-cloud serving pays per instance-second, so the paper's excess-load
story has a cost axis: a fixed fleet sized for the burst idles between
bursts, one sized for the trough melts under them (§2).  The
:class:`Autoscaler` closes that loop — it watches two pressure signals

* **queue depth** per instance at the load balancer (work the dispatcher
  could not place), and
* **KV pressure**: each instance's hard-used block fraction (parked
  prefix-cache blocks excluded — they are reclaimable, not pressure),

and adds instances when either stays high, retires one when both stay
low.  Retirement is *lossless*: :meth:`ServingCluster.scale_down` drains
the victim through live migration (``serving/migration.py``), so
scale-down never discards computed KV or generated tokens.  Victim
choice prefers OOM-fenced instances — the dispatcher is already routing
around them, so they are the cheapest capacity to give back (this turns
the long-standing ``migrate-candidate`` trace breadcrumb into real
decisions).

Hysteresis is everywhere, because elasticity that flaps is worse than no
elasticity: up/down each need ``*_patience`` consecutive pressured
decision windows, decisions are rate-limited to ``decision_period_s``,
and any action starts a ``cooldown_s`` freeze.

The decision core (:meth:`Autoscaler.decide`) is pure — it consumes a
:class:`ClusterSignals` value and returns an action — so the real
cluster and the discrete-event simulator share one policy:
:func:`signals_from_cluster` adapts a :class:`ServingCluster`, the
simulator builds its signals from :class:`SimInstance` state.

Role-typed clusters (prefill/decode disaggregation) scale **each role
pool independently**: every decision tick evaluates one
:class:`ClusterSignals` per role, built from that role's instances and
the slice of the balancer queue its role can actually serve
(:func:`repro_torch.core.dispatcher.role_accepts`) — a decode backlog never
mints a prefill instance.  Streak counters are per pool; the policy
bounds (``min_instances``/``max_instances``) apply per pool; the
post-action cooldown freeze is global, so one pool's action cannot
immediately trigger another's.  A flat cluster is one ``general`` pool
and behaves exactly as before.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class AutoscalerConfig:
    """Scaling policy knobs.  Thresholds are per-instance averages
    (queue) / per-instance maxima (KV), so they are fleet-size
    invariant."""
    min_instances: int = 1
    max_instances: int = 4
    queue_high: float = 4.0     # queued-per-instance that signals "add"
    queue_low: float = 0.5      # queued-per-instance that allows "retire"
    kv_high: float = 0.85       # any instance's hard-used block fraction
    kv_low: float = 0.50        # every instance's hard-used block fraction
    up_patience: int = 2        # consecutive pressured windows before up
    down_patience: int = 6      # consecutive calm windows before down
    decision_period_s: float = 0.25
    cooldown_s: float = 1.0     # freeze after any action

    def __post_init__(self):
        assert 1 <= self.min_instances <= self.max_instances
        assert self.queue_low <= self.queue_high
        assert 0.0 < self.kv_low <= self.kv_high <= 1.0
        assert self.up_patience >= 1 and self.down_patience >= 1


@dataclasses.dataclass
class InstanceSignal:
    instance_id: int
    kv_used_frac: float   # hard-used blocks / total blocks
    fenced: bool          # inside its post-OOM dispatch fence
    load: float           # running + waiting requests on the instance


@dataclasses.dataclass
class ClusterSignals:
    now: float
    queue_depth: int      # balancer queue (undispatched work)
    instances: List[InstanceSignal]

    @property
    def n_instances(self) -> int:
        return len(self.instances)


def signals_from_cluster(cluster, now: float,
                         role: Optional[str] = None) -> ClusterSignals:
    """Adapt a live :class:`ServingCluster` to the decision core's
    input.  Reads control-plane state only — no device sync.

    With ``role`` set, the signals are role-split: only that role's
    instances are sampled, and queue depth counts only the queued
    requests the role could serve (``role_accepts``), so each pool
    scales from the pressure it is responsible for."""
    from repro_torch.core.dispatcher import role_accepts
    inst = []
    for e in cluster.engines:
        if role is not None and e.role != role:
            continue
        inst.append(InstanceSignal(
            instance_id=e.instance_id,
            kv_used_frac=e.bm.hard_used_blocks / e.bm.num_blocks,
            fenced=cluster.dispatcher.is_fenced(e.instance_id, now),
            load=len(e.sched.running) + len(e.sched.waiting)))
    if role is None:
        depth = len(cluster.balancer.queue)
    else:
        depth = sum(1 for r in cluster.balancer.queue if role_accepts(role, r))
    return ClusterSignals(now=now, queue_depth=depth, instances=inst)


class Autoscaler:
    """Stateful wrapper around the pure decision core.

    ``step(cluster, now)`` is called by the cluster at the start of every
    step (see :meth:`ServingCluster.attach_autoscaler`); it samples
    signals, decides, and applies scale_up/scale_down.  Returns any
    requests finished by a scale-down's final collect so the cluster's
    step can surface them.  ``history`` records every action as
    ``(t, "up"|"down", instance_id, n_instances_after)`` for tests and
    benchmark reports.
    """

    def __init__(self, config: AutoscalerConfig = AutoscalerConfig()):
        self.cfg = config
        self._up_streaks: Dict[str, int] = {}
        self._down_streaks: Dict[str, int] = {}
        self._next_decision = float("-inf")
        self._frozen_until = float("-inf")
        self.history: List[Tuple[float, str, int, int]] = []

    # ------------------------------------------------------------- decision
    def decide(self, sig: ClusterSignals,
               role: str = "general") -> Optional[Tuple[str, int]]:
        """Pure policy: ``("up", -1)``, ``("down", victim_id)``, or None.

        Call once per decision window per role pool (the caller owns the
        cadence and passes role-split signals); the per-pool streak
        counters live here so both the real and simulated control planes
        get identical hysteresis.  Flat callers omit ``role`` and get the
        single ``general`` pool."""
        cfg = self.cfg
        n = sig.n_instances
        queue_per_inst = sig.queue_depth / max(1, n)
        kv_max = max((i.kv_used_frac for i in sig.instances), default=0.0)
        pressured = (queue_per_inst >= cfg.queue_high
                     or kv_max >= cfg.kv_high)
        calm = (queue_per_inst <= cfg.queue_low and kv_max <= cfg.kv_low)
        self._up_streaks[role] = \
            self._up_streaks.get(role, 0) + 1 if pressured else 0
        self._down_streaks[role] = \
            self._down_streaks.get(role, 0) + 1 if calm else 0
        if sig.now < self._frozen_until:
            return None
        if (pressured and n < cfg.max_instances
                and self._up_streaks[role] >= cfg.up_patience):
            return ("up", -1)
        if (calm and n > cfg.min_instances
                and self._down_streaks[role] >= cfg.down_patience):
            return ("down", self.pick_victim(sig))
        return None

    @staticmethod
    def pick_victim(sig: ClusterSignals) -> int:
        """Scale-down victim: OOM-fenced first (the dispatcher already
        routes around them), then least loaded — fewest requests to
        migrate, fewest KV bytes to move."""
        return min(sig.instances,
                   key=lambda i: (not i.fenced, i.load, i.kv_used_frac,
                                  i.instance_id)).instance_id

    # ------------------------------------------------------------ real path
    @staticmethod
    def role_pools(cluster) -> List[str]:
        """The role pools to scale, in step order.  A flat cluster is
        the single ``general`` pool."""
        roles = {e.role for e in cluster.engines}
        return [r for r in ("prefill", "decode", "general")
                if r in roles] or ["general"]

    def step(self, cluster, now: float) -> list:
        """One control-plane tick against a real cluster: each role pool
        decides from its own signals.  The global cooldown means at most
        one pool acts per tick."""
        if now < self._next_decision:
            return []
        self._next_decision = now + self.cfg.decision_period_s
        pools = self.role_pools(cluster)
        split = pools != ["general"]   # role-typed topology present
        finished: list = []
        for role in pools:
            sig = signals_from_cluster(cluster, now,
                                       role=role if split else None)
            action = self.decide(sig, role=role)
            if action is None:
                continue
            kind, victim = action
            if kind == "up":
                iid = cluster.scale_up(now=now,
                                       role=role if split else None)
                self.history.append((now, "up", iid, cluster.n_instances))
            else:
                finished.extend(cluster.scale_down(victim, now))
                self.history.append((now, "down", victim,
                                     cluster.n_instances))
            self._frozen_until = now + self.cfg.cooldown_s
            self._up_streaks.clear()
            self._down_streaks.clear()
        return finished

    def note_action(self, now: float, kind: str, instance_id: int,
                    n_after: int):
        """Record an externally-applied action (the simulator applies
        decisions itself) and start the cooldown, keeping hysteresis
        identical across both control planes."""
        self.history.append((now, kind, instance_id, n_after))
        self._frozen_until = now + self.cfg.cooldown_s
        self._up_streaks.clear()
        self._down_streaks.clear()
