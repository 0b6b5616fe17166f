"""Deterministic fault injection: the chaos half of the fault plane.

Kairos serves from the *public cloud* (§2), where instances stall, OOM,
and die mid-decode.  This module turns those failure modes into a
seeded, replayable :class:`FaultPlan`: a list of :class:`FaultSpec`
events pinned to **(instance, per-instance iteration ordinal)** points,
so the same plan fires at the same logical moment in the real
:class:`~repro_torch.serving.cluster.ServingCluster` and in the discrete-event
:class:`~repro_torch.sim.simulator.Simulation` — and twice in a row in either.

Fault kinds:

``crash``     the instance dies mid-``dispatch_iteration`` (an exception
              out of the dispatch).  Scheduler state may be half-mutated;
              the pool is untrusted.  Recovery (``recovery.py``) must reconstruct
              every in-flight request from prompt + already-emitted
              tokens.
``straggle``  one step runs slow: the real path sleeps ``delay_s`` inside
              the dispatch, the sim multiplies the step's ``dt`` by
              ``factor``.  Step-deadline detection fences the instance.
``oom``       a forced allocation-pressure signal: ``recent_oom`` is set
              so the existing ``poll_oom`` -> dispatcher fence path fires
              without any real allocation failing.  Plans can emit runs
              of consecutive ooms (a "storm").
``transfer``  the Nth KV transfer *out of* an instance fails after the
              target has allocated (the worst point): ``migrate_many`` /
              ``handoff`` must refuse losslessly (satellite: rollback).

A :class:`FaultInjector` consumes one plan for one run; it owns the
per-instance ordinal counters so engines and sim instances only need to
call :meth:`FaultInjector.on_dispatch` / :meth:`transfer_fault`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.obs.trace import NULL_TRACER, Tracer

FAULT_KINDS = ("crash", "straggle", "oom", "transfer")


class InstanceCrashed(RuntimeError):
    """An injected (or real) worker death surfaced from
    ``dispatch_iteration``.  The cluster's step loop catches this and
    hands the engine to :class:`~repro_torch.serving.recovery.RecoveryManager`."""

    def __init__(self, instance_id: int, step: int):
        super().__init__(
            f"instance {instance_id} crashed at iteration {step}")
        self.instance_id = instance_id
        self.step = step


class TransferFault(RuntimeError):
    """An injected KV-transfer failure.  Raised *inside* the guarded
    region of ``migrate_many``/``restore_request`` — i.e. after target
    allocation — so the rollback path is what gets exercised."""

    def __init__(self, source_id: int, ordinal: int):
        super().__init__(
            f"transfer {ordinal} out of instance {source_id} failed")
        self.source_id = source_id
        self.ordinal = ordinal


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One planned fault.  ``step`` is the per-instance *dispatch ordinal*
    (0-based count of composed iterations) for crash/straggle/oom, and
    the per-instance *outbound-transfer ordinal* for transfer faults —
    both deterministic under deterministic scheduling, which is what
    makes a plan replayable."""
    kind: str
    instance_id: int
    step: int
    delay_s: float = 0.0    # straggle: real-path sleep inside the dispatch
    factor: float = 1.0     # straggle: sim step-time multiplier

    def __post_init__(self):
        assert self.kind in FAULT_KINDS, f"unknown fault kind {self.kind!r}"
        assert self.step >= 0


@dataclasses.dataclass(frozen=True)
class DispatchEffects:
    """What :meth:`FaultInjector.on_dispatch` resolved for one iteration.
    The caller applies them (the injector stays side-effect-free towards
    engine state): set ``recent_oom``, sleep/stretch, then raise
    :class:`InstanceCrashed` last so the other effects land first."""
    crash: Optional[FaultSpec] = None
    delay_s: float = 0.0
    factor: float = 1.0
    oom: bool = False


_NO_EFFECTS = DispatchEffects()


class FaultPlan:
    """An immutable, ordered set of :class:`FaultSpec`\\ s.

    Either hand-built (``FaultPlan([FaultSpec(...), ...])``) for targeted
    tests, or sampled with :meth:`generate` from a seed — the generator
    is pure ``numpy.random.default_rng(seed)``, so a (seed, shape) pair
    names the same chaos everywhere.
    """

    def __init__(self, specs: Sequence[FaultSpec] = ()):
        self.specs: Tuple[FaultSpec, ...] = tuple(specs)
        for s in self.specs:
            assert isinstance(s, FaultSpec)

    def __len__(self) -> int:
        return len(self.specs)

    def __iter__(self):
        return iter(self.specs)

    def crashes(self) -> List[FaultSpec]:
        return [s for s in self.specs if s.kind == "crash"]

    @classmethod
    def generate(cls, seed: int, instance_ids: Sequence[int], *,
                 horizon: int = 32,
                 n_crashes: int = 1,
                 n_straggles: int = 0,
                 n_ooms: int = 0,
                 n_transfer_faults: int = 0,
                 spare: Sequence[int] = (),
                 straggle_delay_s: float = 0.05,
                 straggle_factor: float = 4.0) -> "FaultPlan":
        """Sample a plan.  ``spare`` instances are exempt from crashes
        (a chaos drain that kills *every* instance has no survivors to
        recover onto); stragglers/ooms/transfer faults may hit anyone.
        At most one crash per instance — dead instances don't die twice.
        """
        rng = np.random.default_rng(seed)
        ids = list(instance_ids)
        crashable = [i for i in ids if i not in set(spare)]
        specs: List[FaultSpec] = []
        n_crashes = min(n_crashes, len(crashable))
        victims = rng.choice(len(crashable), size=n_crashes,
                             replace=False) if n_crashes else []
        for v in victims:
            specs.append(FaultSpec("crash", crashable[int(v)],
                                   int(rng.integers(1, max(2, horizon)))))
        for _ in range(n_straggles):
            specs.append(FaultSpec("straggle", ids[int(rng.integers(len(ids)))],
                                   int(rng.integers(0, max(1, horizon))),
                                   delay_s=straggle_delay_s,
                                   factor=straggle_factor))
        for _ in range(n_ooms):
            specs.append(FaultSpec("oom", ids[int(rng.integers(len(ids)))],
                                   int(rng.integers(0, max(1, horizon)))))
        for _ in range(n_transfer_faults):
            specs.append(FaultSpec("transfer",
                                   ids[int(rng.integers(len(ids)))],
                                   int(rng.integers(0, 4))))
        return cls(specs)


class FaultInjector:
    """Consumes one :class:`FaultPlan` over one run.

    Owns the deterministic per-instance ordinal counters so call sites
    stay one-liners.  A fresh injector over the same plan replays the
    same faults — construct one per run, never share across runs.
    """

    def __init__(self, plan: FaultPlan, tracer: Tracer = NULL_TRACER):
        self.plan = plan
        self.tracer = tracer
        self._dispatch_ord: Dict[int, int] = {}
        self._transfer_ord: Dict[int, int] = {}
        # (kind, instance, step) -> list of yet-unfired specs
        self._pending: Dict[Tuple[str, int, int], List[FaultSpec]] = {}
        for s in plan:
            self._pending.setdefault(
                (s.kind, s.instance_id, s.step), []).append(s)
        self.n_fired = 0

    # ------------------------------------------------------------ helpers
    def _take(self, kind: str, instance_id: int, step: int,
              now: Optional[float]) -> List[FaultSpec]:
        fired = self._pending.pop((kind, instance_id, step), [])
        for s in fired:
            self.n_fired += 1
            if self.tracer.enabled:
                self.tracer.emit("fault-injected", instance_id=instance_id,
                                 ts=now, fault=s.kind, step=s.step)
        return fired

    # ----------------------------------------------------------- surfaces
    def on_dispatch(self, instance_id: int,
                    now: Optional[float] = None) -> DispatchEffects:
        """Advance this instance's dispatch ordinal and resolve any
        faults planned for it.  Called once per *composed* iteration
        (idle steps don't count — they don't exist in the sim)."""
        step = self._dispatch_ord.get(instance_id, 0)
        self._dispatch_ord[instance_id] = step + 1
        if not self._pending:
            return _NO_EFFECTS
        crash = self._take("crash", instance_id, step, now)
        straggles = self._take("straggle", instance_id, step, now)
        ooms = self._take("oom", instance_id, step, now)
        if not (crash or straggles or ooms):
            return _NO_EFFECTS
        return DispatchEffects(
            crash=crash[0] if crash else None,
            delay_s=sum(s.delay_s for s in straggles),
            factor=float(np.prod([s.factor for s in straggles]))
            if straggles else 1.0,
            oom=bool(ooms))

    def transfer_fault(self, source_id: int,
                       now: Optional[float] = None) -> Optional[FaultSpec]:
        """Advance the outbound-transfer ordinal for ``source_id`` and
        return the planned fault, if any.  The *caller* raises
        :class:`TransferFault` from inside its guarded region."""
        ordinal = self._transfer_ord.get(source_id, 0)
        self._transfer_ord[source_id] = ordinal + 1
        fired = self._take("transfer", source_id, ordinal, now)
        return fired[0] if fired else None
