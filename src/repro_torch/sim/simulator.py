"""Discrete-event cluster simulator.

Reproduces the paper's end-to-end experiments (Figs 14–18) at production
scale.  **Every scheduling/dispatching decision is made by the production
Kairos code** (`repro_torch.core.*` — orchestrator, Wasserstein+MDS priorities,
time-slot dispatcher, baselines); only LLM execution is replaced by the
calibrated iteration cost model and sampled output lengths.  Instances
run real continuous batching with the real `BlockManager`, including
preemption-by-recompute.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import math
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import (
    BestFitOracleDispatcher,
    FCFSScheduler,
    InstanceModel,
    KairosScheduler,
    LoadBalancer,
    Orchestrator,
    OracleScheduler,
    RoundRobinDispatcher,
    SchedulerPolicy,
    TimeSlotDispatcher,
    TopoScheduler,
)
from repro_torch.core.dispatcher import role_accepts
from repro_torch.core.orchestrator import HardwareProfile
from repro_torch.obs.trace import NULL_TRACER, Tracer
from repro_torch.serving.autoscaler import (
    Autoscaler,
    AutoscalerConfig,
    ClusterSignals,
    InstanceSignal,
)
from repro_torch.serving.batch_scheduler import (
    TABLE_BUCKET_FLOOR,
    BatchScheduler,
    KeyPrefixMatcher,
    pad_bucket,
)
from repro_torch.serving.config import ServingConfig
from repro_torch.serving.faults import FaultInjector, FaultPlan, InstanceCrashed
from repro_torch.serving.kv_cache import BlockManager
from repro_torch.serving.prefix_cache import PrefixCache
from repro_torch.serving.recovery import LoadShedder, RecoveryManager
from repro_torch.serving.request import CompletionRecord, Request, reset_request_ids
from repro_torch.sim.cost_model import LLAMA3_8B, CostModel
from repro_torch.sim.workload import AppSpec, arrival_times

AGENT_OVERHEAD = 0.02       # local (non-LLM) agent compute between stages (s)
BALANCER_PERIOD = 0.05      # retry period when requests sit in the queue (s)


# =============================================================================
# simulated instance (continuous batching at iteration granularity)
# =============================================================================


class SimInstance:
    """One simulated LLM instance: the shared
    :class:`~repro_torch.serving.batch_scheduler.BatchScheduler` makes every
    admission / eviction / preemption / batch-composition decision
    (identical code to the real :class:`~repro_torch.serving.LLMEngine`); this
    class only prices each composed iteration with the calibrated
    :class:`CostModel` and advances sampled output lengths."""

    def __init__(self, instance_id: int, cost: CostModel,
                 kv_capacity_tokens: int, block_size: int = 16,
                 max_batch: int = 16, prefix_caching: bool = False,
                 policy: Optional[SchedulerPolicy] = None,
                 prefill_chunk_tokens: Optional[int] = None,
                 fused_iteration: bool = True,
                 donate_pool: bool = True,
                 ragged_native: bool = True,
                 tp_degree: int = 1,
                 role: str = "general",
                 tracer: Tracer = NULL_TRACER):
        self.instance_id = instance_id
        self.cost = cost
        self.fused_iteration = fused_iteration
        self.donate_pool = donate_pool
        self.ragged_native = ragged_native
        self.tp_degree = tp_degree
        # the KV pool (and thus any pool-copy / re-gather HBM traffic) is
        # sharded over kv heads: each shard moves 1/tp of the bytes
        self.pool_bytes = cost.pool_bytes(kv_capacity_tokens) // max(1, tp_degree)
        self.bm = BlockManager(kv_capacity_tokens // block_size, block_size)
        self.cache = PrefixCache(block_size) if prefix_caching else None
        self.busy = False
        self.tracer = tracer
        # fault plane: the Simulation threads its FaultInjector here (one
        # injector per run, per-instance dispatch ordinals inside it) —
        # same consultation point as LLMEngine.dispatch_iteration
        self.faults: Optional[FaultInjector] = None
        self.sched = BatchScheduler(
            self.bm, policy=policy, prefix_cache=self.cache,
            matcher=KeyPrefixMatcher(), max_running=max_batch,
            prefill_chunk_tokens=prefill_chunk_tokens,
            tracer=tracer, instance_id=instance_id, role=role)

    @property
    def role(self) -> str:
        """Disaggregation role — lives on the shared scheduler, exactly
        like the real engine's."""
        return self.sched.role

    # ------------------------------------------------------------------ intake
    def submit(self, req: Request):
        req.instance_id = self.instance_id
        self.sched.submit(req)

    def can_admit(self, req: Request,
                  watermark: Optional[float] = None) -> bool:
        return self.sched.can_admit(req, watermark)

    # ----------------------------------------------------------------- monitor
    @property
    def max_batch(self) -> int:
        return self.sched.max_batch

    @property
    def waiting(self) -> List[Request]:
        return self.sched.waiting

    @property
    def running(self) -> List[Request]:
        return self.sched.running

    @property
    def n_preempted(self) -> int:
        return self.sched.stats.n_preempted

    @property
    def recent_oom(self) -> bool:
        return self.sched.stats.recent_oom

    @recent_oom.setter
    def recent_oom(self, value: bool):
        self.sched.stats.recent_oom = value

    @property
    def prefill_tokens_total(self) -> int:
        s = self.sched.stats
        return s.prefill_tokens + s.prefill_tokens_saved

    @property
    def prefill_tokens_saved(self) -> int:
        return self.sched.stats.prefill_tokens_saved

    @property
    def has_work(self) -> bool:
        return self.sched.has_work

    # ------------------------------------------------------------------ step
    def step(self, now: float) -> Tuple[List[Request], Optional[float]]:
        """Run one continuous-batching iteration starting at `now`.
        Returns (requests finished at now+dt, dt) or ([], None) if idle."""
        plan = self.sched.plan(now)
        if plan is None:
            return [], None
        eff = None
        if self.faults is not None:
            # same point as the real engine: AFTER plan() — the scheduler
            # has already composed (and mutated state for) this iteration
            eff = self.faults.on_dispatch(self.instance_id, now)
            if eff.oom:
                self.sched.stats.recent_oom = True
            if eff.crash is not None:
                raise InstanceCrashed(self.instance_id, eff.crash.step)
        hbm_bytes = 0
        if self.fused_iteration and not self.ragged_native and plan.chunks:
            # flatten-and-repeat attention lowers each chunk onto S·L
            # decode-style query rows, and every row re-gathers the
            # batch-padded table width — page traffic scales with chunk
            # length × padded context, where the native segment-tiled
            # kernel gathers each (bounded) page once per chunk.  Only
            # the fused path uses the ragged lowering; the per-chunk
            # path gathers exactly its resident context either way.
            bs = self.bm.block_size
            nbp = pad_bucket(max(self.bm.blocks_needed(c.end)
                                 for c in plan.chunks), TABLE_BUCKET_FLOOR)
            extra_rows = sum(
                (c.end - c.start) * nbp * bs - c.end for c in plan.chunks)
            hbm_bytes += extra_rows * self.cost.kv_bytes_per_token \
                // max(1, self.tp_degree)
        if not self.donate_pool:
            # every pool-threading dispatch materializes a second pool
            # buffer (full read + write): 1 for the fused path, one per
            # chunk + one decode dispatch for the per-chunk path
            n_disp = 1 if self.fused_iteration else \
                len(plan.chunks) + (1 if plan.decode else 0)
            hbm_bytes += 2 * n_disp * self.pool_bytes
        dt = self.cost.iteration_time(
            len(plan.decode), plan.prefill_tokens, plan.context_tokens,
            n_prefill_seqs=len(plan.chunks), fused=self.fused_iteration,
            hbm_bytes=hbm_bytes, tp_degree=self.tp_degree)
        if eff is not None:
            # straggler: the real path sleeps on the worker; the sim
            # stretches virtual time by the same slowdown
            dt = dt * eff.factor + eff.delay_s
        finished = []
        traced = self.tracer.enabled
        for r in plan.decode:
            r.output_len += 1
            # same event schema as the real engine, stamped with SIM time:
            # the first decode step books the first generated token
            if r.output_len == 1 and r.first_token_time < 0:
                r.first_token_time = now + dt
                if traced:
                    self.tracer.emit("first-token", req_id=r.req_id,
                                     instance_id=self.instance_id,
                                     agent=r.agent_name, msg_id=r.msg_id,
                                     ts=now + dt)
            elif traced:
                self.tracer.emit("decode", req_id=r.req_id,
                                 instance_id=self.instance_id,
                                 agent=r.agent_name, msg_id=r.msg_id,
                                 ts=now + dt)
            if r.output_len >= r.true_output_len:
                self.sched.finish(r, now + dt)
                finished.append(r)
        return finished, dt


# =============================================================================
# simulation
# =============================================================================


@dataclasses.dataclass
class SimConfig:
    apps: List[AppSpec]
    policy: str = "kairos"            # kairos|parrot|ayo|w/o-priority|w/o-packing|oracle
    rate: float = 6.0                 # workflows/s across all apps
    duration: float = 120.0
    n_instances: int = 4
    kv_capacity_tokens: int = 12288   # per instance (pressure regime, §2.2.3)
    block_size: int = 16              # KV page granularity per instance
    max_batch: int = 48               # memory-bound like the paper's vLLM setup
    cost: CostModel = LLAMA3_8B
    seed: int = 0
    warmup_frac: float = 0.1          # excluded from metrics (online learning)
    prefix_caching: bool = False      # shared-prefix KV reuse on instances
    # instance-level scheduling (batch_scheduler.py): when True, each
    # instance's waiting queue is ordered by the same policy that orders
    # the cluster queue (Kairos priorities carry into the serving
    # iteration); False keeps FCFS instance queues for every policy
    # (pre-refactor behaviour)
    instance_priority: bool = True
    # per-iteration prefill token budget (Sarathi-style chunked prefill);
    # None = monolithic prefill: a prompt stalls the whole batch for one
    # iteration, exactly the §2.2 head-of-line pathology
    prefill_chunk_tokens: Optional[int] = None
    # price each iteration as ONE fused ragged dispatch (the engine's
    # default execution model) instead of one dispatch per prefill chunk
    # plus a decode dispatch; False reproduces the per-chunk pricing
    fused_iteration: bool = True
    # donated in-place KV pool (the engine's default): pool-copy bytes
    # cost 0; False prices one full pool read+write per dispatch, the
    # pre-donation engine behaviour
    donate_pool: bool = True
    # native segment-bounded ragged attention (each chunk re-reads only
    # its own context); False prices the flatten-and-repeat lowering,
    # which re-reads the batch-padded table width per chunk
    ragged_native: bool = True
    # tensor-parallel degree of each instance: compute terms and KV/HBM
    # traffic divide across shards, plus the per-layer ring all-reduce
    # term (CostModel).  Default 1 = unsharded, collective term exactly
    # 0 — every pre-sharding trajectory and BENCH baseline is unchanged
    tp_degree: int = 1
    # observability: thread one obs.Tracer through the whole sim control
    # plane + instances, emitting the SAME event schema as the real
    # engine path with simulated timestamps (sim-vs-real breakdowns
    # diff).  The trace lands on Simulation.tracer after run().
    tracing: bool = False
    # explicit arrival trace: [(t, app_idx)] replayed verbatim instead of
    # the homogeneous-Poisson `rate`/`duration` sampler — the bursty
    # traces from repro_torch.workloads.traces replay through here (and
    # through the real cluster, same list)
    arrivals: Optional[List[Tuple[float, int]]] = None
    # elastic instance count: when set, an Autoscaler (shared decision
    # core with the real cluster's control plane) adds/retires
    # SimInstances at decision_period_s cadence; retirement drains via
    # the scheduler-level release/adopt migration (progress preserved)
    autoscale: Optional[AutoscalerConfig] = None
    # role topology (prefill/decode disaggregation), one role per
    # instance id; None = every instance "general" (flat cluster).
    # Mirrors ServingConfig.roles: prefill instances run chunked prefill
    # only and hand completed prompts to decode-capable instances via
    # the scheduler-level release/adopt (the sim analogue of the
    # block-granular KV handoff), priced by CostModel.transfer_time
    roles: Optional[tuple] = None
    # -- fault plane (mirrors ServingConfig; serving/faults.py,
    # serving/recovery.py — SAME classes run in both paths) ------------------
    # driver-level LLM retry knobs: carried for SIM_FIELD_MAP parity
    # (the sim's virtual clock never blocks a driver thread)
    llm_retries: int = 0
    llm_backoff_s: float = 0.5
    recovery_retries: int = 3            # crashes a request may survive
    recovery_backoff_s: float = 0.0      # exp. backoff before re-queue (s)
    # straggler fence threshold: real wall-clock — the sim carries the
    # knob for parity but its injected straggles stretch virtual time
    step_deadline_s: Optional[float] = None
    slo_e2e_s: Optional[float] = None    # arms the LoadShedder valve
    shed_queue_high: float = 8.0
    shed_kv_high: float = 0.97
    shed_patience: int = 3
    handoff_retry_cap: int = 4           # probes before permanent strand
    # sim-only: deterministic chaos schedule (None = fault-free).  The
    # SAME FaultPlan object drives a real ServingCluster identically.
    faults: Optional[FaultPlan] = None

    def role_of(self, instance_id: int) -> str:
        """Role of an instance id; ids past the declared topology
        (autoscaled pool instances) default to ``general`` — same rule
        as ``ServingConfig.role_of``."""
        if self.roles is None or instance_id >= len(self.roles):
            return "general"
        return self.roles[instance_id]

    @classmethod
    def from_serving_config(cls, serving: ServingConfig, apps: List[AppSpec],
                            **overrides) -> "SimConfig":
        """Map a real-path :class:`ServingConfig` onto the simulator —
        the executable form of ``serving.config.SIM_FIELD_MAP`` (the
        parity test drives both).  ``overrides`` set the sim-only knobs
        (rate, duration, cost, seed, arrivals, autoscale, ...)."""
        base = dict(
            apps=apps,
            policy=serving.sim_policy,
            n_instances=serving.n_instances,
            kv_capacity_tokens=serving.kv_capacity_tokens,
            block_size=serving.block_size,
            max_batch=serving.max_batch,
            prefix_caching=serving.prefix_caching,
            prefill_chunk_tokens=serving.prefill_chunk_tokens,
            fused_iteration=serving.fused_iteration,
            donate_pool=serving.donate_pool,
            ragged_native=serving.ragged_native,
            tp_degree=serving.model_parallel,
            tracing=serving.tracing,
            roles=serving.roles,
            llm_retries=serving.llm_retries,
            llm_backoff_s=serving.llm_backoff_s,
            recovery_retries=serving.recovery_retries,
            recovery_backoff_s=serving.recovery_backoff_s,
            step_deadline_s=serving.step_deadline_s,
            slo_e2e_s=serving.slo_e2e_s,
            shed_queue_high=serving.shed_queue_high,
            shed_kv_high=serving.shed_kv_high,
            shed_patience=serving.shed_patience,
            handoff_retry_cap=serving.handoff_retry_cap,
        )
        base.update(overrides)
        return cls(**base)


@dataclasses.dataclass
class WorkflowState:
    msg_id: str
    app: AppSpec
    start_time: float
    outstanding: int = 0
    hops: int = 0
    total_tokens: int = 0
    done_time: float = -1.0
    requests: List[Request] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class SimResults:
    workflows: List[WorkflowState]
    requests: List[Request]
    n_preempted: int
    queueing_ratio: float
    policy: str
    prefill_tokens_total: int = 0
    prefill_tokens_saved: int = 0
    n_migrated: int = 0               # live migrations during elastic drains
    instance_seconds: float = 0.0     # capacity actually paid for
    n_handoffs: int = 0               # prefill→decode transfers completed
    n_stranded: int = 0               # handoffs refused -> colocated decode
    n_strand_retries: int = 0         # re-offers of already-stranded reqs
    n_crashes: int = 0                # injected instance crashes handled
    n_reconstructed: int = 0          # requests replay-reconstructed
    n_shed: int = 0                   # requests dropped by the overload valve
    n_lost: int = 0                   # recovery budget exhausted (FAILED)
    n_workflows_total: int = 0        # post-warmup workflows STARTED (the
    #                                   goodput denominator: shed/lost
    #                                   workflows never reach `workflows`)
    scale_history: List[Tuple[float, str, int, int]] = \
        dataclasses.field(default_factory=list)

    @property
    def prefill_savings(self) -> float:
        return self.prefill_tokens_saved / max(self.prefill_tokens_total, 1)

    def token_latencies(self) -> np.ndarray:
        """Program-level token latency [37]: e2e response time / tokens."""
        vals = [(w.done_time - w.start_time) / max(w.total_tokens, 1)
                for w in self.workflows if w.done_time >= 0]
        return np.asarray(vals)

    def summary(self) -> Dict[str, float]:
        tl = self.token_latencies()
        if len(tl) == 0:
            return {"avg": float("nan")}
        return {
            "avg": float(np.mean(tl)),
            "p50": float(np.percentile(tl, 50)),
            "p90": float(np.percentile(tl, 90)),
            "p95": float(np.percentile(tl, 95)),
            "p99": float(np.percentile(tl, 99)),
            "n_workflows": float(len(tl)),
            "preempted": float(self.n_preempted),
            "queueing_ratio": self.queueing_ratio,
            "prefill_savings": self.prefill_savings,
            "n_migrated": float(self.n_migrated),
            "instance_seconds": self.instance_seconds,
            "n_handoffs": float(self.n_handoffs),
            "n_stranded": float(self.n_stranded),
            "n_strand_retries": float(self.n_strand_retries),
            "n_crashes": float(self.n_crashes),
            "n_reconstructed": float(self.n_reconstructed),
            "n_shed": float(self.n_shed),
            "n_lost": float(self.n_lost),
            "n_workflows_total": float(self.n_workflows_total),
        }

    def goodput(self, slo_e2e_s: Optional[float]) -> float:
        """Fraction of post-warmup workflows that completed end-to-end
        within ``slo_e2e_s`` — over every workflow STARTED, so shed and
        lost workflows count against it (the honest denominator)."""
        total = max(self.n_workflows_total, 1)
        if slo_e2e_s is None:
            return len(self.workflows) / total
        good = sum(1 for w in self.workflows
                   if w.done_time - w.start_time <= slo_e2e_s)
        return good / total


class Simulation:
    # policies that carry their ordering into the serving iteration; the
    # baselines (Parrot/Ayo/ablations) schedule only at the cluster queue
    # and their instances stay FCFS, faithful to the systems they model
    INSTANCE_LEVEL_POLICIES = ("kairos", "w/o-packing", "oracle")

    def __init__(self, cfg: SimConfig):
        self.cfg = cfg
        # reset the global request-id counter so trajectories (tie-breaks
        # in victim selection / sort stability) are reproducible no matter
        # how many requests earlier simulations in this process created
        reset_request_ids()
        self.rng = np.random.default_rng(cfg.seed)
        hw = HardwareProfile(
            decode_tok_per_s=cfg.cost.decode_tok_per_s(typical_batch=cfg.max_batch // 2),
            kv_capacity_tokens=cfg.kv_capacity_tokens)
        self.tracer: Tracer = Tracer() if cfg.tracing else NULL_TRACER
        self.orch = Orchestrator(hardware=hw, prefix_caching=cfg.prefix_caching,
                                 tracer=self.tracer)
        models = [InstanceModel(i, cfg.kv_capacity_tokens,
                                role=cfg.role_of(i))
                  for i in range(cfg.n_instances)]
        self.scheduler, self.dispatcher, strict = self._make_policy(cfg.policy, models)
        self._inst_policy = (self.scheduler
                             if cfg.instance_priority
                             and cfg.policy in self.INSTANCE_LEVEL_POLICIES
                             else None)
        # keyed by instance_id: the autoscaler adds/retires instances at
        # runtime, so ids are stable names, not list positions
        self.instances: Dict[int, SimInstance] = {
            i: self._make_instance(i) for i in range(cfg.n_instances)}
        # every instance that ever lived, for end-of-run stats (a retired
        # instance's preemption/prefill counters still count)
        self._all_instances: List[SimInstance] = list(self.instances.values())
        self._spawn_time: Dict[int, float] = dict.fromkeys(self.instances, 0.0)
        self.instance_seconds = 0.0
        self.autoscaler = Autoscaler(cfg.autoscale) if cfg.autoscale else None
        self.balancer = LoadBalancer(
            self.scheduler, self.dispatcher, self.orch, self._submit,
            strict_head=strict, tracer=self.tracer)
        self.workflows: Dict[str, WorkflowState] = {}
        self.finished_requests: List[Request] = []
        self.n_handoffs = 0
        self.n_stranded = 0
        self.n_strand_retries = 0
        # fault plane: SAME classes as ServingCluster — the injector
        # consumes cfg.faults at the same per-instance dispatch ordinals,
        # the RecoveryManager reconstructs crash victims through this
        # Simulation's dispatcher/balancer/discard_engine surface, and
        # the shedder (armed by slo_e2e_s) prices slack with cfg.cost
        self.faults = (FaultInjector(cfg.faults, self.tracer)
                       if cfg.faults is not None else None)
        for inst in self.instances.values():
            inst.faults = self.faults
        self.recovery = RecoveryManager(
            max_retries=cfg.recovery_retries,
            backoff_s=cfg.recovery_backoff_s, tracer=self.tracer)
        self.shedder = (LoadShedder(
            slo_e2e_s=cfg.slo_e2e_s, cost=cfg.cost,
            queue_high=cfg.shed_queue_high, kv_high=cfg.shed_kv_high,
            patience=cfg.shed_patience, tracer=self.tracer)
            if cfg.slo_e2e_s is not None else None)
        self.lost_requests: List[Request] = []   # FAILED + SHED
        self._events: List[Tuple[float, int, str, object]] = []
        self._eseq = itertools.count()
        self._msg_counter = itertools.count()
        self._balancer_armed = False

    def _make_instance(self, iid: int,
                       role: Optional[str] = None) -> SimInstance:
        cfg = self.cfg
        return SimInstance(
            iid, cfg.cost, cfg.kv_capacity_tokens, block_size=cfg.block_size,
            max_batch=cfg.max_batch, prefix_caching=cfg.prefix_caching,
            policy=self._inst_policy,
            prefill_chunk_tokens=cfg.prefill_chunk_tokens,
            fused_iteration=cfg.fused_iteration,
            donate_pool=cfg.donate_pool, ragged_native=cfg.ragged_native,
            tp_degree=cfg.tp_degree,
            role=cfg.role_of(iid) if role is None else role,
            tracer=self.tracer)

    # ------------------------------------------------------------------ policy
    def _make_policy(self, policy: str, models):
        probe = lambda iid, req: self.instances[iid].can_admit(req)
        if policy == "parrot":
            # true Parrot: blind rotation, requests queue FIFO at instances
            return FCFSScheduler(), RoundRobinDispatcher(models), False
        if policy == "ayo":
            return (TopoScheduler(self.orch.remaining_stages),
                    RoundRobinDispatcher(models, probe), True)
        if policy == "kairos":
            return (KairosScheduler(self.orch.priority_score),
                    TimeSlotDispatcher(models, admit_probe=probe,
                                       tracer=self.tracer), True)
        if policy == "w/o-priority":
            return FCFSScheduler(), TimeSlotDispatcher(
                models, admit_probe=probe, tracer=self.tracer), True
        if policy == "w/o-packing":
            # packing removed -> admission-gated rotation (priority retained)
            return (KairosScheduler(self.orch.priority_score),
                    RoundRobinDispatcher(models, probe), True)
        if policy == "oracle":
            def true_remaining(req: Request) -> float:
                return req.true_output_len * self.cfg.cost.iteration_time(
                    self.cfg.max_batch // 2, 0)
            return (OracleScheduler(true_remaining),
                    BestFitOracleDispatcher(models, probe), False)
        raise ValueError(f"unknown policy {policy!r}")

    # ------------------------------------------------------------------ events
    def _push(self, t: float, kind: str, payload=None):
        heapq.heappush(self._events, (t, next(self._eseq), kind, payload))

    def _submit(self, iid: int, req: Request):
        inst = self.instances[iid]
        was_idle = not inst.has_work
        inst.submit(req)
        if was_idle or not inst.busy:
            self._push(self._now, "instance_step", iid)
            inst.busy = True

    def _arm_balancer(self, t: float):
        if not self._balancer_armed:
            self._balancer_armed = True
            self._push(t, "balancer", None)

    # -------------------------------------------------------------- elasticity
    def _signals(self, now: float,
                 role: Optional[str] = None) -> ClusterSignals:
        inst = [InstanceSignal(
            instance_id=i.instance_id,
            kv_used_frac=i.bm.hard_used_blocks / i.bm.num_blocks,
            fenced=now < self.dispatcher.instances[i.instance_id].fenced_until,
            load=len(i.running) + len(i.waiting))
            for i in self.instances.values()
            if role is None or i.role == role]
        if role is None:
            depth = self.balancer.queued
        else:
            depth = sum(1 for r in self.balancer.queue
                        if role_accepts(role, r))
        return ClusterSignals(now=now, queue_depth=depth, instances=inst)

    def _scale_up(self, now: float, role: Optional[str] = None):
        iid = max(self.instances) + 1
        inst = self._make_instance(iid, role=role)
        inst.faults = self.faults
        self.instances[iid] = inst
        self._all_instances.append(inst)
        self._spawn_time[iid] = now
        self.dispatcher.add_instance(
            InstanceModel(iid, self.cfg.kv_capacity_tokens, role=inst.role))
        self.autoscaler.note_action(now, "up", iid, len(self.instances))
        if self.tracer.enabled:
            self.tracer.emit("scale-up", instance_id=iid, ts=now,
                             n=len(self.instances), role=inst.role)

    def _scale_down(self, victim: int, now: float):
        """Retire a SimInstance by draining it through migration: the sim
        analogue of the real cluster's KV-carrying path — same
        scheduler-level release/adopt (progress preserved, no recompute),
        minus the block bytes (the cost model has no KV contents)."""
        removed = self.dispatcher.remove_instance(victim)
        inst = self.instances.pop(victim)
        self.instance_seconds += now - self._spawn_time.pop(victim)
        while inst.sched.has_work:
            for req in list(inst.sched.waiting):
                inst.sched.release(req)
                removed.ramps.pop(req.req_id, None)
                self.balancer.enqueue(req)
            if not inst.sched.running:
                continue
            req = inst.sched.running[0]
            target = min(
                (i for i in self.instances.values()
                 if role_accepts(i.role, req) and i.sched.can_adopt(req)),
                key=lambda i: i.bm.hard_used_blocks, default=None)
            if target is not None:
                inst.sched.release(req)
                target.sched.adopt(req, now)
                req.instance_id = target.instance_id
                self.dispatcher.adopt_ramp(
                    target.instance_id, req.req_id,
                    removed.ramps.pop(req.req_id, None))
                if not target.busy:
                    self._push(now, "instance_step", target.instance_id)
                    target.busy = True
                if self.tracer.enabled:
                    self.tracer.emit("migrate-candidate", req_id=req.req_id,
                                     agent=req.agent_name, msg_id=req.msg_id,
                                     ts=now, to=target.instance_id,
                                     reason="scale-down")
            else:
                inst.sched.preempt(req)
                inst.sched.release(req)
                removed.ramps.pop(req.req_id, None)
                self.balancer.enqueue(req)
        self.autoscaler.note_action(now, "down", victim, len(self.instances))
        if self.tracer.enabled:
            self.tracer.emit("scale-down", instance_id=victim, ts=now,
                             n=len(self.instances), role=removed.role)
        self._arm_balancer(now)

    # ------------------------------------------------------------- fault plane
    def discard_engine(self, inst: SimInstance):
        """Drop a crashed instance (RecoveryManager callback — same name
        as the real cluster's).  Its BlockManager dies with it; victims
        were already captured off its scheduler by the caller."""
        assert len(self.instances) > 1, \
            "every instance crashed — nothing left to recover onto"
        iid = inst.instance_id
        self.instances.pop(iid, None)
        self.instance_seconds += self._now - self._spawn_time.pop(iid,
                                                                  self._now)

    def _book_lost(self, req: Request, now: float):
        """Account a request that will never finish (SHED by the valve or
        FAILED past its recovery budget): unblock its workflow without
        spawning downstream — the workflow stays incomplete and counts
        against goodput."""
        self.lost_requests.append(req)
        wf = self.workflows.get(req.msg_id)
        if wf is not None:
            wf.outstanding -= 1

    def _on_crash(self, inst: SimInstance, now: float):
        """An injected crash surfaced from ``SimInstance.step``: hand the
        dead instance to the shared RecoveryManager (fence + remove +
        reconstruct), book budget-exhausted victims as lost, and arm the
        events that resume the survivors."""
        for req in self.recovery.on_crash(self, inst, now):
            self._book_lost(req, now)
        for t_ready in self.recovery.backoff_deadlines:
            self._push(t_ready, "recovery", None)
        self._arm_balancer(now)

    def _shed_sweep(self, now: float):
        """Overload valve at the balancer tick — same signals the
        autoscaler reads, same LoadShedder rule as the real cluster."""
        sig = self._signals(now)
        max_kv = max((i.kv_used_frac for i in sig.instances), default=0.0)
        self.shedder.observe(self.balancer.queued,
                             max(1, len(self.instances)), max_kv)
        victims = self.shedder.select(self.balancer.queue, now,
                                      max(1, len(self.instances)))
        if not victims:
            return
        vids = {r.req_id for r in victims}
        self.balancer.queue = [r for r in self.balancer.queue
                               if r.req_id not in vids]
        depth = self.balancer.queued
        for r in victims:
            self.shedder.shed(r, now, depth)
            self._book_lost(r, now)

    def _autoscale_tick(self, now: float):
        """Mirror of ``Autoscaler.step``: one decision per role pool,
        each from role-split signals (a flat sim is one general pool)."""
        roles = {i.role for i in self.instances.values()}
        pools = [r for r in ("prefill", "decode", "general")
                 if r in roles] or ["general"]
        split = pools != ["general"]
        for role in pools:
            action = self.autoscaler.decide(
                self._signals(now, role=role if split else None), role=role)
            if action is None:
                continue
            kind, victim = action
            if kind == "up":
                self._scale_up(now, role=role if split else None)
            elif sum(1 for i in self.instances.values()
                     if not split or i.role == role) > 1:
                self._scale_down(victim, now)

    def _sim_handoffs(self, src: SimInstance, now: float):
        """Prefill→decode handoff, sim analogue of
        ``serving.handoff.drive_handoffs``: scheduler-level
        release/adopt (same progress-preserving path as ``_scale_down``,
        no KV bytes to move) with the wire time priced by
        ``CostModel.transfer_time``; refused requests are stranded for
        colocated decode and re-offered with exponential backoff up to
        ``handoff_retry_cap`` attempts (then permanently colocated) —
        the same :meth:`BatchScheduler.handoff_offers` /
        :meth:`~BatchScheduler.note_strand` control as the real driver.
        An injected transfer fault fails the sweep's gathered transfer
        losslessly: every offer strands, nothing moves."""
        cap = self.cfg.handoff_retry_cap
        ready = src.sched.handoff_offers(cap)
        if not ready:
            return
        faulted = (self.faults is not None
                   and self.faults.transfer_fault(src.instance_id, now)
                   is not None)
        targets = [] if faulted else sorted(
            (i for i in self.instances.values()
             if i is not src and i.role != "prefill"
             and not (now < self.dispatcher.instances[
                 i.instance_id].fenced_until)),
            key=lambda i: (i.role != "decode",
                           -(i.bm.free_blocks + i.bm.cached_blocks)))
        for req in ready:
            tgt = next((t for t in targets if t.sched.can_adopt(req)), None)
            if tgt is None:
                fresh = req.req_id not in src.sched.stranded
                permanent = src.sched.note_strand(req, cap)
                if fresh:
                    self.n_stranded += 1
                    src.sched.allow_colocated_decode(req)
                else:
                    self.n_strand_retries += 1
                if self.tracer.enabled:
                    self.tracer.emit(
                        "handoff-strand", req_id=req.req_id,
                        instance_id=src.instance_id, agent=req.agent_name,
                        msg_id=req.msg_id, ts=now,
                        attempts=src.sched.strand_attempts[req.req_id],
                        permanent=permanent)
                continue
            n_resident = req.prefilled_len + req.output_len
            dt = self.cfg.cost.transfer_time(n_resident)
            src.sched.release(req)
            tgt.sched.adopt(req, now + dt)
            req.instance_id = tgt.instance_id
            self.dispatcher.adopt_ramp(
                tgt.instance_id, req.req_id,
                self.dispatcher.instances[src.instance_id].ramps.pop(
                    req.req_id, None))
            self.n_handoffs += 1
            if not tgt.busy:
                self._push(now + dt, "instance_step", tgt.instance_id)
                tgt.busy = True
            if self.tracer.enabled:
                self.tracer.emit(
                    "handoff-start", req_id=req.req_id,
                    instance_id=src.instance_id, agent=req.agent_name,
                    msg_id=req.msg_id, ts=now, to=tgt.instance_id,
                    n_blocks=src.bm.blocks_needed(n_resident),
                    n_bytes=n_resident * self.cfg.cost.kv_bytes_per_token)
                self.tracer.emit(
                    "handoff-complete", req_id=req.req_id,
                    instance_id=tgt.instance_id, agent=req.agent_name,
                    msg_id=req.msg_id, ts=now + dt, src=src.instance_id,
                    cached=0)

    # ------------------------------------------------------------------ agents
    def _request_rng(self, wf: WorkflowState, agent: str) -> np.random.Generator:
        """Deterministic per-(workflow, agent, hop) RNG so the sampled
        workload is IDENTICAL across policies and across processes
        (zlib.crc32 — python str hash() is salted per process)."""
        key = zlib.crc32(
            f"{self.cfg.seed}|{wf.msg_id}|{agent}|{wf.hops}".encode())
        return np.random.default_rng(key)

    def _spawn_request(self, wf: WorkflowState, agent: str,
                       upstream: Optional[str], now: float):
        prof = wf.app.agents[agent]
        rng = self._request_rng(wf, agent)
        req = Request(
            agent_name=agent, msg_id=wf.msg_id, upstream_name=upstream,
            app_name=wf.app.name,
            prompt_len=prof.sample_prompt_len(rng),
            true_output_len=prof.sample_output_len(rng),
            max_new_tokens=10 ** 9,
            shared_prefix_len=prof.system_prompt_len,
            cache_key=f"{wf.app.name}|{agent}",
            arrival_time=now, app_start_time=wf.start_time)
        wf.outstanding += 1
        wf.hops += 1
        wf.requests.append(req)
        self.balancer.enqueue(req)
        self._arm_balancer(now)

    def _on_request_finished(self, req: Request, now: float):
        # unwind any crash-recovery identity BEFORE booking (no replayed
        # tokens exist in the sim, but the record must retire)
        self.recovery.on_finish(req)
        wf = self.workflows[req.msg_id]
        wf.outstanding -= 1
        wf.total_tokens += req.output_len
        self.finished_requests.append(req)
        self.dispatcher.on_finish(req.instance_id, req.req_id)
        self.orch.on_completion(CompletionRecord(
            agent_name=req.agent_name, msg_id=req.msg_id,
            upstream_name=req.upstream_name, app_name=req.app_name,
            start_time=req.arrival_time, end_time=now,
            prompt_len=req.prompt_len, output_len=req.output_len,
            exec_start_time=req.exec_start_time,
            first_token_time=req.first_token_time))
        downstream = wf.app.route(req.agent_name, self._request_rng(wf, req.agent_name), wf.hops)
        for agent in downstream:
            self._spawn_request(wf, agent, req.agent_name, now + AGENT_OVERHEAD)
        if not downstream and wf.outstanding == 0:
            wf.done_time = now
            self.orch.on_workflow_complete(wf.msg_id)

    # ------------------------------------------------------------------ run
    def run(self) -> SimResults:
        cfg = self.cfg
        if cfg.arrivals is not None:
            # explicit trace replay: (t, app_idx) pairs, verbatim
            for t, app_idx in cfg.arrivals:
                self._push(float(t), "workflow_arrival", int(app_idx))
        else:
            # workflow arrivals, interleaving apps uniformly
            arrivals = arrival_times(self.rng, cfg.rate, cfg.duration)
            for t in arrivals:
                self._push(float(t), "workflow_arrival", None)
        self._now = 0.0
        if self.autoscaler is not None:
            self._push(cfg.autoscale.decision_period_s, "autoscale", None)

        while self._events:
            t, _, kind, payload = heapq.heappop(self._events)
            self._now = t
            if kind == "workflow_arrival":
                wf_idx = next(self._msg_counter)
                app = cfg.apps[(payload if payload is not None else wf_idx)
                               % len(cfg.apps)]
                msg_id = f"wf-{wf_idx}"
                wf = WorkflowState(msg_id, app, t)
                self.workflows[msg_id] = wf
                self._spawn_request(wf, app.entry, None, t)
            elif kind == "balancer":
                self._balancer_armed = False
                # OOM feedback from instances (§6 adaptive measure)
                for inst in self.instances.values():
                    if inst.recent_oom:
                        inst.recent_oom = False
                        self.dispatcher.on_oom(inst.instance_id, t)
                if self.shedder is not None:
                    self._shed_sweep(t)
                self.balancer.tick(t)
                if self.balancer.queued:
                    self._arm_balancer(t + BALANCER_PERIOD)
            elif kind == "autoscale":
                self._autoscale_tick(t)
                # keep deciding while the system is live; stop re-arming
                # once all work has drained so the event loop terminates
                if (self._events or self.balancer.queued
                        or self.recovery.pending
                        or any(i.has_work for i in self.instances.values())):
                    self._push(t + cfg.autoscale.decision_period_s,
                               "autoscale", None)
            elif kind == "recovery":
                # a reconstructed request's backoff expired: re-queue it
                self.recovery.tick(self, t)
                self._arm_balancer(t)
            elif kind == "instance_step":
                inst = self.instances.get(payload)
                if inst is None:
                    continue   # instance was scaled away; its work moved
                if inst.role == "prefill":
                    # between iterations — the only legal transfer point,
                    # same as the real cluster's post-collect sweep
                    self._sim_handoffs(inst, t)
                elif inst.role == "decode" and inst.sched.waiting:
                    # decode-side preemptions re-enter via the balancer
                    # (phase reset by the preemption) — the role gate
                    # would never re-admit them locally
                    for req in list(inst.sched.waiting):
                        inst.sched.release(req)
                        self.dispatcher.instances[
                            inst.instance_id].ramps.pop(req.req_id, None)
                        self.balancer.enqueue(req)
                    self._arm_balancer(t)
                try:
                    finished, dt = inst.step(t)
                except InstanceCrashed:
                    # injected crash mid-iteration: the pool is gone with
                    # the instance; reconstruct victims from host truth
                    self._on_crash(inst, t)
                    continue
                if dt is None:
                    inst.busy = False
                else:
                    for r in finished:
                        self._on_request_finished(r, t + dt)
                    self._push(t + dt, "instance_step", payload)
                    if finished and self.balancer.queued:
                        self._arm_balancer(t + dt)
        for iid, t0 in self._spawn_time.items():
            self.instance_seconds += self._now - t0

        # ---- metrics ---------------------------------------------------------
        warm_t = cfg.duration * cfg.warmup_frac
        wfs = [w for w in self.workflows.values()
               if w.done_time >= 0 and w.start_time >= warm_t]
        n_total = sum(1 for w in self.workflows.values()
                      if w.start_time >= warm_t)
        reqs = [r for r in self.finished_requests if r.arrival_time >= warm_t]
        qsum = sum(max(r.queueing_time(), 0.0) for r in reqs if not math.isnan(r.queueing_time()))
        esum = sum(r.e2e_latency for r in reqs if r.finish_time >= 0)
        return SimResults(
            workflows=wfs,
            requests=reqs,
            n_preempted=sum(i.n_preempted for i in self._all_instances),
            queueing_ratio=qsum / max(esum, 1e-9),
            policy=cfg.policy,
            prefill_tokens_total=sum(i.prefill_tokens_total
                                     for i in self._all_instances),
            prefill_tokens_saved=sum(i.prefill_tokens_saved
                                     for i in self._all_instances),
            n_migrated=sum(i.sched.stats.n_migrated_in
                           for i in self._all_instances),
            instance_seconds=self.instance_seconds,
            n_handoffs=self.n_handoffs,
            n_stranded=self.n_stranded,
            n_strand_retries=self.n_strand_retries,
            n_crashes=self.recovery.n_crashes,
            n_reconstructed=self.recovery.n_reconstructed,
            n_shed=self.shedder.n_shed if self.shedder else 0,
            n_lost=self.recovery.n_failed,
            n_workflows_total=n_total,
            scale_history=(list(self.autoscaler.history)
                           if self.autoscaler else []),
        )


def run_policy(apps, policy: str, **kw) -> SimResults:
    cfg = SimConfig(apps=apps, policy=policy, **kw)
    return Simulation(cfg).run()
