"""Pipelined multi-instance cluster runtime.

The paper's end-to-end system (§3, §6) is a *cluster*: a memory-aware
dispatcher spreads requests over many LLM instances and corrects itself
from live feedback (early finishes release future slots, a real
OOM/preemption fences the instance).  :class:`ServingCluster` is that
system on the real-engine path — it owns N :class:`LLMEngine`\\ s plus the
control plane (:class:`LoadBalancer` / :class:`TimeSlotDispatcher` /
:class:`Orchestrator`):

* **Pipelined execution** — each cluster step is breadth-first: every
  engine's fused iteration is *dispatched* first
  (:meth:`LLMEngine.dispatch_iteration`), results are *collected*
  after.  Dispatches are issued from a small worker pool, one engine
  per worker, so host-side planning, flattening and kernel launches of
  engine *i+1* overlap device compute of engine *i*; each worker absorbs
  its own engine's device wait, and next-token ids reach the
  control-plane thread already host-resident, so ``collect`` never
  blocks (deferred host sync, see ``engine.TokenBuffer``).  Every engine
  launches on its worker thread's current stream — on the card the
  default stream, so instances sharing one card serialise there as they
  do on one TPU.  ``pipelined=False`` keeps the serial loop — step one
  engine at a time, blocking on its device->host transfer — as the
  differential baseline.

* **OOM feedback** (§6 adaptive) — after every collect the cluster polls
  ``engine.poll_oom()`` and fences the instance via
  ``dispatcher.on_oom``, exactly like the simulator's control plane.

* **Admission probe parity** — the dispatcher's ``admit_probe`` is
  :meth:`BatchScheduler.can_admit` (batch slot + watermarked prompt
  memory), not an ad-hoc queue-length check.

* **Completion feedback** — finished requests flow to
  ``orchestrator.on_completion`` (workflow analyzer + profiler) and
  ``dispatcher.on_finish`` (release future slots) in one place.

* **Fault plane** — a :class:`~repro_torch.serving.faults.FaultPlan`
  injects crashes/stragglers/ooms at planned points; a crash surfaces as
  :class:`InstanceCrashed` from the engine's dispatch and is handled at
  the synced post-collect point by the cluster's
  :class:`~repro_torch.serving.recovery.RecoveryManager` — the dead
  instance is fenced + removed and its in-flight requests are
  reconstructed with bit-identical replay.

Not ported yet, and raising ``NotImplementedError`` naming their
``ROADMAP.md`` item when reached: tensor-parallel mesh slices
(``on_mesh_slices``, ``model_parallel > 1``), live migration
(``scale_down``), the autoscaler, prefill/decode disaggregation (any
``"prefill"`` role) and the overload valve (``slo_e2e_s``).
"""
from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional, Sequence

from repro_torch.obs.metrics import merge_snapshots
from repro_torch.obs.trace import NULL_TRACER, Tracer
from repro_torch.serving.config import ServingConfig
from repro_torch.serving.engine import LLMEngine, PagedModelRunner
from repro_torch.serving.faults import FaultInjector, FaultPlan, InstanceCrashed
from repro_torch.serving.recovery import RecoveryManager
from repro_torch.serving.request import CompletionRecord, Request

_MIGRATION = "(ROADMAP.md Queue 1 item 2)"
_TENSOR_PARALLEL = "(ROADMAP.md Queue 1 item 4)"


def _require_ported_role(engine: LLMEngine) -> None:
    if engine.role == "prefill":
        raise NotImplementedError(
            "prefill/decode disaggregation: the handoff of prefilled "
            f"requests is not ported yet {_MIGRATION}")


class ServingCluster:
    """N real engines + the Kairos control plane, stepped as one unit.

    Parameters
    ----------
    engines:
        The :class:`LLMEngine` instances (unique ``instance_id`` each).
    orchestrator:
        The :class:`~repro_torch.core.orchestrator.Orchestrator` feeding
        priorities and memory ramps.
    scheduler:
        Load-balancer queue policy; defaults to the orchestrator-backed
        ``KairosScheduler``.
    dispatcher:
        Instance placement; defaults to a
        :class:`~repro_torch.core.dispatcher.TimeSlotDispatcher` over the
        engines' KV capacities.  An injected dispatcher without an
        ``admit_probe`` is wired to the engines' ``can_admit``.
    pipelined:
        Breadth-first dispatch-all-then-collect-all with one worker per
        engine (default).  False = serial loop (dispatch + blocking
        collect per engine, no workers).
    oom_feedback:
        Poll ``engine.poll_oom()`` and fence via ``dispatcher.on_oom``
        (default).  False leaves fencing dead — the differential
        baseline.
    clock:
        Injectable time source (tests use a deterministic one).
    tracer:
        Observability sink shared by the whole cluster: control-plane
        events (submit/dispatch/oom-fence) land on ring ``-1``, each
        engine's on its own ring.  Pass the SAME tracer to the engines.
        Defaults to disabled.
    """

    def __init__(self, engines: Sequence[LLMEngine], orchestrator, *,
                 scheduler=None, dispatcher=None, pipelined: bool = True,
                 oom_feedback: bool = True,
                 clock: Callable[[], float] = time.monotonic,
                 engine_factory: Optional[Callable[[int], LLMEngine]] = None,
                 faults: Optional[FaultPlan] = None,
                 tracer: Tracer = NULL_TRACER):
        from repro_torch.core.balancer import LoadBalancer
        from repro_torch.core.dispatcher import (
            InstanceModel,
            TimeSlotDispatcher,
        )
        from repro_torch.core.scheduler import KairosScheduler

        self.engines: List[LLMEngine] = list(engines)
        assert self.engines, "a cluster needs at least one engine"
        for e in self.engines:
            _require_ported_role(e)
        self._by_id = {e.instance_id: e for e in self.engines}
        assert len(self._by_id) == len(self.engines), \
            "engine instance_ids must be unique"
        # in-place pools: each instance must own its pool.  Two engines
        # sharing one PagedModelRunner would write their KV into the very
        # pool the other one reads — build per-instance runners with
        # ``PagedModelRunner.clone()`` instead (params stay shared; pools
        # never are)
        runners = {id(e.runner) for e in self.engines}
        assert len(runners) == len(self.engines), \
            "engines must not share a PagedModelRunner (in-place KV " \
            "pools); use runner.clone() per instance"
        self.orch = orchestrator
        self.pipelined = pipelined
        self.oom_feedback = oom_feedback
        self.clock = clock
        self.tracer = tracer
        self._pool: Optional[ThreadPoolExecutor] = None
        # elasticity: the factory mints engines for scale_up (set by
        # from_config; manual clusters may pass their own)
        self._engine_factory = engine_factory
        self.config: Optional[ServingConfig] = None
        # fault plane: one injector consumes the plan across the whole
        # run (per-instance ordinals live in the injector); the recovery
        # manager is always live — crashes need no opt-in (from_config
        # replaces it with a config-tuned one)
        self.faults: Optional[FaultInjector] = (
            FaultInjector(faults, tracer) if isinstance(faults, FaultPlan)
            else faults)
        for e in self.engines:
            e.faults = self.faults
        self.recovery = RecoveryManager(tracer=tracer)
        if dispatcher is None:
            dispatcher = TimeSlotDispatcher(
                [InstanceModel(e.instance_id, e.kv_capacity_tokens,
                               role=e.role)
                 for e in self.engines],
                admit_probe=self.can_admit, tracer=tracer)
        elif getattr(dispatcher, "admit_probe", None) is None:
            dispatcher.admit_probe = self.can_admit
        self.dispatcher = dispatcher
        self.balancer = LoadBalancer(
            scheduler or KairosScheduler(self.orch.priority_score),
            self.dispatcher, self.orch,
            lambda iid, req: self._by_id[iid].submit(req),
            tracer=tracer)

    # ---------------------------------------------------------------- factories
    @classmethod
    def on_mesh_slices(cls, *args, **kwargs) -> "ServingCluster":
        """Data-parallel instances over tensor-parallel mesh slices."""
        raise NotImplementedError(
            f"tensor-parallel mesh slices are not ported yet "
            f"{_TENSOR_PARALLEL}")

    @classmethod
    def from_config(cls, model, params, orchestrator,
                    config: ServingConfig, *, backend=None, device=None,
                    clock: Callable[[], float] = time.monotonic,
                    tracer: Tracer = NULL_TRACER, **cluster_kwargs
                    ) -> "ServingCluster":
        """Build the whole cluster from ONE :class:`ServingConfig`.

        The config describes "an instance like the others": the returned
        cluster carries an engine factory minting identically-configured
        engines (params shared via :meth:`PagedModelRunner.clone`,
        private KV pool), so :meth:`scale_up` can add capacity at
        runtime.  ``device=None`` means the CUDA card and raises without
        one; ``params`` must live on the device."""
        from repro_torch.core.scheduler import FCFSScheduler

        if config.model_parallel > 1:
            raise NotImplementedError(
                f"model_parallel={config.model_parallel}: tensor "
                f"parallelism is not ported yet {_TENSOR_PARALLEL}")
        if config.slo_e2e_s is not None:
            raise NotImplementedError(
                "slo_e2e_s: the load shedder's cost model "
                f"(sim/cost_model.py) is not ported yet {_MIGRATION}")
        if config.disaggregated:
            raise NotImplementedError(
                "roles with a 'prefill' instance: the prefill->decode "
                f"handoff is not ported yet {_MIGRATION}")
        if config.tracing and tracer is NULL_TRACER:
            tracer = Tracer(clock=clock)
        scheduler = (cluster_kwargs.pop("scheduler", None)
                     or config.make_policy(orchestrator) or FCFSScheduler())
        runner0 = PagedModelRunner.from_config(model, params, config,
                                               backend=backend,
                                               device=device)

        def make_engine(iid: int, runner=None,
                        role: Optional[str] = None) -> LLMEngine:
            return LLMEngine.from_config(
                runner if runner is not None else runner0.clone(), config,
                instance_id=iid, clock=clock,
                policy=config.make_policy(orchestrator), tracer=tracer,
                role=role)

        engines = [make_engine(0, runner0)]
        engines += [make_engine(i) for i in range(1, config.n_instances)]
        cluster = cls(engines, orchestrator, scheduler=scheduler,
                      engine_factory=make_engine, clock=clock,
                      tracer=tracer, **cluster_kwargs)
        cluster.config = config
        cluster._arm_fault_plane(config, tracer)
        return cluster

    def _arm_fault_plane(self, config: ServingConfig, tracer: Tracer):
        """Tune recovery to the config's budgets."""
        self.recovery = RecoveryManager(
            max_retries=config.recovery_retries,
            backoff_s=config.recovery_backoff_s,
            step_deadline_s=config.step_deadline_s, tracer=tracer)

    # ----------------------------------------------------------- public surface
    #
    # ``submit()`` / ``step()`` / ``drain()`` / ``metrics_snapshot()`` are
    # THE cluster contract: everything a driver (Workflow, benchmarks)
    # needs.  ``balancer`` / ``engines`` / ``dispatcher`` are internals.

    def submit(self, req: Request):
        """Accept a request into the cluster.  The request is queued at
        the load balancer and placed onto an instance by a subsequent
        :meth:`step`; completion surfaces in that step's return value
        (and via ``orchestrator.on_completion``)."""
        self.balancer.enqueue(req)

    def can_admit(self, instance_id: int, req: Request) -> bool:
        """Dispatcher admit probe: the instance scheduler's own admission
        predicate (batch slot + watermarked prompt memory), matching the
        simulator's dispatch semantics."""
        return self._by_id[instance_id].sched.can_admit(req)

    @property
    def has_work(self) -> bool:
        return (bool(self.balancer.queue) or self.recovery.pending > 0
                or any(e.sched.has_work or e.has_pending
                       for e in self.engines))

    # ---------------------------------------------------------------- stepping
    ROLE_STEP_ORDER = ("prefill", "general", "decode")

    def _role_groups(self) -> List[List[LLMEngine]]:
        """Engines grouped by role in step order (prefill, general,
        decode).  A flat cluster is exactly one "general" group."""
        groups = []
        for role in self.ROLE_STEP_ORDER:
            g = [e for e in self.engines if e.role == role]
            if g:
                groups.append(g)
        return groups

    def step(self, now: Optional[float] = None) -> List[Request]:
        """One cluster iteration: balance, then run every role group
        breadth-first.

        Pipelined mode issues a whole group's engine dispatches before
        the group's first collect, one worker thread per engine: while
        engine *i*'s fused iteration computes, the other workers
        plan/flatten/launch theirs, and each worker absorbs its own
        device wait.  Collect then runs on this thread in engine order
        and never blocks (tokens arrive host-resident).  Serial mode
        steps engines one at a time with a forced host sync."""
        now = self.clock() if now is None else now
        finished: List[Request] = []
        self.recovery.tick(self, now)
        self.balancer.tick(now)
        for group in self._role_groups():
            if self.pipelined and len(group) > 1:
                if self._pool is None:
                    self._pool = ThreadPoolExecutor(
                        max_workers=len(self.engines),
                        thread_name_prefix="cluster-dispatch")
                futures = [self._pool.submit(self._dispatch_one, e)
                           for e in group]
                for e, f in zip(group, futures):
                    try:
                        f.result()
                    except InstanceCrashed:
                        finished.extend(self.recovery.on_crash(self, e, now))
                        continue
                    finished.extend(self._collect(e, now))
                    self.recovery.check_step_deadline(
                        self, e, e.last_step_wall, now)
            elif self.pipelined:
                # single engine: nothing to overlap across instances —
                # skip the worker handoff, keep the deferred host sync
                e = group[0]
                try:
                    t0 = time.monotonic()
                    e.dispatch_iteration()
                    e.last_step_wall = time.monotonic() - t0
                except InstanceCrashed:
                    finished.extend(self.recovery.on_crash(self, e, now))
                    continue
                finished.extend(self._collect(e, now))
                self.recovery.check_step_deadline(
                    self, e, e.last_step_wall, now)
            else:
                for e in group:
                    try:
                        t0 = time.monotonic()
                        e.dispatch_iteration()
                        e.last_step_wall = time.monotonic() - t0
                    except InstanceCrashed:
                        finished.extend(self.recovery.on_crash(self, e, now))
                        continue
                    finished.extend(self._collect(e, now, force_sync=True))
                    self.recovery.check_step_deadline(
                        self, e, e.last_step_wall, now)
        return finished

    @staticmethod
    def _dispatch_one(e: LLMEngine):
        """Worker body: issue the engine's iteration and absorb its
        device wait here, off the control-plane thread.  Engine state is
        instance-local, so workers never contend.  The measured wall time
        (dispatch + device wait) feeds the straggler step-deadline check;
        the write is engine-local, read post-collect on the control
        plane."""
        t0 = time.monotonic()
        e.dispatch_iteration()
        e.sync()
        e.last_step_wall = time.monotonic() - t0

    def _collect(self, e: LLMEngine, now: float,
                 force_sync: bool = False) -> List[Request]:
        """Collect one engine and close the control-plane feedback loops."""
        done = e.collect(force_sync=force_sync)
        if e.poll_oom() and self.oom_feedback:
            # §6 adaptive: a real OOM/preemption fences the instance for a
            # cooldown so the dispatcher stops stacking load on it
            self.dispatcher.on_oom(e.instance_id, now)
        for r in done:
            # a recovered request's replayed prefix is re-emitted and its
            # original prompt identity restored BEFORE the completion
            # record — downstream sees it as if no crash had happened
            self.recovery.on_finish(r)
            self.orch.on_completion(CompletionRecord(
                agent_name=r.agent_name, msg_id=r.msg_id,
                upstream_name=r.upstream_name, app_name=r.app_name,
                start_time=r.arrival_time, end_time=r.finish_time,
                prompt_len=r.prompt_len, output_len=r.output_len,
                exec_start_time=r.exec_start_time,
                first_token_time=r.first_token_time))
            self.dispatcher.on_finish(r.instance_id, r.req_id)
        return done

    # -------------------------------------------------------------- elasticity
    @property
    def n_instances(self) -> int:
        return len(self.engines)

    def attach_autoscaler(self, autoscaler) -> None:
        """Let an autoscaler drive :meth:`scale_up` / :meth:`scale_down`."""
        raise NotImplementedError(
            f"the autoscaler is not ported yet {_MIGRATION}")

    def scale_up(self, engine: Optional[LLMEngine] = None,
                 now: Optional[float] = None,
                 role: Optional[str] = None) -> int:
        """Add one instance and start routing to it.  With no ``engine``
        given, the config-derived factory mints one (fresh instance_id,
        shared params, private KV pool).  Returns the instance id."""
        from repro_torch.core.dispatcher import InstanceModel
        if engine is None:
            assert self._engine_factory is not None, \
                "scale_up needs an engine_factory (build the cluster via " \
                "from_config) or an explicit engine"
            if role is None:
                engine = self._engine_factory(max(self._by_id) + 1)
            else:
                engine = self._engine_factory(max(self._by_id) + 1,
                                              role=role)
        _require_ported_role(engine)
        iid = engine.instance_id
        assert iid not in self._by_id, f"instance id {iid} already live"
        assert all(engine.runner is not e.runner for e in self.engines), \
            "new engine must own its runner (pools are per-instance)"
        self.engines.append(engine)
        self._by_id[iid] = engine
        engine.faults = self.faults
        self.dispatcher.add_instance(
            InstanceModel(iid, engine.kv_capacity_tokens, role=engine.role))
        self._resize_pool()
        if self.tracer.enabled:
            self.tracer.emit("scale-up", instance_id=iid,
                             ts=self.clock() if now is None else now,
                             n=len(self.engines), role=engine.role)
        return iid

    def scale_down(self, instance_id: int,
                   now: Optional[float] = None) -> List[Request]:
        """Retire one instance by draining it through live migration."""
        raise NotImplementedError(
            f"scale_down needs live migration, not ported yet {_MIGRATION}")

    def discard_engine(self, engine: LLMEngine):
        """Forget a DEAD engine (crash path, called by
        :class:`RecoveryManager`): unlike a scale-down nothing is
        collected or migrated — the engine's pool and scheduler state are
        untrusted after a mid-dispatch death; its requests are
        reconstructed from host-side truth instead.  The cluster holds no
        other reference to the engine, so its pool is freed once the
        caller lets go of it."""
        assert self.engines != [engine], \
            "every instance crashed — nothing left to recover onto"
        self.engines.remove(engine)
        self._by_id.pop(engine.instance_id, None)
        self._resize_pool()

    def _resize_pool(self):
        """Dispatch workers are one-per-engine; rebuild the pool lazily
        after the engine set changes."""
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    # ----------------------------------------------------------------- metrics
    @staticmethod
    def metrics_label(e: LLMEngine) -> str:
        """Snapshot prefix for one engine: role-typed instances carry
        their role (``decode2.*``); general instances keep the flat
        ``engine<i>.`` prefix."""
        return (f"engine{e.instance_id}" if e.role == "general"
                else f"{e.role}{e.instance_id}")

    def metrics_snapshot(self) -> dict:
        """The cluster's observable state, flattened to one dict: every
        engine's counters under per-role instance prefixes
        (:meth:`metrics_label`) plus cluster aggregates (``queue_depth``,
        ``n_instances``, the recovery counters, ``n_faults_fired``)."""
        snap = merge_snapshots({self.metrics_label(e): e.metrics_snapshot()
                                for e in self.engines})
        snap["queue_depth"] = float(len(self.balancer.queue))
        snap["n_instances"] = float(len(self.engines))
        for k, v in self.recovery.metrics().items():
            snap[k] = float(v)
        snap["n_faults_fired"] = float(self.faults.n_fired
                                       if self.faults is not None else 0)
        return snap

    # ------------------------------------------------------------------ drains
    def drain(self, max_steps: int = 100_000,
              idle_sleep: float = 0.0) -> List[Request]:
        """Run the cluster until all submitted work has completed and
        return every finished request."""
        return self.run_until_drained(max_steps, idle_sleep)

    def run_until_drained(self, max_steps: int = 100_000,
                          idle_sleep: float = 0.0) -> List[Request]:
        """Step until queue + engines are empty; returns all finishers."""
        out: List[Request] = []
        for _ in range(max_steps):
            done = self.step()
            out.extend(done)
            if not self.has_work:
                break
            if not done and idle_sleep:
                time.sleep(idle_sleep)
        return out

    def close(self):
        """Shut down the dispatch worker pool (idempotent)."""
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None
