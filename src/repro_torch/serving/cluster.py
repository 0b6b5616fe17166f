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
  reconstructed with bit-identical replay.  An optional
  :class:`~repro_torch.serving.recovery.LoadShedder` (``config.slo_e2e_s``)
  sheds deadline-hopeless requests under sustained overload.

* **Elasticity and disaggregation** — :meth:`scale_down` drains an
  instance through live migration (``serving/migration.py``), an
  attached autoscaler (``serving/autoscaler.py``) drives
  :meth:`scale_up` / :meth:`scale_down`, and ``"prefill"``-role
  instances hand their prefilled requests to decode instances
  (``serving/handoff.py``).  KV moves through host memory, and every
  transfer runs on this thread between synced iterations: no dispatch
  thread is mid-step on either engine of a transfer.

Not ported yet, and raising ``NotImplementedError`` naming their
``ROADMAP.md`` item when reached: tensor-parallel mesh slices
(``on_mesh_slices``, ``model_parallel > 1``).
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
from repro_torch.serving.recovery import LoadShedder, RecoveryManager
from repro_torch.serving.request import CompletionRecord, Request

_TENSOR_PARALLEL = "(ROADMAP.md Queue 1 item 1)"


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
        # from_config; manual clusters may pass their own); the autoscaler
        # is attached post-construction and consulted at step start.
        self._engine_factory = engine_factory
        self.autoscaler = None
        self.config: Optional[ServingConfig] = None
        self.n_migrations = 0
        self.migrated_bytes = 0
        self.migration_dispatches = 0   # gathered write_blocks calls spent
        #                                 on migrations (batched: <= requests)
        # prefill→decode disaggregation accounting (serving/handoff.py)
        self.n_handoffs = 0
        self.handoff_bytes = 0
        self.handoff_dispatches = 0
        self.n_stranded = 0
        self.n_strand_retries = 0
        # fault plane: one injector consumes the plan across the whole
        # run (per-instance ordinals live in the injector); the recovery
        # manager is always live — crashes need no opt-in — and the
        # shedder only exists when config.slo_e2e_s arms the valve
        # (from_config replaces both with config-tuned instances)
        self.faults: Optional[FaultInjector] = (
            FaultInjector(faults, tracer) if isinstance(faults, FaultPlan)
            else faults)
        for e in self.engines:
            e.faults = self.faults
        self.recovery = RecoveryManager(tracer=tracer)
        self.shedder: Optional[LoadShedder] = None
        self._shed_at_submit: List[Request] = []
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
        """Tune recovery to the config's budgets and arm the overload
        valve when ``slo_e2e_s`` declares a deadline.  The shedder prices
        service time with the default :class:`CostModel` — the same rule
        the sim sheds by."""
        self.recovery = RecoveryManager(
            max_retries=config.recovery_retries,
            backoff_s=config.recovery_backoff_s,
            step_deadline_s=config.step_deadline_s, tracer=tracer)
        if config.slo_e2e_s is not None:
            from repro_torch.sim.cost_model import CostModel
            self.shedder = LoadShedder(
                slo_e2e_s=config.slo_e2e_s, cost=CostModel(),
                queue_high=config.shed_queue_high,
                kv_high=config.shed_kv_high,
                patience=config.shed_patience, tracer=tracer)

    # ----------------------------------------------------------- public surface
    #
    # ``submit()`` / ``step()`` / ``drain()`` / ``metrics_snapshot()`` are
    # THE cluster contract: everything a driver (Workflow, benchmarks,
    # autoscaler policies) needs.  ``balancer`` / ``engines`` /
    # ``dispatcher`` are internals (engines appear and disappear at
    # runtime under elasticity).

    def submit(self, req: Request):
        """Accept a request into the cluster.  The request is queued at
        the load balancer and placed onto an instance by a subsequent
        :meth:`step`; completion surfaces in that step's return value
        (and via ``orchestrator.on_completion``).  Valid at any time,
        including while the autoscaler is resizing the cluster.

        When the overload valve is armed AND open (sustained overload),
        a request whose deadline is already unreachable is shed at the
        door instead of queued — it surfaces, state ``SHED``, in the
        next step's finishers so drivers unblock."""
        if (self.shedder is not None and self.shedder.open
                and self.shedder.slack(req, self.clock()) < 0.0):
            self.shedder.shed(req, self.clock(), len(self.balancer.queue))
            self._shed_at_submit.append(req)
            return
        self.balancer.enqueue(req)

    def can_admit(self, instance_id: int, req: Request) -> bool:
        """Dispatcher admit probe: the instance scheduler's own admission
        predicate (batch slot + watermarked prompt memory), matching the
        simulator's dispatch semantics."""
        return self._by_id[instance_id].sched.can_admit(req)

    @property
    def has_work(self) -> bool:
        return (bool(self.balancer.queue) or self.recovery.pending > 0
                or bool(self._shed_at_submit)
                or any(e.sched.has_work or e.has_pending
                       for e in self.engines))

    # ---------------------------------------------------------------- stepping
    ROLE_STEP_ORDER = ("prefill", "general", "decode")

    def _role_groups(self) -> List[List[LLMEngine]]:
        """Engines grouped by role in step order: prefill groups first so
        their just-completed prompts hand off at this step's end, decode
        last so adopted requests decode at the earliest next step.  A
        flat cluster is exactly one "general" group."""
        groups = []
        for role in self.ROLE_STEP_ORDER:
            g = [e for e in self.engines if e.role == role]
            if g:
                groups.append(g)
        return groups

    def step(self, now: Optional[float] = None) -> List[Request]:
        """One cluster iteration: balance, run every role group
        breadth-first, then sweep prefill→decode handoffs.

        Pipelined mode issues a whole group's engine dispatches before
        the group's first collect, one worker thread per engine: while
        engine *i*'s fused iteration computes, the other workers
        plan/flatten/launch theirs, and each worker absorbs its own
        device wait.  Collect then runs on this thread in engine order
        and never blocks (tokens arrive host-resident).  Serial mode
        steps engines one at a time with a forced host sync.

        After every group has collected (all pools synced — the only
        legal transfer point), requests that completed prefill on a
        prefill-role instance are handed to decode-capable instances
        (``serving/handoff.py``), one gathered ``write_blocks`` per
        (source, target) batch."""
        now = self.clock() if now is None else now
        finished: List[Request] = []
        if self._shed_at_submit:
            # requests shed at the submit door surface here so callers
            # waiting on step() results unblock
            finished.extend(self._shed_at_submit)
            self._shed_at_submit.clear()
        self.recovery.tick(self, now)
        if self.autoscaler is not None:
            # engines are synced between steps, which is exactly when
            # live migration (scale-down drain) is legal
            finished.extend(self.autoscaler.step(self, now))
        if self.shedder is not None:
            finished.extend(self._shed_sweep(now))
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
        if any(e.role == "prefill" for e in self.engines):
            from repro_torch.serving.handoff import drive_handoffs
            hs = drive_handoffs(self, now)
            self.n_handoffs += hs["n_handoffs"]
            self.handoff_bytes += hs["handoff_bytes"]
            self.handoff_dispatches += hs["handoff_dispatches"]
            self.n_stranded += hs["n_stranded"]
            self.n_strand_retries += hs["n_strand_retries"]
            for e in self.engines:
                if e.role != "decode" or not e.sched.waiting:
                    continue
                # a decode instance's waiting queue can only hold requests
                # it preempted (admission is adopt-only), and its role gate
                # would never re-admit them: recompute belongs on a
                # prefill-capable instance, so route them back through the
                # balancer (preemption already reset their phase)
                for req in list(e.sched.waiting):
                    e.sched.release(req)
                    self.dispatcher.on_finish(e.instance_id, req.req_id)
                    self.balancer.enqueue(req)
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
        """Let ``autoscaler`` drive :meth:`scale_up` / :meth:`scale_down`:
        its ``step(cluster, now)`` runs at the start of every cluster step
        (engines synced — the only point where migration is legal)."""
        self.autoscaler = autoscaler

    def scale_up(self, engine: Optional[LLMEngine] = None,
                 now: Optional[float] = None,
                 role: Optional[str] = None) -> int:
        """Add one instance and start routing to it.  With no ``engine``
        given, the config-derived factory mints one (fresh instance_id,
        shared params, private KV pool); ``role`` pins the new instance to
        a disaggregation pool (the autoscaler grows each role pool
        independently).  Returns the instance id."""
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
        """Retire one instance by DRAINING it through live migration —
        no request loses progress:

        1. its in-flight iteration (if any) is collected first, so
           completions are never dropped;
        2. the instance leaves the dispatcher — no new placements, and
           any OOM fence dies with it (a later :meth:`scale_up` reusing
           the id starts unfenced);
        3. waiting (not-yet-prefilled) requests requeue at the balancer;
        4. running requests live-migrate to surviving instances — every
           request bound for the same target moves in ONE gathered
           ``write_blocks`` (:func:`~repro_torch.serving.migration.
           migrate_many`; continued token streams are bit-identical — see
           ``serving/migration.py``); if no instance can adopt one, it
           falls back to preempt-and-requeue (recompute).

        Returns the requests the step-1 collect finished."""
        from repro_torch.core.dispatcher import role_accepts
        from repro_torch.serving.migration import (
            MigrationError,
            migrate_many,
        )
        assert len(self.engines) > 1, "cannot scale below one instance"
        now = self.clock() if now is None else now
        e = self._by_id[instance_id]
        finished: List[Request] = []
        if e.has_pending:
            finished.extend(self._collect(e, now))
        removed = self.dispatcher.remove_instance(instance_id)
        # releasing/preempting one request can cascade-preempt COW-
        # entangled neighbours from running into waiting, so drain both
        # queues to a fixed point rather than snapshotting either once
        while e.sched.has_work:
            for req in list(e.sched.waiting):
                e.sched.release(req)
                removed.ramps.pop(req.req_id, None)
                self.balancer.enqueue(req)
            if not e.sched.running:
                continue
            req = e.sched.running[0]
            target = self._pick_migration_target(instance_id, req)
            snaps = []
            if target is not None:
                batch = [r for r in e.sched.running
                         if role_accepts(target.role, r)]
                d0 = target.runner.n_dispatches
                try:
                    snaps, _ = migrate_many(e, target, batch, now)
                except MigrationError:
                    snaps = []
                if snaps:
                    self.n_migrations += len(snaps)
                    self.migrated_bytes += sum(s.n_bytes for s in snaps)
                    self.migration_dispatches += \
                        target.runner.n_dispatches - d0
                for s in snaps:
                    self.dispatcher.adopt_ramp(
                        target.instance_id, s.req.req_id,
                        removed.ramps.pop(s.req.req_id, None))
                    if self.tracer.enabled:
                        self.tracer.emit(
                            "migrate-candidate", req_id=s.req.req_id,
                            agent=s.req.agent_name, msg_id=s.req.msg_id,
                            ts=now, to=target.instance_id,
                            reason="scale-down", n_bytes=s.n_bytes)
            if not snaps and req in e.sched.running:
                # nowhere to adopt it: recompute-requeue (progress reset)
                e.sched.preempt(req)
                e.sched.release(req)
                e.drop_pending_token(req.req_id)
                removed.ramps.pop(req.req_id, None)
                self.balancer.enqueue(req)
        assert not e.sched.has_work and not e.has_pending
        self.engines.remove(e)
        del self._by_id[instance_id]
        self._resize_pool()
        if self.tracer.enabled:
            self.tracer.emit("scale-down", instance_id=instance_id, ts=now,
                             n=len(self.engines), role=e.role)
        return finished

    def _pick_migration_target(self, exclude: int,
                               req: Request) -> Optional[LLMEngine]:
        """Best surviving adopter: most free KV blocks wins; fenced
        (recently-OOMed) instances lose ties to unfenced ones.  On a
        role-typed cluster only role-compatible instances qualify (a
        decode-phase request may not land on a prefill instance, a
        mid-prefill one never on a decode instance)."""
        from repro_torch.core.dispatcher import role_accepts
        now = self.clock()
        best, best_key = None, None
        for e in self.engines:
            if e.instance_id == exclude or not role_accepts(e.role, req) \
                    or not e.sched.can_adopt(req):
                continue
            key = (not self.dispatcher.is_fenced(e.instance_id, now),
                   e.bm.free_blocks + e.bm.cached_blocks)
            if best_key is None or key > best_key:
                best, best_key = e, key
        return best

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

    def _shed_sweep(self, now: float) -> List[Request]:
        """Overload valve sweep: feed the shedder the SAME queue-depth /
        KV-pressure signals the autoscaler scales on, then shed its
        victims out of the balancer queue."""
        from repro_torch.serving.autoscaler import signals_from_cluster
        sig = signals_from_cluster(self, now)
        max_kv = max((i.kv_used_frac for i in sig.instances), default=0.0)
        if not self.shedder.observe(len(self.balancer.queue),
                                    len(self.engines), max_kv):
            return []
        victims = self.shedder.select(self.balancer.queue, now,
                                      len(self.engines))
        if not victims:
            return []
        depth = len(self.balancer.queue)
        gone = {r.req_id for r in victims}
        self.balancer.queue = [r for r in self.balancer.queue
                               if r.req_id not in gone]
        for r in victims:
            self.shedder.shed(r, now, depth)
        return victims

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
        their role (``prefill1.*``, ``decode2.*``); general instances keep
        the flat ``engine<i>.`` prefix."""
        return (f"engine{e.instance_id}" if e.role == "general"
                else f"{e.role}{e.instance_id}")

    def metrics_snapshot(self) -> dict:
        """The cluster's observable state, flattened to one dict: every
        engine's counters under per-role instance prefixes
        (:meth:`metrics_label`) plus cluster aggregates (``queue_depth``,
        ``n_instances``, ``n_migrations``, ``migrated_bytes``,
        ``migration_dispatches``, the handoff counters, the recovery
        counters, ``n_faults_fired``, ``n_shed``)."""
        snap = merge_snapshots({self.metrics_label(e): e.metrics_snapshot()
                                for e in self.engines})
        snap["queue_depth"] = float(len(self.balancer.queue))
        snap["n_instances"] = float(len(self.engines))
        snap["n_migrations"] = float(self.n_migrations)
        snap["migrated_bytes"] = float(self.migrated_bytes)
        snap["migration_dispatches"] = float(self.migration_dispatches)
        snap["n_handoffs"] = float(self.n_handoffs)
        snap["handoff_bytes"] = float(self.handoff_bytes)
        snap["handoff_dispatches"] = float(self.handoff_dispatches)
        snap["n_stranded"] = float(self.n_stranded)
        snap["handoff_strand_retries"] = float(self.n_strand_retries)
        for k, v in self.recovery.metrics().items():
            snap[k] = float(v)
        snap["n_shed"] = float(self.shedder.n_shed
                               if self.shedder is not None else 0)
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
