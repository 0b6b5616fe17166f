"""The port's fault plane against the JAX package's.

* ``FaultPlan.generate`` gives the same plan in both packages for seeds
  0-9;
* the pure cases of ``tests/test_faults_recovery.py`` run on the port's
  ``FaultInjector``, ``RecoveryManager`` (on stub clusters) and
  ``LoadShedder`` (priced by the port's ``CostModel``);
* crash storms on a real 3-instance port cluster (reduced qwen3-1.7b,
  fp32, the JAX weights carried across) lose no request, duplicate none,
  and every recovered stream equals the JAX package's fault-free drain;
  the crashed instances' KV pools are freed;
* a port cluster with ``slo_e2e_s`` set tight under a burst sheds the
  same requests as the JAX package's cluster and completes every other
  one with the same stream.
"""
import dataclasses
import gc
import weakref

import jax
import numpy as np
import pytest

from repro import serving as jserving
from repro.configs import get_config as jax_get_config
from repro.core import Orchestrator as JaxOrchestrator
from repro.core.orchestrator import HardwareProfile as JaxHardwareProfile
from repro.models import build_model as jax_build_model
from repro_torch import serving as tserving
from repro_torch.configs import get_config
from repro_torch.core import HardwareProfile, Orchestrator
from repro_torch.models import LanguageModel, params_from_jax
from repro_torch.sim.cost_model import CostModel
from repro_torch.serving import (
    DispatchEffects,
    FaultInjector,
    FaultPlan,
    FaultSpec,
    LoadShedder,
    RecoveryManager,
    Request,
    RequestState,
)


# =============================================================================
# pure: plans and injectors
# =============================================================================


@pytest.mark.parametrize("seed", range(10))
def test_fault_plan_generation_equals_jax(seed):
    kw = dict(horizon=16, n_crashes=2, n_straggles=3, n_ooms=2,
              n_transfer_faults=1, spare=(0,))
    port = FaultPlan.generate(seed, [0, 1, 2, 3], **kw)
    ref = jserving.FaultPlan.generate(seed, [0, 1, 2, 3], **kw)
    assert ([dataclasses.astuple(s) for s in port.specs]
            == [dataclasses.astuple(s) for s in ref.specs])
    assert 0 not in [s.instance_id for s in port.crashes()]


def test_fault_plan_crashes_capped_by_crashable_instances():
    plan = FaultPlan.generate(3, [0, 1], n_crashes=5, spare=(0,))
    assert [s.instance_id for s in plan.crashes()] == [1]


def test_fault_injector_fires_at_planned_ordinals_and_replays():
    plan = FaultPlan((
        FaultSpec("crash", instance_id=1, step=2),
        FaultSpec("straggle", instance_id=0, step=1, delay_s=0.2, factor=3.0),
        FaultSpec("straggle", instance_id=0, step=1, delay_s=0.1, factor=2.0),
        FaultSpec("oom", instance_id=0, step=1),
        FaultSpec("transfer", instance_id=0, step=1),
    ))

    def run():
        inj = FaultInjector(plan)
        effects = [(iid, step, inj.on_dispatch(iid))
                   for step in range(4) for iid in (0, 1)]
        return inj, effects, [inj.transfer_fault(0) for _ in range(3)]

    inj, effects, transfers = run()
    by_point = {(iid, step): eff for iid, step, eff in effects}
    assert by_point[(0, 0)] == DispatchEffects()
    eff = by_point[(0, 1)]
    assert eff.oom and eff.crash is None
    assert eff.delay_s == pytest.approx(0.3)
    assert eff.factor == pytest.approx(6.0)
    assert by_point[(1, 2)].crash is not None
    assert by_point[(1, 3)].crash is None
    assert transfers[0] is None and transfers[2] is None
    assert transfers[1] is not None and transfers[1].kind == "transfer"
    assert inj.n_fired == len(plan)
    _, effects2, transfers2 = run()
    assert effects2 == effects and transfers2 == transfers


# =============================================================================
# pure: recovery manager on a stub cluster
# =============================================================================


class _StubModel:
    def __init__(self, iid):
        self.instance_id = iid
        self.fenced_until = 0.0


class _StubDispatcher:
    def __init__(self):
        self.fenced, self.removed, self._models = [], [], {}

    def on_oom(self, iid, now):
        self.fenced.append((iid, now))

    def remove_instance(self, iid):
        self.removed.append(iid)
        return self._models.setdefault(iid, _StubModel(iid))


class _StubBalancer:
    def __init__(self):
        self.queue = []

    def enqueue(self, req):
        self.queue.append(req)


class _StubSched:
    def __init__(self, running=()):
        self.waiting, self.running = [], list(running)


class _StubEngine:
    def __init__(self, iid, running):
        self.instance_id = iid
        self.sched = _StubSched(running=running)


class _StubCluster:
    def __init__(self):
        self.dispatcher = _StubDispatcher()
        self.balancer = _StubBalancer()
        self.discarded = []

    def discard_engine(self, engine):
        self.discarded.append(engine.instance_id)


def _req(msg_id, prompt, emitted=(), max_new=8, arrival=0.0):
    r = Request(agent_name="a", msg_id=msg_id, prompt_len=len(prompt),
                prompt_tokens=np.asarray(prompt, dtype=np.int32),
                max_new_tokens=max_new, arrival_time=arrival)
    r.output_tokens.extend(int(t) for t in emitted)
    r.output_len = len(r.output_tokens)
    r.prefilled_len = r.prompt_len
    return r


def test_recovery_reconstructs_with_extended_prompt_and_unwinds():
    rm = RecoveryManager(max_retries=3)
    cluster = _StubCluster()
    req = _req("m0", [1, 2, 3], emitted=[7, 8], max_new=8)
    assert rm.on_crash(cluster, _StubEngine(0, [req]), now=1.0) == []
    assert rm.n_crashes == 1 and rm.n_reconstructed == 1
    assert cluster.dispatcher.fenced == [(0, 1.0)]
    assert cluster.dispatcher.removed == [0] and cluster.discarded == [0]
    assert cluster.dispatcher._models[0].fenced_until == float("inf")
    assert cluster.balancer.queue == [req]
    assert req.state is RequestState.QUEUED
    assert list(req.prompt_tokens) == [1, 2, 3, 7, 8]
    assert req.prompt_len == 5 and req.max_new_tokens == 6
    assert req.output_len == 0 and not req.output_tokens
    assert rm.n_replayed_tokens == 2
    req.output_tokens.extend([9, 10])
    rm.on_finish(req)
    assert list(req.output_tokens) == [7, 8, 9, 10]
    assert req.prompt_len == 3 and req.max_new_tokens == 8
    assert list(req.prompt_tokens) == [1, 2, 3]


def test_recovery_retry_budget_exhausts_to_failed():
    rm = RecoveryManager(max_retries=1)
    cluster = _StubCluster()
    req = _req("m0", [1, 2, 3])
    assert rm.on_crash(cluster, _StubEngine(0, [req]), now=0.0) == []
    failed = rm.on_crash(cluster, _StubEngine(1, [req]), now=1.0)
    assert failed == [req] and req.state is RequestState.FAILED
    assert req.finish_time == 1.0 and rm.n_failed == 1
    assert len(cluster.balancer.queue) == 1


def test_recovery_backoff_delays_requeue_exponentially():
    rm = RecoveryManager(max_retries=4, backoff_s=0.5)
    cluster = _StubCluster()
    req = _req("m0", [1, 2, 3])
    rm.on_crash(cluster, _StubEngine(0, [req]), now=10.0)
    assert cluster.balancer.queue == [] and rm.pending == 1
    assert rm.backoff_deadlines == [10.5]
    rm.tick(cluster, now=10.4)
    assert cluster.balancer.queue == [] and rm.pending == 1
    rm.tick(cluster, now=10.5)
    assert cluster.balancer.queue == [req] and rm.pending == 0
    rm.on_crash(cluster, _StubEngine(1, [req]), now=20.0)
    assert rm.backoff_deadlines == [21.0]


def test_step_deadline_fences_stragglers():
    rm = RecoveryManager(step_deadline_s=0.25)
    cluster = _StubCluster()
    eng = _StubEngine(2, [])
    assert not rm.check_step_deadline(cluster, eng, elapsed_s=0.2, now=1.0)
    assert rm.check_step_deadline(cluster, eng, elapsed_s=0.9, now=2.0)
    assert cluster.dispatcher.fenced == [(2, 2.0)]
    assert rm.n_straggler_fences == 1
    assert not RecoveryManager().check_step_deadline(
        cluster, eng, elapsed_s=99.0, now=3.0)


# =============================================================================
# pure: the shedding valve
# =============================================================================


def test_shedder_opens_only_under_sustained_overload():
    sh = LoadShedder(slo_e2e_s=10.0, cost=CostModel(), queue_high=4.0,
                     patience=3)
    assert not sh.observe(99, n_instances=2, max_kv_frac=0.1)
    assert not sh.observe(99, n_instances=2, max_kv_frac=0.1)
    assert not sh.observe(0, n_instances=2, max_kv_frac=0.1)
    assert not sh.observe(99, n_instances=2, max_kv_frac=0.1)
    assert not sh.observe(99, n_instances=2, max_kv_frac=0.1)
    assert sh.observe(99, n_instances=2, max_kv_frac=0.1)
    sh2 = LoadShedder(slo_e2e_s=10.0, cost=CostModel(), patience=1)
    assert sh2.observe(1, n_instances=4, max_kv_frac=0.99)
    sh3 = LoadShedder(slo_e2e_s=10.0, cost=CostModel(), patience=1)
    assert not sh3.observe(0, n_instances=4, max_kv_frac=0.99)


def test_shedder_picks_hopeless_then_lowest_slack():
    sh = LoadShedder(slo_e2e_s=5.0, cost=CostModel(), queue_high=2.0,
                     patience=1)
    now = 100.0
    hopeless = _req("old", [1] * 8, max_new=16, arrival=now - 60.0)
    fresh = [_req(f"f{i}", [1] * 8, max_new=16, arrival=now - 0.1 * i)
             for i in range(4)]
    queue = [hopeless] + fresh
    assert sh.select(queue, now, n_instances=1) == []
    sh.observe(len(queue), n_instances=1, max_kv_frac=0.5)
    victims = sh.select(queue, now, n_instances=1)
    assert victims[0] is hopeless
    assert {v.msg_id for v in victims} == {"old", "f3", "f2"}
    sh.shed(hopeless, now, queue_depth=len(queue))
    assert hopeless.state is RequestState.SHED and sh.n_shed == 1


# =============================================================================
# real cluster: crash storms recover bit-identically
# =============================================================================


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jax_get_config("qwen3-1.7b").reduced(),
                               dtype="float32")
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    cfg = dataclasses.replace(get_config("qwen3-1.7b").reduced(),
                              dtype="float32")
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                             cfg, device="cpu")
    return jmodel, jparams, LanguageModel(cfg), params


_CHAOS = dict(num_blocks=64, block_size=8, max_batch=4, n_instances=3,
              policy="fcfs", prefix_caching=True, recovery_retries=3)


def _chaos_reqs(mod, n=8, max_new=10):
    rng = np.random.default_rng(7)
    prefix = rng.integers(0, 500, 16).astype(np.int32)
    out = []
    for i in range(n):
        toks = np.concatenate(
            [prefix, rng.integers(0, 500, 5 + (i % 9)).astype(np.int32)])
        out.append(mod.Request(agent_name=f"a{i % 3}", msg_id=f"m{i}",
                               prompt_len=len(toks), prompt_tokens=toks,
                               max_new_tokens=max_new, arrival_time=float(i)))
    return out


def _drain(cluster):
    done = []
    for _ in range(100_000):
        done.extend(cluster.step())
        if not cluster.has_work:
            break
    cluster.close()
    return done


@pytest.fixture(scope="module")
def jax_fault_free(models):
    jmodel, jparams = models[:2]
    jserving.reset_request_ids()
    cluster = jserving.ServingCluster.from_config(
        jmodel, jparams, JaxOrchestrator(hardware=JaxHardwareProfile(
            decode_tok_per_s=20.0, kv_capacity_tokens=64 * 8)),
        jserving.ServingConfig(**_CHAOS))
    for q in _chaos_reqs(jserving):
        cluster.submit(q)
    base = {r.msg_id: list(r.output_tokens) for r in _drain(cluster)}
    assert len(base) == 8
    return base


PLANS = {
    # the crash storm of tests/test_faults_recovery.py
    "crash-storm": lambda: FaultPlan.generate(5, [0, 1, 2], horizon=10,
                                              n_crashes=2, spare=(0,)),
    # the property's plans, at a few seeds
    **{f"mixed-seed{s}": (lambda s=s: FaultPlan.generate(
        s, [0, 1, 2], horizon=12, n_crashes=2, n_straggles=1, n_ooms=1,
        spare=(0,), straggle_delay_s=0.01)) for s in (0, 7, 123)},
}


@pytest.mark.parametrize("plan_name", list(PLANS))
def test_port_cluster_recovers_to_jax_fault_free_streams(
        models, jax_fault_free, plan_name):
    model, params = models[2:]
    plan = PLANS[plan_name]()
    tserving.reset_request_ids()
    cluster = tserving.ServingCluster.from_config(
        model, params, Orchestrator(hardware=HardwareProfile(
            decode_tok_per_s=20.0, kv_capacity_tokens=64 * 8)),
        tserving.ServingConfig(**_CHAOS), faults=plan, device="cpu")
    pools = {e.instance_id: weakref.ref(e.runner._pool_buf)
             for e in cluster.engines}
    for q in _chaos_reqs(tserving):
        cluster.submit(q)
    done = _drain(cluster)
    failed = [r.msg_id for r in done if r.state is RequestState.FAILED]
    assert not failed, f"requests failed under {plan.specs}: {failed}"
    streams = {}
    for r in done:
        assert r.msg_id not in streams, f"request {r.msg_id} duplicated"
        streams[r.msg_id] = [int(t) for t in r.output_tokens]
    assert set(streams) == set(jax_fault_free), "lost or extra requests"
    diverged = [m for m in streams if streams[m] != jax_fault_free[m]]
    assert not diverged, f"streams diverged for {diverged} under {plan.specs}"
    snap = cluster.metrics_snapshot()
    crashed = {s.instance_id for s in plan.crashes()}
    assert snap["n_crashes"] == len(crashed) == 2
    assert snap["n_instances"] == 1 and snap["n_recovery_failed"] == 0
    assert snap["n_reconstructed"] >= snap["n_crashes"]
    # the cluster keeps no reference to a dead engine: its pool is freed
    gc.collect()
    assert {i for i, ref in pools.items() if ref() is None} == crashed


def _ticks():
    """A clock that advances a second a read: deadlines and the valve's
    patience then do not depend on how fast either framework steps."""
    ticks = iter(range(10**6))
    return lambda: float(next(ticks))


def _shed_run(models, mod):
    mod.reset_request_ids()
    config = mod.ServingConfig(num_blocks=64, block_size=8, max_batch=2,
                               n_instances=1, policy="fcfs",
                               slo_e2e_s=40.0, shed_queue_high=3.0,
                               shed_patience=2)
    if mod is jserving:
        cluster = jserving.ServingCluster.from_config(
            models[0], models[1], JaxOrchestrator(hardware=JaxHardwareProfile(
                decode_tok_per_s=20.0, kv_capacity_tokens=64 * 8)),
            config, clock=_ticks())
    else:
        cluster = tserving.ServingCluster.from_config(
            models[2], models[3], Orchestrator(hardware=HardwareProfile(
                decode_tok_per_s=20.0, kv_capacity_tokens=64 * 8)),
            config, clock=_ticks(), device="cpu")
    reqs = _chaos_reqs(mod, n=12, max_new=6)
    for q in reqs:
        q.arrival_time = cluster.clock()
        cluster.submit(q)
    done = _drain(cluster)
    assert sorted(r.msg_id for r in done) == sorted(r.msg_id for r in reqs)
    shed = sorted(r.msg_id for r in done
                  if r.state is mod.RequestState.SHED)
    streams = {r.msg_id: [int(t) for t in r.output_tokens] for r in done
               if r.state is not mod.RequestState.SHED}
    return shed, streams, cluster.metrics_snapshot()


def test_port_cluster_sheds_like_jax_under_a_burst(models):
    jshed, jstreams, jsnap = _shed_run(models, jserving)
    tshed, tstreams, tsnap = _shed_run(models, tserving)
    assert tshed, "the burst must open the valve and shed"
    assert all(len(v) == 6 for v in tstreams.values()), \
        "every request not shed completes"
    assert tshed == jshed
    assert tstreams == jstreams
    assert tsnap["n_shed"] == jsnap["n_shed"] == len(tshed)
