"""The port's elastic cluster against the JAX package's.

The cases of ``tests/test_autoscaler.py`` on the port:

* the pure decision core (hysteresis, bounds, cooldown, fenced-first
  victims) on hand-built signals, with decisions equal to the JAX
  package's on the same signals;
* the real cluster on the reduced qwen3-1.7b in fp32 with the JAX weights
  carried across: ``scale_up`` mints a routable engine, ``scale_down``
  mid-flight is lossless, retiring a fenced instance keeps its
  completions and kills the fence, and the closed autoscaler loop grows
  and shrinks on a fake clock — each draining to the token streams (and
  scale history) of the JAX package's same run;
* the simulator's elastic run on a seeded bursty trace: deterministic,
  it scales, and its summary equals the JAX package's.
"""
import dataclasses
import math

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
from repro_torch.core import Orchestrator
from repro_torch.core.orchestrator import HardwareProfile
from repro_torch.models import LanguageModel, params_from_jax
from repro_torch.serving import (
    Autoscaler,
    AutoscalerConfig,
    LLMEngine,
    ServingConfig,
    reset_request_ids,
)


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jax_get_config("qwen3-1.7b").reduced(),
                               dtype="float32")
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    cfg = dataclasses.replace(get_config("qwen3-1.7b").reduced(),
                              dtype="float32")
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                             device="cpu")
    return jmodel, jparams, LanguageModel(cfg), params


# =============================================================================
# pure decision core
# =============================================================================


def _sig(now, queue=0, kv=(0.1,), fenced=(), load=None, mod=tserving):
    inst = [mod.InstanceSignal(instance_id=i, kv_used_frac=f,
                               fenced=(i in fenced),
                               load=(load[i] if load else 0.0))
            for i, f in enumerate(kv)]
    return mod.ClusterSignals(now=now, queue_depth=queue, instances=inst)


def test_scale_up_needs_patience():
    a = Autoscaler(AutoscalerConfig(max_instances=4, queue_high=2.0,
                                    up_patience=3))
    assert a.decide(_sig(0.0, queue=9)) is None
    assert a.decide(_sig(1.0, queue=9)) is None
    assert a.decide(_sig(2.0, queue=9)) == ("up", -1)
    a2 = Autoscaler(AutoscalerConfig(queue_high=2.0, up_patience=2))
    a2.decide(_sig(0.0, queue=9))
    a2.decide(_sig(1.0, queue=0))                    # calm: reset
    assert a2.decide(_sig(2.0, queue=9)) is None


def test_kv_pressure_alone_scales_up():
    a = Autoscaler(AutoscalerConfig(kv_high=0.85, up_patience=1))
    assert a.decide(_sig(0.0, queue=0, kv=(0.2, 0.9))) == ("up", -1)


def test_bounds_are_respected():
    a = Autoscaler(AutoscalerConfig(min_instances=1, max_instances=2,
                                    up_patience=1, down_patience=1))
    assert a.decide(_sig(0.0, queue=99, kv=(0.1, 0.1))) is None
    assert a.decide(_sig(1.0, queue=0, kv=(0.1,))) is None


def test_scale_down_needs_sustained_calm_and_cooldown_freezes():
    cfg = AutoscalerConfig(min_instances=1, queue_high=2.0, up_patience=1,
                           down_patience=2, cooldown_s=5.0)
    a = Autoscaler(cfg)
    assert a.decide(_sig(0.0, queue=9, kv=(0.1, 0.1))) == ("up", -1)
    a.note_action(0.0, "up", 2, 3)
    assert a.decide(_sig(1.0, kv=(0.1,) * 3)) is None
    assert a.decide(_sig(2.0, kv=(0.1,) * 3)) is None
    assert a.decide(_sig(6.0, kv=(0.1,) * 3)) == ("down", 0)


def test_pick_victim_prefers_fenced_then_least_loaded():
    sig = _sig(0.0, kv=(0.3, 0.6, 0.2), fenced=(1,), load=[5.0, 9.0, 1.0])
    assert Autoscaler.pick_victim(sig) == 1
    sig = _sig(0.0, kv=(0.3, 0.6, 0.2), load=[5.0, 9.0, 1.0])
    assert Autoscaler.pick_victim(sig) == 2


def test_decisions_equal_jax_on_a_signal_sweep():
    """One seeded sweep of signals through both packages' deciders (with
    the actions noted back): the same decisions, step by step."""
    rng = np.random.default_rng(0)
    kw = dict(min_instances=1, max_instances=4, queue_high=3.0,
              queue_low=0.5, up_patience=2, down_patience=3,
              decision_period_s=0.5, cooldown_s=1.0)
    deciders = {m: m.Autoscaler(m.AutoscalerConfig(**kw))
                for m in (jserving, tserving)}
    n = {m: 2 for m in deciders}
    out = {m: [] for m in deciders}
    for step in range(200):
        now = 0.25 * step
        queue = int(rng.integers(0, 12))
        kv = rng.uniform(0.0, 1.0, 4)
        fenced = tuple(int(i) for i in np.flatnonzero(rng.random(4) < 0.1))
        for m, a in deciders.items():
            sig = _sig(now, queue, tuple(kv[:n[m]]), fenced, mod=m)
            d = a.decide(sig)
            out[m].append(d)
            if d is not None:
                new = n[m] + (1 if d[0] == "up" else -1)
                a.note_action(now, d[0], d[1], new)
                n[m] = new
    assert out[tserving] == out[jserving]
    assert any(d is not None for d in out[tserving])


# =============================================================================
# real cluster elasticity, against the JAX package's same runs
# =============================================================================


def _orch(mod, num_blocks=32):
    if mod is jserving:
        return JaxOrchestrator(hardware=JaxHardwareProfile(
            decode_tok_per_s=20.0, kv_capacity_tokens=num_blocks * 8))
    return Orchestrator(hardware=HardwareProfile(
        decode_tok_per_s=20.0, kv_capacity_tokens=num_blocks * 8))


def _cluster(models, mod, config, **kw):
    if mod is jserving:
        return jserving.ServingCluster.from_config(
            models[0], models[1], _orch(mod, config.num_blocks), config, **kw)
    return tserving.ServingCluster.from_config(
        models[2], models[3], _orch(mod, config.num_blocks), config,
        device="cpu", **kw)


def _reqs(mod, n, max_new=4, plen=12, seed=2):
    rng = np.random.default_rng(seed)
    return [mod.Request(agent_name="a", msg_id=f"m{i}", prompt_len=plen,
                        prompt_tokens=rng.integers(0, 500, plen)
                        .astype(np.int32),
                        max_new_tokens=max_new, arrival_time=float(i))
            for i in range(n)]


def _drain(cluster, max_steps=4000):
    done = []
    for _ in range(max_steps):
        done.extend(cluster.step())
        if not cluster.has_work:
            break
    cluster.close()
    assert not cluster.has_work
    return done


def _tokens(done):
    return {q.msg_id: [int(t) for t in q.output_tokens] for q in done}


def _cfg(mod, **kw):
    base = dict(num_blocks=32, block_size=8, max_batch=2, n_instances=1,
                policy="fcfs")
    base.update(kw)
    return mod.ServingConfig(**base)


def test_scale_up_mints_routable_engine(models):
    outs = {}
    for mod in (jserving, tserving):
        mod.reset_request_ids()
        cluster = _cluster(models, mod, _cfg(mod))
        iid = cluster.scale_up()
        assert iid == 1 and cluster.n_instances == 2
        r0, r1 = (e.runner for e in cluster.engines)
        assert r0.pool is not r1.pool
        for q in _reqs(mod, 8):
            cluster.submit(q)
        done = _drain(cluster)
        assert len(done) == 8
        admitted = [e.stats.n_admitted for e in cluster.engines]
        assert all(a > 0 for a in admitted), admitted
        assert cluster.metrics_snapshot()["n_instances"] == 2.0
        outs[mod] = (_tokens(done), admitted)
    assert outs[tserving] == outs[jserving]
    # clones share the params and the step-shape signatures, not the pool
    assert r0.params is r1.params and r0.pool_address() != r1.pool_address()
    assert r0._shape_keys is r1._shape_keys


def test_scale_down_mid_flight_is_lossless(models):
    outs = {}
    for mod in (jserving, tserving):
        mod.reset_request_ids()
        cluster = _cluster(models, mod, _cfg(mod, num_blocks=64, max_batch=4,
                                             n_instances=2))
        reqs = _reqs(mod, 4, max_new=12)
        for q in reqs:
            cluster.submit(q)
        done = [r for _ in range(3) for r in cluster.step()]
        busy = max(cluster.engines, key=lambda e: len(e.sched.running))
        assert busy.sched.running
        addrs = {e.instance_id: e.runner.pool_address()
                 for e in cluster.engines}
        done += cluster.scale_down(busy.instance_id)
        assert cluster.n_instances == 1
        survivor = cluster.engines[0]
        assert survivor.runner.pool_address() == addrs[survivor.instance_id]
        done += _drain(cluster)
        assert sorted(r.msg_id for r in done) == \
            sorted(r.msg_id for r in reqs)
        snap = cluster.metrics_snapshot()
        assert snap["n_migrations"] >= 1 and snap["migrated_bytes"] > 0
        assert snap["migration_dispatches"] <= snap["n_migrations"]
        outs[mod] = (_tokens(done), {k: snap[k] for k in (
            "n_migrations", "migrated_bytes", "migration_dispatches")})
    assert outs[tserving] == outs[jserving]


def test_scale_down_clears_oom_fence_and_keeps_completions(models):
    reset_request_ids()
    cluster = _cluster(models, tserving, _cfg(tserving, num_blocks=64,
                                              max_batch=4, n_instances=2))
    victim = cluster._by_id[1]
    finisher = _reqs(tserving, 2, max_new=1)[0]
    runner_up = _reqs(tserving, 2, max_new=16)[1]
    victim.submit(finisher)
    victim.submit(runner_up)
    victim.step()
    victim.dispatch_iteration()          # in flight: the finisher finishes
    assert victim.has_pending
    now = cluster.clock()
    cluster.dispatcher.on_oom(1, now)
    assert cluster.dispatcher.is_fenced(1, now)
    finished = cluster.scale_down(1, now)
    assert finisher in finished, \
        "the in-flight iteration's completion was dropped"
    assert not cluster.dispatcher.is_fenced(1, now)
    survivor = cluster.engines[0]
    assert (runner_up in survivor.sched.running
            or runner_up in survivor.sched.waiting
            or runner_up in cluster.balancer.queue)
    fresh = LLMEngine(survivor.runner.clone(), instance_id=1, max_batch=4)
    assert cluster.scale_up(fresh, now) == 1
    assert not cluster.dispatcher.is_fenced(1, cluster.clock())
    done = _drain(cluster)
    assert runner_up in done, "requeued work must still complete"


def _closed_loop(models, mod, fused=True):
    t = {"now": 0.0}
    mod.reset_request_ids()
    cluster = _cluster(models, mod, _cfg(mod, fused_iteration=fused),
                       clock=lambda: t["now"])
    cluster.attach_autoscaler(mod.Autoscaler(mod.AutoscalerConfig(
        min_instances=1, max_instances=3, queue_high=2.0, queue_low=0.5,
        up_patience=2, down_patience=3, decision_period_s=0.2,
        cooldown_s=0.2)))
    reqs = _reqs(mod, 10, max_new=6)
    for q in reqs:
        cluster.submit(q)
    done = []
    for _ in range(4000):
        t["now"] += 0.25
        done.extend(cluster.step())
        if not cluster.has_work:
            break
    hist = cluster.autoscaler.history
    assert any(k == "up" for _, k, _, _ in hist), hist
    assert max(n for _, _, _, n in hist) >= 2
    for _ in range(200):
        t["now"] += 0.25
        done.extend(cluster.step())
        if cluster.n_instances == 1 and not cluster.has_work:
            break
    cluster.close()
    assert cluster.n_instances == 1, "calm must shrink back to min"
    assert any(k == "down" for _, k, _, _ in hist)
    assert sorted(r.msg_id for r in done) == sorted(r.msg_id for r in reqs)
    return _tokens(done), list(hist), cluster.metrics_snapshot()


def test_autoscaler_closed_loop_grows_and_shrinks(models):
    """Queue pressure grows the fleet, the calm tail shrinks it back, and
    nothing is lost — with the JAX package's streams and scale history."""
    jtoks, jhist, jsnap = _closed_loop(models, jserving)
    ttoks, thist, tsnap = _closed_loop(models, tserving)
    assert ttoks == jtoks
    assert thist == jhist
    assert tsnap["n_migrations"] == jsnap["n_migrations"]


def test_autoscaler_closed_loop_on_the_legacy_engines(models):
    """The same loop over ``fused_iteration=False`` engines (migrations
    land on legacy engines, whose decode step continues the streams)
    drains to the JAX package's fused streams."""
    jtoks, _, _ = _closed_loop(models, jserving)
    ttoks, _, _ = _closed_loop(models, tserving, fused=False)
    assert ttoks == jtoks


# =============================================================================
# simulator elasticity
# =============================================================================


def _elastic_sim(mod_sim, mod_traces, mod_serving, seed=3):
    trace = mod_traces.bursty_trace(seed=seed, duration=24.0, base_rate=2.0,
                                    burst_mult=6.0)
    cfg = trace.sim_config(
        mod_serving.ServingConfig(num_blocks=512, block_size=16,
                                  max_batch=32, policy="kairos",
                                  n_instances=2),
        autoscale=mod_serving.AutoscalerConfig(
            min_instances=2, max_instances=5, queue_high=3.0, queue_low=0.5,
            up_patience=2, down_patience=6, decision_period_s=0.25,
            cooldown_s=1.0))
    return mod_sim.Simulation(cfg).run()


def _same(a: dict, b: dict) -> bool:
    """Dict equality with NaN equal to NaN."""
    return a.keys() == b.keys() and all(
        a[k] == b[k] or (isinstance(a[k], float) and isinstance(b[k], float)
                         and math.isnan(a[k]) and math.isnan(b[k]))
        for k in a)


def test_sim_elastic_run_is_deterministic_and_scales():
    import repro.sim.simulator as jsim
    import repro.workloads.traces as jtraces
    import repro_torch.sim.simulator as tsim
    import repro_torch.workloads.traces as ttraces
    a = _elastic_sim(tsim, ttraces, tserving)
    b = _elastic_sim(tsim, ttraces, tserving)
    assert a.scale_history, "the burst must trigger scaling"
    assert any(k == "up" for _, k, _, _ in a.scale_history)
    assert a.scale_history == b.scale_history
    assert _same(a.summary(), b.summary())
    assert a.instance_seconds > 0
    s = a.summary()
    assert s["n_workflows"] > 0 and s["n_migrated"] >= 0
    j = _elastic_sim(jsim, jtraces, jserving)
    assert a.scale_history == j.scale_history
    assert a.instance_seconds == j.instance_seconds
    assert _same(s, j.summary())


def test_serving_config_is_the_jax_one():
    """The port's ServingConfig builds the same runner and engine kwargs
    as the JAX package's for the elastic knobs."""
    kw = dict(num_blocks=48, block_size=8, max_batch=3, n_instances=2,
              fused_iteration=False, donate_pool=False, slo_e2e_s=4.0,
              roles=("prefill", "decode"), handoff_retry_cap=2)
    t, j = tserving.ServingConfig(**kw), jserving.ServingConfig(**kw)
    assert t.runner_kwargs() == j.runner_kwargs()
    assert t.engine_kwargs() == j.engine_kwargs()
    assert t.disaggregated and j.disaggregated
    assert [t.role_of(i) for i in range(3)] == \
        [j.role_of(i) for i in range(3)]
    assert isinstance(t, ServingConfig)
