"""The port under excessive load and faults, against the JAX package.

The reduced qwen3-1.7b in float32, one seeded JAX param pytree carried
across (``models/convert.py``); token streams must be identical.

* EOS: fused and legacy ``LLMEngine`` drains, roomy and with a pool
  tight enough to preempt, stop where the JAX package's engine stops
  with the same ``eos_token``: each stream is the run without EOS cut
  before the first token, after the first, that equals ``eos_token``.
* Preemption and crashes together: a 3-instance cluster whose pools
  preempt under the crash storm recovers every request to the JAX
  package's fault-free streams of the same tight cluster, and each dead
  instance's pool is freed when its engine is dropped, with the cycle
  collector off.
* OOM fences: on a tight 2-instance cluster, preemptions fence the same
  instances at the same steps as in the JAX package, and every request
  lands on the same instance.
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
from repro_torch.obs import Tracer


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


def _reqs(mod, n=8, max_new=40):
    """Shared-prefix requests (the chaos workload of
    ``tests/test_torch_faults.py``, with longer answers: their decode
    growth is what outruns a tight pool)."""
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


def _streams(done):
    out = {}
    for r in done:
        assert r.msg_id not in out, f"request {r.msg_id} duplicated"
        out[r.msg_id] = [int(t) for t in r.output_tokens]
    return out


# =============================================================================
# EOS
# =============================================================================

EOS_NEW = 16
# (fused, pool blocks): 12 blocks preempt these requests
EOS_CASES = {"fused": (True, 64), "legacy": (False, 64),
             "fused-tight": (True, 12)}


def _engine_drain(mod, runner, *, eos=-1, fused=True):
    mod.reset_request_ids()
    eng = mod.LLMEngine(runner, max_batch=4, enable_prefix_cache=True,
                        prefill_chunk_tokens=8, eos_token=eos,
                        fused_iteration=fused)
    reqs = _reqs(mod, n=6, max_new=EOS_NEW)
    for r in reqs:
        eng.submit(r)
    done = eng.run_until_drained(4000)
    assert sorted(r.msg_id for r in done) == sorted(r.msg_id for r in reqs)
    return eng, done


def _eos_cut(stream, eos):
    """The engine's stop rule on a stream decoded without EOS: a request
    finishes when the token it just sampled is ``eos``, before feeding it;
    the first token (the prompt's argmax) is never checked."""
    for i in range(1, len(stream)):
        if stream[i] == eos:
            return stream[:i]
    return stream


def _pick_eos(streams, at_least):
    """The token that stops the most streams early (ties: the smallest)."""
    count = {}
    for s in streams.values():
        for t in set(s[1:]):
            count[t] = count.get(t, 0) + 1
    eos = min(count, key=lambda t: (-count[t], t))
    assert count[eos] >= at_least, f"no token stops {at_least} streams"
    return eos


@pytest.fixture(scope="module")
def jax_eos_runs(models):
    """Per pool size: the JAX package's streams without EOS, the EOS
    token taken from them, and its (stream, length, state) per request
    with that EOS."""
    jmodel, jparams = models[:2]
    out = {}
    for nblocks in sorted({n for _, n in EOS_CASES.values()}):
        runner = jserving.PagedModelRunner(jmodel, jparams,
                                           num_blocks=nblocks, block_size=8,
                                           max_batch=4)
        _, done = _engine_drain(jserving, runner.clone())
        plain = _streams(done)
        eos = _pick_eos(plain, at_least=2)
        _, done = _engine_drain(jserving, runner.clone(), eos=eos)
        out[nblocks] = (plain, eos, {
            r.msg_id: ([int(t) for t in r.output_tokens], r.output_len,
                       r.state.name) for r in done})
    return out


@pytest.mark.parametrize("case", list(EOS_CASES))
def test_port_eos_drain_equals_jax(models, jax_eos_runs, case):
    fused, nblocks = EOS_CASES[case]
    model, params = models[2:]
    plain, eos, want = jax_eos_runs[nblocks]
    runner = tserving.PagedModelRunner(model, params, num_blocks=nblocks,
                                       block_size=8, max_batch=4,
                                       device="cpu")
    eng, done = _engine_drain(tserving, runner, eos=eos, fused=fused)
    got = {r.msg_id: ([int(t) for t in r.output_tokens], r.output_len,
                      r.state.name) for r in done}
    assert got == want
    early = [m for m, (s, n, _) in got.items() if n < EOS_NEW]
    assert len(early) >= 2, f"eos {eos} stopped {early}"
    for m, (s, n, state) in got.items():
        assert state == "FINISHED" and n == len(s)
        assert s == _eos_cut(plain[m], eos), m
    if nblocks == EOS_CASES["fused-tight"][1]:
        assert eng.stats.n_preempted > 0, "the tight pool must preempt"


# =============================================================================
# clusters: preemption with crashes, and OOM fences
# =============================================================================

TIGHT = dict(num_blocks=16, block_size=8, max_batch=4, policy="fcfs",
             prefix_caching=True, recovery_retries=3)
STEP_S = 0.25                  # the test clock's advance per cluster step


def _cluster(mod, models, n_instances, clock, faults=None, tracer=None):
    config = mod.ServingConfig(n_instances=n_instances, **TIGHT)
    if mod is jserving:
        return jserving.ServingCluster.from_config(
            models[0], models[1], JaxOrchestrator(hardware=JaxHardwareProfile(
                decode_tok_per_s=20.0, kv_capacity_tokens=16 * 8)),
            config, clock=clock, faults=faults)
    return tserving.ServingCluster.from_config(
        models[2], models[3], Orchestrator(hardware=HardwareProfile(
            decode_tok_per_s=20.0, kv_capacity_tokens=16 * 8)),
        config, clock=clock, faults=faults,
        tracer=tracer if tracer is not None else Tracer(),
        device="cpu")


def _cluster_drain(mod, models, n_instances, faults=None, tracer=None,
                   on_step=None):
    """Drain the requests on a clock that advances STEP_S a step (fences
    then expire at the same step in either package).  Returns (finished,
    the fenced instances after each step, the cluster)."""
    mod.reset_request_ids()
    t = {"now": 0.0}
    cluster = _cluster(mod, models, n_instances, lambda: t["now"], faults,
                       tracer)
    for r in _reqs(mod):
        cluster.submit(r)
    done, fenced = [], []
    for _ in range(5000):
        done.extend(cluster.step())
        if on_step is not None:
            on_step(cluster)
        t["now"] += STEP_S
        fenced.append(tuple(i for i in range(n_instances)
                            if cluster.dispatcher.is_fenced(i, t["now"])))
        if not cluster.has_work:
            break
    assert not cluster.has_work, "the cluster did not drain"
    cluster.close()
    return done, fenced, cluster


@pytest.fixture(scope="module")
def jax_tight_fault_free(models):
    done, _, _ = _cluster_drain(jserving, models, 3)
    return _streams(done)


def test_port_preempting_cluster_recovers_crash_storm(models,
                                                      jax_tight_fault_free):
    """The crash storm on pools that preempt: no request fails, is lost or
    duplicated, every stream equals the JAX package's fault-free run, and
    each crashed engine's pool is gone once the step that found the crash
    returns, with no help from the cycle collector."""
    plan = tserving.FaultPlan.generate(5, [0, 1, 2], horizon=10,
                                       n_crashes=2, spare=(0,))
    tracer = Tracer()
    pools, freed_vs_dead = {}, []

    def on_step(cluster):
        if not pools:
            pools.update({e.instance_id: weakref.ref(e.runner._pool_buf)
                          for e in cluster.engines})
        dead = set(pools) - {e.instance_id for e in cluster.engines}
        freed_vs_dead.append(({i for i, ref in pools.items()
                               if ref() is None}, dead))

    enabled = gc.isenabled()
    gc.disable()
    try:
        done, _, cluster = _cluster_drain(tserving, models, 3, plan, tracer,
                                          on_step)
    finally:
        if enabled:
            gc.enable()
    assert not [r.msg_id for r in done
                if r.state is tserving.RequestState.FAILED]
    assert _streams(done) == jax_tight_fault_free
    snap = cluster.metrics_snapshot()
    assert snap["n_crashes"] == 2 and snap["n_instances"] == 1
    assert snap["n_recovery_failed"] == 0
    assert snap["n_reconstructed"] >= 2
    kinds = [e.kind for e in tracer.events()]
    assert kinds.count("preempt") > 0, "the tight pools must preempt"
    assert kinds.count("recovery-replay") == snap["n_reconstructed"]
    # every crashed engine's pool is freed by the step that found the
    # crash, and no other pool is
    assert all(freed == dead for freed, dead in freed_vs_dead)
    assert freed_vs_dead[-1][1] == {s.instance_id for s in plan.crashes()}


def test_port_oom_fences_equal_jax(models):
    """Preemptions on a tight 2-instance cluster fence the instance for
    the dispatcher's cooldown: the fenced set after every step, each
    request's instance and every stream are the JAX package's."""
    jdone, jfenced, _ = _cluster_drain(jserving, models, 2)
    tracer = Tracer()
    done, fenced, cluster = _cluster_drain(tserving, models, 2,
                                           tracer=tracer)
    assert fenced == jfenced
    assert any(fenced), "the tight pools must preempt and fence"
    assert ({r.msg_id: r.instance_id for r in done}
            == {r.msg_id: r.instance_id for r in jdone})
    assert _streams(done) == _streams(jdone)
    kinds = [e.kind for e in tracer.events()]
    assert 0 < kinds.count("oom-fence") <= kinds.count("preempt")
