"""The port's multi-instance ``ServingCluster`` against the JAX package's.

On the reduced qwen3-1.7b in fp32, with the JAX weights carried across:

* the port's pipelined cluster (one dispatch worker per engine) drains
  token-identically to its serial loop, and both to
  ``repro.serving.ServingCluster`` on the same requests — with prefix
  caching and 16-token chunks, and in a 12-block pool that preempts;
* the pipelined loop issues every dispatch before the first collect
  (a barrier the serial loop could never pass), and the serial loop
  interleaves them;
* OOM feedback: a real preemption fences the instance through
  ``dispatcher.on_oom``; ``oom_feedback=False`` leaves fencing dead;
* the dispatcher's admit probe is ``BatchScheduler.can_admit``;
* engines sharing one runner are refused;
* ``from_config`` builds legacy (``fused_iteration=False``) and
  out-of-place (``donate_pool=False``) clusters that drain to the JAX
  package's streams, and arms the load shedder for ``slo_e2e_s``;
* the tensor-parallel paths the port defers raise
  ``NotImplementedError`` naming their ``ROADMAP.md`` item.
"""
import dataclasses
import threading
import time

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


@pytest.fixture(scope="module")
def models():
    """(JAX model, JAX params, port model, port params): the reduced
    qwen3-1.7b in fp32, the port's weights carried over from the JAX
    pytree."""
    jcfg = dataclasses.replace(jax_get_config("qwen3-1.7b").reduced(),
                               dtype="float32")
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    cfg = dataclasses.replace(get_config("qwen3-1.7b").reduced(),
                              dtype="float32")
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                             cfg, device="cpu")
    return jmodel, jparams, LanguageModel(cfg), params


def _reqs(mod, seed=11, sys_len=16, n=6, uniq=7, max_new=4):
    """Shared-prefix requests (full-block cached prefix when caching on)."""
    rng = np.random.default_rng(seed)
    sys_toks = rng.integers(0, 500, sys_len).astype(np.int32)
    reqs = []
    for i in range(n):
        toks = np.concatenate(
            [sys_toks, rng.integers(0, 500, uniq + i).astype(np.int32)])
        reqs.append(mod.Request(agent_name="a", msg_id=f"m{i}",
                                prompt_len=len(toks), prompt_tokens=toks,
                                max_new_tokens=max_new))
    return reqs


def _port_cluster(models, *, n_instances=2, num_blocks=64, cache=False,
                  chunk=None, pipelined=True, **kw):
    model, params = models[2:]
    runner0 = tserving.PagedModelRunner(model, params, num_blocks=num_blocks,
                                        block_size=8, max_batch=4,
                                        device="cpu")
    engines = [
        tserving.LLMEngine(runner0 if i == 0 else runner0.clone(),
                           instance_id=i, max_batch=4,
                           enable_prefix_cache=cache,
                           prefill_chunk_tokens=chunk)
        for i in range(n_instances)]
    orch = Orchestrator(hardware=HardwareProfile(
        decode_tok_per_s=20.0, kv_capacity_tokens=num_blocks * 8))
    return tserving.ServingCluster(engines, orch, pipelined=pipelined, **kw)


def _jax_cluster(models, *, n_instances=2, num_blocks=64, cache=False,
                 chunk=None, **kw):
    model, params = models[:2]
    runner0 = jserving.PagedModelRunner(model, params, num_blocks=num_blocks,
                                        block_size=8, max_batch=4)
    engines = [
        jserving.LLMEngine(runner0 if i == 0 else runner0.clone(),
                           instance_id=i, max_batch=4,
                           enable_prefix_cache=cache,
                           prefill_chunk_tokens=chunk)
        for i in range(n_instances)]
    orch = JaxOrchestrator(hardware=JaxHardwareProfile(
        decode_tok_per_s=20.0, kv_capacity_tokens=num_blocks * 8))
    return jserving.ServingCluster(engines, orch, **kw)


def _ticks():
    """A control-plane clock that advances a second a read: the
    dispatcher's memory ramps expire between steps whatever the host's
    speed, so admission (and so preemption) does not depend on how fast
    either framework steps."""
    ticks = iter(range(10**6))
    return lambda: float(next(ticks))


def _drain(cluster, reqs, max_steps=4000):
    pending = list(reqs)
    done = []
    for _ in range(max_steps):
        if pending:
            r = pending.pop(0)
            r.arrival_time = cluster.clock()
            cluster.submit(r)
        done.extend(cluster.step())
        if not pending and not cluster.has_work:
            break
    cluster.close()
    assert not cluster.has_work, "cluster failed to drain"
    return sorted((r.msg_id, tuple(int(t) for t in r.output_tokens))
                  for r in done)


MIXES = {
    # name: (cluster kwargs, request kwargs)
    "prefix-cache-chunk16": (dict(n_instances=2, cache=True, chunk=16), {}),
    "preemption-12-blocks": (dict(n_instances=2, num_blocks=12, cache=False,
                                  chunk=8),
                             dict(seed=3, sys_len=8, n=6, uniq=2,
                                  max_new=24)),
}


@pytest.fixture(scope="module")
def port_drains(models):
    """Per mix: (serial streams, pipelined streams, preemptions in the
    serial run)."""
    out = {}
    for mix, (ckw, rkw) in MIXES.items():
        tserving.reset_request_ids()
        serial_cluster = _port_cluster(models, pipelined=False,
                                       clock=_ticks(), **ckw)
        serial = _drain(serial_cluster, _reqs(tserving, **rkw))
        n_preempted = sum(e.stats.n_preempted for e in serial_cluster.engines)
        tserving.reset_request_ids()
        pipelined = _drain(_port_cluster(models, pipelined=True,
                                         clock=_ticks(), **ckw),
                           _reqs(tserving, **rkw))
        out[mix] = (serial, pipelined, n_preempted)
    return out


@pytest.mark.parametrize("mix", list(MIXES))
def test_port_pipelined_cluster_equals_serial(port_drains, mix):
    serial, pipelined, n_preempted = port_drains[mix]
    assert len(serial) == 6
    assert pipelined == serial
    if mix.startswith("preemption"):
        assert n_preempted > 0, "the mix must actually preempt"


@pytest.mark.parametrize("mix", list(MIXES))
def test_port_cluster_equals_jax_cluster(models, port_drains, mix):
    ckw, rkw = MIXES[mix]
    jserving.reset_request_ids()
    jax_out = _drain(_jax_cluster(models, clock=_ticks(), **ckw),
                     _reqs(jserving, **rkw))
    assert port_drains[mix][1] == jax_out


# =============================================================================
# dispatch overlap guard
# =============================================================================


def _seed_engines(cluster):
    for i, e in enumerate(cluster.engines):
        rng = np.random.default_rng(i)
        e.submit(tserving.Request(
            agent_name="a", msg_id=f"g{i}", prompt_len=12,
            prompt_tokens=rng.integers(0, 500, 12).astype(np.int32),
            max_new_tokens=2))


def test_pipelined_issues_all_dispatches_before_first_collect(models):
    """Both engines' dispatches are in flight together before any
    collect: each dispatch waits on a 2-party barrier, which a serial
    dispatch->collect->dispatch loop would never pass."""
    cluster = _port_cluster(models, n_instances=2)
    barrier = threading.Barrier(2)
    events = []
    lock = threading.Lock()
    for e in cluster.engines:
        orig_d, orig_c = e.dispatch_iteration, e.collect

        def dispatch(e=e, f=orig_d):
            barrier.wait(timeout=30)
            with lock:
                events.append(("dispatch", e.instance_id))
            return f()

        def collect(force_sync=False, e=e, f=orig_c):
            with lock:
                events.append(("collect", e.instance_id))
            return f(force_sync=force_sync)

        e.dispatch_iteration = dispatch
        e.collect = collect
    _seed_engines(cluster)
    cluster.step()
    cluster.close()
    kinds = [k for k, _ in events]
    assert kinds.index("collect") == 2, \
        f"all dispatches must precede the first collect: {events}"
    assert kinds.count("dispatch") == 2 and kinds.count("collect") == 2


def test_serial_mode_interleaves_dispatch_and_collect(models):
    cluster = _port_cluster(models, n_instances=2, pipelined=False)
    events = []
    for e in cluster.engines:
        orig_d, orig_c = e.dispatch_iteration, e.collect
        e.dispatch_iteration = (lambda e=e, f=orig_d:
                                (events.append(("dispatch", e.instance_id)),
                                 f())[1])
        e.collect = (lambda force_sync=False, e=e, f=orig_c:
                     (events.append(("collect", e.instance_id)),
                      f(force_sync=force_sync))[1])
    _seed_engines(cluster)
    cluster.step()
    assert events == [("dispatch", 0), ("collect", 0),
                      ("dispatch", 1), ("collect", 1)]


# =============================================================================
# control-plane feedback
# =============================================================================


def _pressure_reqs(n=5, max_new=12):
    rng = np.random.default_rng(7)
    return [tserving.Request(
        agent_name="a", msg_id=f"p{i}", prompt_len=14,
        prompt_tokens=rng.integers(0, 500, 14).astype(np.int32),
        max_new_tokens=max_new) for i in range(n)]


@pytest.mark.parametrize("oom_feedback", [True, False])
def test_preemption_fences_instance_via_on_oom(models, oom_feedback):
    """A real preemption reaches ``dispatcher.on_oom`` and fences the
    instance (§6 adaptive); with ``oom_feedback=False`` (serial loop)
    preemptions happen but nothing is ever fenced."""
    tserving.reset_request_ids()
    cluster = _port_cluster(models, n_instances=1, num_blocks=12,
                            pipelined=oom_feedback,
                            oom_feedback=oom_feedback, clock=_ticks())
    for r in _pressure_reqs():
        r.arrival_time = cluster.clock()
        cluster.submit(r)
    fenced_seen = False
    for _ in range(2000):
        cluster.step()
        fenced_seen = fenced_seen or cluster.dispatcher.is_fenced(
            0, cluster.clock())
        if not cluster.has_work:
            break
    assert cluster.engines[0].stats.n_preempted > 0, \
        "workload must actually exercise preemption"
    assert fenced_seen == oom_feedback


def test_admit_probe_is_can_admit_watermark(models):
    """An instance whose pool is nearly committed refuses a new prompt
    though a queue-length probe (running + waiting < max_batch) would
    admit it, and the dispatcher keeps the request queued."""
    tserving.reset_request_ids()
    cluster = _port_cluster(models, n_instances=1, num_blocks=16)
    e = cluster.engines[0]
    rng = np.random.default_rng(1)
    for i in range(2):
        e.submit(tserving.Request(
            agent_name="a", msg_id=f"big{i}", prompt_len=44,
            prompt_tokens=rng.integers(0, 500, 44).astype(np.int32),
            max_new_tokens=16))
    cluster.step()
    assert len(e.running) == 2
    probe = tserving.Request(
        agent_name="a", msg_id="probe", prompt_len=20,
        prompt_tokens=rng.integers(0, 500, 20).astype(np.int32),
        max_new_tokens=4)
    assert len(e.running) + len(e.waiting) < e.max_batch
    assert cluster.can_admit(0, probe) is False
    assert cluster.dispatcher.admit_probe == cluster.can_admit
    probe.arrival_time = time.monotonic()
    cluster.submit(probe)
    cluster.step()
    assert probe in cluster.balancer.queue


def test_cluster_rejects_engines_sharing_a_runner(models):
    model, params = models[2:]
    runner = tserving.PagedModelRunner(model, params, num_blocks=16,
                                       block_size=8, max_batch=2,
                                       device="cpu")
    engines = [tserving.LLMEngine(runner, instance_id=i, max_batch=2)
               for i in range(2)]
    orch = Orchestrator(hardware=HardwareProfile(
        decode_tok_per_s=20.0, kv_capacity_tokens=128))
    with pytest.raises(AssertionError, match="share a PagedModelRunner"):
        tserving.ServingCluster(engines, orch)


def test_serving_config_matches_jax():
    """The port's ``ServingConfig`` is the reference's: the same fields
    and defaults, the same sim field map and roles, the same consumer
    kwargs."""
    port, ref = tserving.ServingConfig(), jserving.ServingConfig()
    assert ([(f.name, f.default) for f in dataclasses.fields(port)]
            == [(f.name, f.default) for f in dataclasses.fields(ref)])
    assert tserving.SIM_FIELD_MAP == jserving.SIM_FIELD_MAP
    assert tserving.ROLES == jserving.ROLES
    kw = dict(n_instances=3, roles=["general", "decode", "general"],
              prefill_chunk_tokens=32, prefix_caching=True)
    port, ref = tserving.ServingConfig(**kw), jserving.ServingConfig(**kw)
    assert port.runner_kwargs() == ref.runner_kwargs()
    assert port.engine_kwargs() == ref.engine_kwargs()
    assert [port.role_of(i) for i in range(4)] == \
        [ref.role_of(i) for i in range(4)]


def test_pending_token_surface(models):
    """``pending_token`` is None mid-prefill, then the sampled-but-not-fed
    token as a plain int, which becomes the request's first output;
    ``set_pending_token`` / ``drop_pending_token`` replace and remove it."""
    model, params = models[2:]
    runner = tserving.PagedModelRunner(model, params, num_blocks=16,
                                       block_size=8, max_batch=2,
                                       device="cpu")
    eng = tserving.LLMEngine(runner, max_batch=2, prefill_chunk_tokens=8)
    req = _pressure_reqs(n=1, max_new=3)[0]
    eng.submit(req)
    eng.step()                              # first 8 of 14 prompt tokens
    assert eng.pending_token(req.req_id) is None
    eng.step()                              # the rest: first token sampled
    tok = eng.pending_token(req.req_id)
    assert type(tok) is int
    eng.set_pending_token(req.req_id, tok)
    done = eng.run_until_drained()
    assert done == [req] and req.output_tokens[0] == tok
    eng.set_pending_token(req.req_id, 5)
    eng.drop_pending_token(req.req_id)
    assert eng.pending_token(req.req_id) is None


# =============================================================================
# from_config knobs of the elastic slice, against the JAX package's cluster
# =============================================================================


def _from_config(models, **cfg):
    model, params = models[2:]
    config = tserving.ServingConfig(num_blocks=16, block_size=8, **cfg)
    orch = Orchestrator(hardware=HardwareProfile(
        decode_tok_per_s=20.0, kv_capacity_tokens=config.kv_capacity_tokens))
    return tserving.ServingCluster.from_config(model, params, orch, config,
                                               device="cpu")


def _from_config_pair(models, **cfg):
    """The same config built by both packages, on ticking clocks."""
    config = dict(num_blocks=24, block_size=8, max_batch=4, n_instances=2,
                  prefix_caching=True, prefill_chunk_tokens=8, **cfg)
    out = {}
    for mod in (jserving, tserving):
        mod.reset_request_ids()
        c = mod.ServingConfig(**config)
        if mod is jserving:
            orch = JaxOrchestrator(hardware=JaxHardwareProfile(
                decode_tok_per_s=20.0,
                kv_capacity_tokens=c.kv_capacity_tokens))
            out[mod] = jserving.ServingCluster.from_config(
                models[0], models[1], orch, c, clock=_ticks())
        else:
            orch = Orchestrator(hardware=HardwareProfile(
                decode_tok_per_s=20.0,
                kv_capacity_tokens=c.kv_capacity_tokens))
            out[mod] = tserving.ServingCluster.from_config(
                models[2], models[3], orch, c, clock=_ticks(), device="cpu")
    return out


@pytest.mark.parametrize("knobs", [dict(fused_iteration=False),
                                   dict(donate_pool=False),
                                   dict(fused_iteration=False,
                                        donate_pool=False)],
                         ids=["legacy", "out-of-place", "both"])
def test_from_config_legacy_and_out_of_place_equal_jax(models, knobs):
    """``from_config`` builds legacy and out-of-place engines; the port's
    cluster drains to the JAX package's default cluster streams."""
    clusters = _from_config_pair(models)
    jax_out = _drain(clusters[jserving], _reqs(jserving))
    port = _from_config_pair(models, **knobs)[tserving]
    assert all(e.fused_iteration == knobs.get("fused_iteration", True)
               and e.runner.donate_pool == knobs.get("donate_pool", True)
               for e in port.engines)
    assert _drain(port, _reqs(tserving)) == jax_out


def test_from_config_arms_the_shedder(models):
    cluster = _from_config(models, slo_e2e_s=5.0, shed_queue_high=3.0)
    assert cluster.shedder is not None
    assert cluster.shedder.slo_e2e_s == 5.0
    assert cluster.metrics_snapshot()["n_shed"] == 0.0
    assert _from_config(models).shedder is None


DEFERRED = {
    # name: (call, ROADMAP.md Queue 1 item named in the message)
    "model_parallel=2": (lambda m: _from_config(m, model_parallel=2), 1),
    "on_mesh_slices": (
        lambda m: tserving.ServingCluster.on_mesh_slices(
            m[2], m[3], None, n_instances=2, model_parallel=2), 1),
}


@pytest.mark.parametrize("path", list(DEFERRED))
def test_deferred_paths_raise_naming_their_roadmap_item(models, path):
    call, item = DEFERRED[path]
    with pytest.raises(NotImplementedError,
                       match=rf"ROADMAP\.md Queue 1 item {item}\b"):
        call(models)
