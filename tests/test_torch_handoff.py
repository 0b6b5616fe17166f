"""The port's prefill/decode disaggregation against the JAX package's.

The cases of ``tests/test_handoff.py`` on the port, on the reduced
qwen3-1.7b in fp32 with the JAX weights carried across: a role-typed
drain (prefill instances prefill only, decode instances admit only
through block-granular KV handoff) produces the token streams of the
JAX package's colocated drain of the same requests, each (source,
target) batch costing one gathered ``write_blocks`` and neither pool
moving.  Around that: mid-block prefill cuts, warm-cache adoption on the
decode side, the lossless colocated fallback and its retry cap, role
gates at the scheduler and the dispatchers, and one dispatch per
``migrate_many``.
"""
import dataclasses

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
from repro_torch.core.dispatcher import (
    InstanceModel,
    RoundRobinDispatcher,
    TimeSlotDispatcher,
    role_accepts,
)
from repro_torch.core.memory_model import MemoryRamp
from repro_torch.core.orchestrator import HardwareProfile
from repro_torch.models import LanguageModel, params_from_jax
from repro_torch.obs import rollup_by_role
from repro_torch.obs.trace import NULL_TRACER, Tracer
from repro_torch.serving import (
    HandoffError,
    LLMEngine,
    PagedModelRunner,
    Request,
    RequestPhase,
    drive_handoffs,
    handoff,
    migrate_many,
    reset_request_ids,
)


@pytest.fixture(scope="module")
def models():
    """(JAX model, JAX params, JAX runner, port model, port params) in
    fp32; the JAX runner's clones share its compiled step functions."""
    jcfg = dataclasses.replace(jax_get_config("qwen3-1.7b").reduced(),
                               dtype="float32")
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    cfg = dataclasses.replace(get_config("qwen3-1.7b").reduced(),
                              dtype="float32")
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                             device="cpu")
    jrunner = jserving.PagedModelRunner(jmodel, jparams, num_blocks=64,
                                        block_size=8, max_batch=4)
    return jmodel, jparams, jrunner, LanguageModel(cfg), params


def _engine(models, iid, *, role="general", cache=True, chunk=None,
            num_blocks=64):
    model, params = models[3:]
    r = PagedModelRunner(model, params, num_blocks=num_blocks, block_size=8,
                         max_batch=4, device="cpu")
    return LLMEngine(r, instance_id=iid, max_batch=4, role=role,
                     enable_prefix_cache=cache, prefill_chunk_tokens=chunk)


def _reqs(mod, n=4, max_new=12, sys_len=16, uniq=9, seed=5, tag="m"):
    rng = np.random.default_rng(seed)
    sys_toks = rng.integers(0, 500, sys_len).astype(np.int32)
    out = []
    for i in range(n):
        toks = np.concatenate(
            [sys_toks, rng.integers(0, 500, uniq + i).astype(np.int32)])
        out.append(mod.Request(agent_name="a", msg_id=f"{tag}{i}",
                               prompt_len=len(toks), prompt_tokens=toks,
                               max_new_tokens=max_new))
    return out


def _tokens(done):
    return {q.msg_id: [int(t) for t in q.output_tokens] for q in done}


def _steps(*engines, max_steps=4000):
    done = []
    for _ in range(max_steps):
        for e in engines:
            done.extend(e.step())
        if not any(e.sched.has_work for e in engines):
            return done
    raise AssertionError("drain did not converge")


_BASELINES = {}


def _jax_baseline(models, req_kw=None, *, cache=True, chunk=None,
                  tags=("m",)):
    """The JAX package's colocated drain of the same requests: one
    cached engine, each tag's wave drained in turn."""
    key = (tuple(sorted((req_kw or {}).items())), cache, chunk, tags)
    if key not in _BASELINES:
        jserving.reset_request_ids()
        e = jserving.LLMEngine(models[2].clone(), instance_id=0, max_batch=4,
                               enable_prefix_cache=cache,
                               prefill_chunk_tokens=chunk)
        out = {}
        for tag in tags:
            for q in _reqs(jserving, **(req_kw or {}), tag=tag):
                e.submit(q)
            out.update(_tokens(_steps(e)))
        _BASELINES[key] = out
    return _BASELINES[key]


class _MiniCluster:
    """Just enough cluster surface for drive_handoffs: the engine list,
    a tracer, and an is_fenced probe (never fenced here)."""

    class _Dispatcher:
        @staticmethod
        def is_fenced(instance_id, now):
            return False

    def __init__(self, engines, tracer=NULL_TRACER):
        self.engines = list(engines)
        self.tracer = tracer
        self.dispatcher = self._Dispatcher()


def _disagg_drain(cluster, max_steps=4000):
    done = []
    totals = {"n_handoffs": 0, "handoff_bytes": 0,
              "handoff_dispatches": 0, "n_stranded": 0}
    for it in range(max_steps):
        for e in cluster.engines:
            done.extend(e.step())
        hs = drive_handoffs(cluster, now=float(it))
        assert hs["handoff_dispatches"] <= hs["n_handoffs"], \
            "batching must never spend more dispatches than handoffs"
        for k in totals:
            totals[k] += hs[k]
        if not any(e.sched.has_work for e in cluster.engines):
            return done, totals
    raise AssertionError("disaggregated drain did not converge")


# ---------------------------------------------------------------------------
# disaggregated == colocated
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk", [None, 6])
def test_disagg_drain_token_identical(models, chunk):
    base = _jax_baseline(models, chunk=chunk)
    reset_request_ids()
    e0 = _engine(models, 0, role="prefill", chunk=chunk)
    e1 = _engine(models, 1, role="decode", chunk=chunk)
    a0, a1 = e0.runner.pool_address(), e1.runner.pool_address()
    cluster = _MiniCluster([e0, e1])
    for q in _reqs(tserving):
        e0.submit(q)
    done, totals = _disagg_drain(cluster)
    assert _tokens(done) == base, "disaggregation must not change tokens"
    assert totals["n_handoffs"] == 4 and totals["n_stranded"] == 0
    assert all(q.instance_id == 1 for q in done)
    assert e0.runner.pool_address() == a0
    assert e1.runner.pool_address() == a1


def test_mid_block_prefill_cut_handoff(models):
    """Chunk budget 6 on block size 8: prompts of 37..39 tokens end
    mid-block, so every handoff moves a partially filled final block."""
    req_kw = dict(n=3, uniq=21, max_new=8)
    base = _jax_baseline(models, req_kw, chunk=6)
    reset_request_ids()
    e0 = _engine(models, 0, role="prefill", chunk=6)
    e1 = _engine(models, 1, role="decode", chunk=6)
    cluster = _MiniCluster([e0, e1])
    reqs = _reqs(tserving, **req_kw)
    assert all(q.prompt_len % 8 for q in reqs), "want mid-block prompt ends"
    for q in reqs:
        e0.submit(q)
    e0.step()
    mid = [q for q in e0.sched.running if q.prefilled_len < q.prompt_len]
    assert mid and all(q.phase is RequestPhase.PREFILL for q in mid)
    assert not ({q.req_id for q in e0.sched.handoff_ready()}
                & {q.req_id for q in mid})
    done, totals = _disagg_drain(cluster)
    assert _tokens(done) == base
    assert totals["n_handoffs"] == 3


def test_cow_shared_prefix_adopted_on_decode_side(models):
    """Wave 1's handoffs register the shared prefix in the decode
    instance's cache; wave 2's handoffs adopt those blocks (trace:
    ``cached > 0``).  Both waves match the JAX colocated drain."""
    base = _jax_baseline(models, dict(n=2), tags=("w1-", "w2-"))
    reset_request_ids()
    e0 = _engine(models, 0, role="prefill")
    e1 = _engine(models, 1, role="decode")
    tracer = Tracer(clock=lambda: 0.0)
    cluster = _MiniCluster([e0, e1], tracer=tracer)
    for q in _reqs(tserving, n=2, tag="w1-"):
        e0.submit(q)
    done, _ = _disagg_drain(cluster)
    for q in _reqs(tserving, n=2, tag="w2-"):
        e0.submit(q)
    done2, totals2 = _disagg_drain(cluster)
    assert totals2["n_handoffs"] == 2
    evts = [e for e in tracer.events() if e.kind == "handoff-complete"]
    starts = [e for e in tracer.events() if e.kind == "handoff-start"]
    assert len(evts) == len(starts) == 4
    assert all(e.instance_id == 1 and e.data["src"] == 0 for e in evts)
    assert all(s.data["to"] == 1 and s.data["n_blocks"] > 0
               and s.data["n_bytes"] > 0 for s in starts)
    wave2 = [e for e in evts if e.msg_id.startswith("w2-")]
    assert any(e.data["cached"] > 0 for e in wave2)
    assert {**_tokens(done), **_tokens(done2)} == base


def test_handoff_refused_full_decode_pool_decodes_colocated(models):
    base = _jax_baseline(models)
    reset_request_ids()
    e0 = _engine(models, 0, role="prefill")
    e1 = _engine(models, 1, role="decode", num_blocks=2)
    cluster = _MiniCluster([e0, e1])
    for q in _reqs(tserving):
        e0.submit(q)
    done, totals = _disagg_drain(cluster)
    assert totals["n_handoffs"] == 0
    assert totals["n_stranded"] == 4, "each request stranded exactly once"
    assert _tokens(done) == base, "colocated fallback must be lossless"
    assert all(q.instance_id == 0 for q in done)


def test_stranded_request_hands_off_once_capacity_frees(models):
    base = _jax_baseline(models, dict(n=2, max_new=10))
    reset_request_ids()
    e0 = _engine(models, 0, role="prefill")
    e1 = _engine(models, 1, role="decode", num_blocks=2)
    cluster = _MiniCluster([e0, e1])
    for q in _reqs(tserving, n=2, max_new=10):
        e0.submit(q)
    done = []
    for it in range(4):
        for e in cluster.engines:
            done.extend(e.step())
        drive_handoffs(cluster, now=float(it))
    assert e0.sched.stranded and all(q.output_len > 0
                                     for q in e0.sched.running)
    cluster.engines[1] = _engine(models, 2, role="decode")
    moved = 0
    for it in range(64):
        moved += drive_handoffs(cluster, now=100.0 + it)["n_handoffs"]
        if moved:
            break
    assert moved == 2, "re-offer must move the stranded requests"
    assert not e0.sched.stranded
    done.extend(_steps(*cluster.engines))
    assert _tokens(done) == base


def test_strand_retry_cap_stops_reprobing_full_pool(models):
    base = _jax_baseline(models, dict(n=2, max_new=40))
    reset_request_ids()
    e0 = _engine(models, 0, role="prefill")
    e1 = _engine(models, 1, role="decode", num_blocks=2)   # never adopts
    tracer = Tracer(clock=lambda: 0.0)
    cluster = _MiniCluster([e0, e1], tracer=tracer)
    for q in _reqs(tserving, n=2, max_new=40):
        e0.submit(q)
    done = []
    for it in range(4000):
        for e in cluster.engines:
            done.extend(e.step())
        drive_handoffs(cluster, now=float(it))
        if not any(e.sched.has_work for e in cluster.engines):
            break
    assert _tokens(done) == base, "capped strands must stay lossless"
    strands = [e for e in tracer.events() if e.kind == "handoff-strand"]
    per_req = {}
    for e in strands:
        per_req.setdefault(e.req_id, []).append(e)
    cap = 4
    assert set(per_req) == {q.req_id for q in done}
    for evts in per_req.values():
        assert len(evts) <= cap + 1
        assert evts[-1].data["permanent"]
        assert [e.data["attempts"] for e in evts] == \
            list(range(1, len(evts) + 1))


def _cluster_reqs(mod, n=6, max_new=8):
    rng = np.random.default_rng(3)
    sys_toks = rng.integers(0, 500, 16).astype(np.int32)
    out = []
    for i in range(n):
        toks = np.concatenate(
            [sys_toks, rng.integers(0, 500, 8 + 3 * i).astype(np.int32)])
        out.append(mod.Request(agent_name="a", msg_id=f"c{i}",
                               prompt_len=len(toks), prompt_tokens=toks,
                               max_new_tokens=max_new,
                               arrival_time=0.01 * i))
    return out


def _run_cluster(models, mod, roles, *, num_blocks=28, n=6, max_new=8,
                 **cfg_kw):
    """A full ServingCluster drain under prefix-cache + chunked-prefill +
    preemption pressure, on the JAX package or the port."""
    mod.reset_request_ids()
    cfg = mod.ServingConfig(num_blocks=num_blocks, block_size=8,
                            max_batch=3, n_instances=2, prefix_caching=True,
                            prefill_chunk_tokens=16, policy="kairos",
                            roles=roles, **cfg_kw)
    if mod is jserving:
        orch = JaxOrchestrator(hardware=JaxHardwareProfile(
            decode_tok_per_s=20.0,
            kv_capacity_tokens=cfg.kv_capacity_tokens))
        cluster = jserving.ServingCluster.from_config(
            models[0], models[1], orch, cfg)
    else:
        orch = Orchestrator(hardware=HardwareProfile(
            decode_tok_per_s=20.0,
            kv_capacity_tokens=cfg.kv_capacity_tokens))
        cluster = tserving.ServingCluster.from_config(
            models[3], models[4], orch, cfg, device="cpu")
    for q in _cluster_reqs(mod, n, max_new):
        cluster.submit(q)
    done = cluster.drain()
    snap = cluster.metrics_snapshot()
    cluster.close()
    assert len(done) == n, "drain must finish every request"
    return _tokens(done), snap, cluster


def test_serving_cluster_disagg_drain_matches_colocated(models):
    """1 prefill + 1 decode instance drains to the JAX package's
    colocated 2-instance streams, with the handoff counters and
    role-prefixed labels in the snapshot."""
    base, base_snap, _ = _run_cluster(models, jserving, None)
    disagg, snap, cluster = _run_cluster(models, tserving,
                                         ("prefill", "decode"))
    assert disagg == base, "disaggregated drain must be token-identical"
    assert snap["n_handoffs"] >= 6.0
    assert snap["handoff_dispatches"] <= snap["n_handoffs"]
    assert snap["handoff_bytes"] > 0.0
    assert any(k.startswith("prefill0.") for k in snap)
    assert any(k.startswith("decode1.") for k in snap)
    roles = rollup_by_role(snap)
    assert {"prefill", "decode"} <= set(roles)
    assert roles["prefill"]["n_admitted"] >= 6.0
    assert roles["prefill"].get("n_finished", 0.0) \
        + roles["decode"].get("n_finished", 0.0) == 6.0
    assert roles["decode"].get("n_finished", 0.0) > 0.0
    assert set(rollup_by_role(base_snap)) == {"general"}


def test_cluster_disagg_counters_equal_jax(models):
    """The port's and the JAX package's disaggregated clusters drain the
    same requests to the same streams with the same handoff, strand and
    preemption counters."""
    jtoks, jsnap, _ = _run_cluster(models, jserving, ("prefill", "decode"))
    ttoks, tsnap, _ = _run_cluster(models, tserving, ("prefill", "decode"))
    assert ttoks == jtoks
    keys = ("n_handoffs", "handoff_bytes", "handoff_dispatches",
            "n_stranded", "handoff_strand_retries", "n_migrations",
            "prefill0.n_admitted", "prefill0.n_preempted",
            "decode1.n_finished", "decode1.n_preempted")
    assert {k: tsnap[k] for k in keys} == {k: jsnap[k] for k in keys}


# ---------------------------------------------------------------------------
# role-aware admission: scheduler + dispatchers
# ---------------------------------------------------------------------------


def test_role_accepts_phase_matrix():
    fresh = Request(agent_name="a", msg_id="p", prompt_len=8,
                    max_new_tokens=4)
    assert fresh.phase is RequestPhase.PREFILL
    assert role_accepts("general", fresh)
    assert role_accepts("prefill", fresh)
    assert not role_accepts("decode", fresh)
    fresh.phase = RequestPhase.DECODE
    assert role_accepts("general", fresh)
    assert not role_accepts("prefill", fresh)
    assert role_accepts("decode", fresh)


def test_decode_engine_never_admits_balancer_traffic(models):
    e = _engine(models, 0, role="decode")
    assert not e.sched.can_admit(_reqs(tserving, n=1)[0])


def test_prefill_engine_never_grows_decode_batches(models):
    reset_request_ids()
    e = _engine(models, 0, role="prefill")
    for q in _reqs(tserving, n=2):
        e.submit(q)
    for _ in range(6):
        e.step()
    ready = e.sched.handoff_ready()
    assert len(ready) == 2, "prefill must complete"
    assert all(q.output_len == 0 for q in e.sched.running)
    for q in ready:
        e.sched.allow_colocated_decode(q)
    e.step()
    assert all(q.output_len > 0 for q in e.sched.running)


def _ramp(now):
    return MemoryRamp(p_tokens=16.0, slope=2.0, t_start=now, t_end=now + 1.0)


@pytest.mark.parametrize("force", [False, True])
def test_timeslot_dispatcher_routes_by_role(force):
    insts = [InstanceModel(0, 512.0, role="prefill"),
             InstanceModel(1, 512.0, role="decode")]
    d = TimeSlotDispatcher(insts)
    q = Request(agent_name="a", msg_id="x", prompt_len=8, max_new_tokens=4)
    assert d.dispatch(q, _ramp(0.0), 0.0, force=force) == 0
    q2 = Request(agent_name="a", msg_id="y", prompt_len=8, max_new_tokens=4)
    q2.phase = RequestPhase.DECODE
    assert d.dispatch(q2, _ramp(0.0), 0.0, force=force) == 1


def test_round_robin_dispatcher_respects_roles():
    insts = [InstanceModel(0, 512.0, role="decode"),
             InstanceModel(1, 512.0, role="prefill")]
    d = RoundRobinDispatcher(insts)
    for i in range(3):
        q = Request(agent_name="a", msg_id=f"r{i}", prompt_len=8,
                    max_new_tokens=4)
        assert d.dispatch(q, _ramp(0.0), 0.0) == 1


def test_handoff_rejects_mid_prefill_request(models):
    reset_request_ids()
    e0 = _engine(models, 0, role="prefill", chunk=6)
    e1 = _engine(models, 1, role="decode", chunk=6)
    for q in _reqs(tserving, n=2, uniq=21):
        e0.submit(q)
    e0.step()
    mid = next(q for q in e0.sched.running
               if q.prefilled_len < q.prompt_len)
    with pytest.raises(HandoffError):
        handoff(e0, e1, mid)
    assert mid in e0.sched.running, "refusal must leave the request"


# ---------------------------------------------------------------------------
# migration batching: one gathered write per batch
# ---------------------------------------------------------------------------


def test_migrate_many_single_dispatch(models):
    base = _jax_baseline(models)
    reset_request_ids()
    e0, e1 = _engine(models, 0), _engine(models, 1)
    for q in _reqs(tserving):
        e0.submit(q)
    done = []
    for _ in range(3):
        done.extend(e0.step())
    batch = list(e0.sched.running)
    assert len(batch) >= 2, "want a real batch"
    d0 = e1.runner.n_dispatches
    snaps, skipped = migrate_many(e0, e1, batch)
    assert len(snaps) == len(batch) and not skipped
    assert e1.runner.n_dispatches - d0 == 1, \
        "N requests to one target must cost exactly one write dispatch"
    assert sum(s.n_bytes for s in snaps) > 0
    done.extend(_steps(e0, e1))
    assert _tokens(done) == base


def test_migrate_many_skips_infeasible_without_dispatch(models):
    reset_request_ids()
    e0 = _engine(models, 0)
    e1 = _engine(models, 1, num_blocks=2)
    for q in _reqs(tserving, n=2):
        e0.submit(q)
    e0.step()
    d0 = e1.runner.n_dispatches
    snaps, skipped = migrate_many(e0, e1, list(e0.sched.running))
    assert not snaps and len(skipped) == 2
    assert e1.runner.n_dispatches == d0, "a fully-skipped batch is free"
    assert all(q in e0.sched.running for q in skipped)
