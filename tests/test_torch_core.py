"""The port's Kairos core against the JAX package's.

Every case of ``tests/test_core_components.py`` runs through
``repro.core`` and through ``repro_torch.core`` on the same numpy inputs:
Wasserstein distance, convergence tracking, mode, fan-out detection,
remaining latency, MDS, ``agent_priorities``, the Kairos/FCFS/Topo
orders, memory ramps, the time-slot dispatcher and OOM fencing.  The
results must be equal: exactly for integers, orders and flags, to
``rtol=1e-12`` for floats (the ported modules are copies, so they agree
to the bit in practice).  The reference's own assertions are applied to
the port's results as well.
"""
import math

import numpy as np
import pytest

import repro.core as jcore
import repro.serving.request as jrequest
import repro_torch.core as tcore
import repro_torch.serving.request as trequest

PACKAGES = {"jax": (jcore, jrequest), "port": (tcore, trequest)}


def _rng():
    return np.random.default_rng(0)


# --------------------------------------------------------------------------- #
# distributions
# --------------------------------------------------------------------------- #
def case_wasserstein(core, req):
    a = _rng().normal(10, 1, 500)
    same, shifted = core.wasserstein_1d(a, a), core.wasserstein_1d(a, a + 5.0)
    back = core.wasserstein_1d(a + 5.0, a)
    assert same < 1e-9 and abs(shifted - 5.0) < 0.1
    assert shifted == pytest.approx(back)
    return [same, shifted, back]


def case_convergence_stationary(core, req):
    tr = core.ConvergenceTracker(threshold=0.15)
    samples = []
    for x in _rng().normal(2.0, 0.3, 600):
        samples.append(float(x))
        tr.observe(samples)
    assert tr.converged
    return [tr.converged, tr.last_distance]


def case_convergence_drift(core, req):
    rng = _rng()
    tr = core.ConvergenceTracker(threshold=0.02)
    samples = list(rng.normal(1.0, 0.1, 64))
    tr.observe(samples)
    samples += list(rng.normal(50.0, 0.1, 64))
    tr.observe(samples)
    assert not tr.converged
    return [tr.converged, tr.last_distance]


def case_mode(core, req):
    rng = _rng()
    d = core.EmpiricalDistribution(list(rng.normal(5, 0.5, 400))
                                   + list(rng.normal(20, 3, 50)))
    assert 3.5 < d.mode() < 6.5
    return [d.mode(), d.mean(), d.percentile(90)]


# --------------------------------------------------------------------------- #
# workflow analysis (§4.2)
# --------------------------------------------------------------------------- #
def _rec(req, agent, msg, up, app, t0, t1, out=10):
    return req.CompletionRecord(agent_name=agent, msg_id=msg,
                                upstream_name=up, app_name=app,
                                start_time=t0, end_time=t1, prompt_len=16,
                                output_len=out)


def case_parallel_fanout(core, req):
    wa = core.WorkflowAnalyzer()
    for i in range(4):
        m = f"m{i}"
        wa.add_record(_rec(req, "A", m, None, "app", 0, 1))
        wa.add_record(_rec(req, "B", m, "A", "app", 1.1, 3))
        wa.add_record(_rec(req, "C", m, "A", "app", 1.2, 2.5))
        wa.finalize_trace(m)
    g = wa.graphs["app"]
    kinds = [g.edge_kind("A", "B"), g.edge_kind("A", "C")]
    assert kinds == ["parallel", "parallel"]
    return kinds + [sorted(g.edges), g.remaining_stages("A")]


def case_sequential_fanout(core, req):
    wa = core.WorkflowAnalyzer()
    for i in range(4):
        m = f"s{i}"
        wa.add_record(_rec(req, "A", m, None, "app", 0, 1))
        wa.add_record(_rec(req, "B", m, "A", "app", 1.1, 2.0))
        wa.add_record(_rec(req, "C", m, "A", "app", 2.1, 3.0))
        wa.finalize_trace(m)
    g = wa.graphs["app"]
    out = [g.edge_kind("A", "B"), g.edge_kind("A", "C"),
           g.remaining_stages("A"), g.remaining_stages("B")]
    assert out == ["sequential", "sequential", 2, 1]
    return out + [sorted(wa.agent_keys())]


def case_remaining_latency(core, req):
    wa = core.WorkflowAnalyzer()
    wa.add_record(_rec(req, "A", "x", None, "app", 0, 1))
    wa.add_record(_rec(req, "B", "x", "A", "app", 1, 5))
    wa.finalize_trace("x")
    out = [wa.remaining_samples("app", "A"), wa.remaining_samples("app", "B")]
    assert out == [[5.0], [4.0]]
    return out


# --------------------------------------------------------------------------- #
# MDS priority (§5.1)
# --------------------------------------------------------------------------- #
def case_mds(core, req):
    pts = np.array([0.0, 1.0, 4.0, 9.0])
    d = np.abs(pts[:, None] - pts[None, :])
    c = core.classical_mds_1d(d)
    np.testing.assert_allclose(np.abs(c[:, None] - c[None, :]), d, atol=1e-8)
    return list(c)


def case_agent_priorities(core, req):
    rng = _rng()
    samples = {
        ("app", "fast"): list(rng.normal(1.0, 0.1, 200)),
        ("app", "mid"): list(rng.normal(5.0, 0.5, 200)),
        ("app", "slow"): list(rng.normal(20.0, 2.0, 200)),
    }
    pr = core.agent_priorities(samples)
    assert pr[("app", "fast")] < pr[("app", "mid")] < pr[("app", "slow")]
    assert pr[("app", "fast")] >= 0
    table = core.PriorityTable(interval=1)
    table.maybe_refresh(samples, force=True)
    return [sorted(pr.items()), table.score("app", "mid")]


# --------------------------------------------------------------------------- #
# schedulers (§5)
# --------------------------------------------------------------------------- #
def _q(req, agent, arr, app_start, app="app"):
    return req.Request(agent_name=agent, msg_id=f"{agent}{arr}", app_name=app,
                       arrival_time=arr, app_start_time=app_start,
                       prompt_len=8)


def case_kairos_order(core, req):
    score = {"fast": 0.0, "slow": 10.0}
    sched = core.KairosScheduler(lambda app, a: score[a])
    q = [_q(req, "slow", 0.0, 0.0), _q(req, "fast", 1.0, 0.9),
         _q(req, "fast", 0.5, 0.1)]
    ordered = sched.order(q)
    assert [r.agent_name for r in ordered] == ["fast", "fast", "slow"]
    assert ordered[0].app_start_time == 0.1
    return [r.msg_id for r in ordered]


def case_fcfs_order(core, req):
    q = [_q(req, "a", 2.0, 0), _q(req, "b", 1.0, 0)]
    out = [r.arrival_time for r in core.FCFSScheduler().order(q)]
    assert out == [1.0, 2.0]
    return out


def case_topo_order(core, req):
    stages = {"early": 3, "late": 1}
    sched = core.TopoScheduler(lambda app, a: stages[a])
    q = [_q(req, "early", 0.0, 0), _q(req, "late", 1.0, 0)]
    out = [r.agent_name for r in sched.order(q)]
    assert out == ["late", "early"]
    return out


# --------------------------------------------------------------------------- #
# memory model + dispatcher (§6)
# --------------------------------------------------------------------------- #
def case_memory_ramp(core, req):
    ramp = core.make_ramp(prompt_len=100, expected_exec_time=10.0,
                          decode_tok_per_s=20.0, t_start=0.0)
    out = [ramp.usage(-1), ramp.usage(5.0), ramp.peak, ramp.usage(11.0),
           ramp.slot_usage([0.0, 2.5, 5.0, 7.5], 2.5)]
    assert out[0] == 0 and out[1] == pytest.approx(200.0)
    assert out[2] == pytest.approx(300.0) and out[3] == 0
    return out


def case_ssm_ramp(core, req):
    ramp = core.make_ramp(100, 10.0, 20.0, 0.0, kv_ratio=0.0,
                          state_tokens=64.0)
    out = [ramp.usage(5.0), ramp.peak]
    assert out == [pytest.approx(64.0), pytest.approx(64.0)]
    return out


def case_timeslot_min_peak(core, req):
    insts = [core.InstanceModel(0, capacity_tokens=1000),
             core.InstanceModel(1, capacity_tokens=1000)]
    disp = core.TimeSlotDispatcher(insts)
    r1, r2, r3 = (_q(req, "a", i, i) for i in range(3))
    big = core.make_ramp(700, 10, 10, 0.0)
    small = core.make_ramp(100, 10, 10, 0.0)
    first_iid = disp.dispatch(r1, big, 0.0)
    assert first_iid in (0, 1)
    first = r1.req_id in disp.instances[0].ramps
    iid2 = disp.dispatch(r2, big, 0.0)
    assert iid2 == (1 if first else 0)
    r4 = _q(req, "a", 4, 4)
    rejected = disp.dispatch(r4, core.make_ramp(700, 10, 10, 0.0), 0.0)
    assert rejected is None
    small_iid = disp.dispatch(r3, small, 0.0)
    assert small_iid is not None
    return [first_iid, iid2, rejected, small_iid]


def case_timeslot_time_release(core, req):
    disp = core.TimeSlotDispatcher([core.InstanceModel(0,
                                                       capacity_tokens=500)])
    r1, r2 = _q(req, "a", 0, 0), _q(req, "a", 1, 1)
    out = [disp.dispatch(r1, core.make_ramp(400, 2.0, 0, 0.0), 0.0),
           disp.dispatch(r2, core.make_ramp(400, 2.0, 0, 0.5), 0.5),
           disp.dispatch(r2, core.make_ramp(400, 2.0, 0, 3.0), 3.0)]
    assert out == [0, None, 0]
    return out


def case_oom_fencing(core, req):
    insts = [core.InstanceModel(0, 1000), core.InstanceModel(1, 1000)]
    disp = core.TimeSlotDispatcher(insts, oom_cooldown=5.0)
    disp.on_oom(0, now=0.0)
    iid = disp.dispatch(_q(req, "a", 0, 0), core.make_ramp(10, 1, 1, 0.0),
                        0.0)
    assert iid == 1
    return [iid, disp.is_fenced(0, 1.0), disp.is_fenced(0, 6.0)]


def case_round_robin(core, req):
    disp = core.RoundRobinDispatcher([core.InstanceModel(i, 1e9)
                                      for i in range(3)])
    ids = [disp.dispatch(_q(req, "a", i, i), core.make_ramp(1, 1, 1, 0), 0.0)
           for i in range(6)]
    assert ids == [0, 1, 2, 0, 1, 2]
    return ids


CASES = {name[len("case_"):]: fn for name, fn in dict(globals()).items()
         if name.startswith("case_")}


def _assert_equal(a, b, where="result"):
    """Exact for ints, strings, flags and None; rtol 1e-12 for floats."""
    if isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_equal(x, y, f"{where}[{i}]")
    elif isinstance(a, (float, np.floating)):
        assert math.isclose(a, b, rel_tol=1e-12), f"{where}: {a!r} vs {b!r}"
    else:
        assert a == b, f"{where}: {a!r} vs {b!r}"


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_core_equals_jax_core(case):
    results = {}
    for pkg, (core, req) in PACKAGES.items():
        req.reset_request_ids()
        results[pkg] = CASES[case](core, req)
    _assert_equal(results["port"], results["jax"])
