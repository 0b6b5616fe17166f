"""The port's simulator, traces and trace export against the JAX package's.

The discrete-event simulator shares the cluster's control plane (batch
scheduler, dispatchers, autoscaler, load shedder, fault plane, cost
model); the port keeps its own copies.  On the same seeds the port's
``Simulation.summary()`` and ``run_policy`` results equal the JAX
package's, exactly, for the Kairos / Parrot / Ayo policies and the
ablation, the elastic, disaggregated, faulted and shedding runs, and
``donate_pool=False`` pricing; the paper's orderings hold on the port's
runs as they do in ``tests/test_simulator.py``.  The seeded traces are
identical, and the Chrome / Perfetto trace export round-trips
loss-free (``tests/test_obs.py``'s export cases).
"""
import dataclasses
import json
import math
import os
import subprocess
import sys

import pytest

import repro.sim as jsim
import repro.workloads as jworkloads
import repro.workloads.traces as jtraces
from repro.serving import AutoscalerConfig as JaxAutoscalerConfig
from repro.serving import FaultPlan as JaxFaultPlan
from repro.serving import ServingConfig as JaxServingConfig
from repro_torch import sim as tsim
from repro_torch import workloads as tworkloads
from repro_torch.workloads import traces as ttraces
from repro_torch.obs import (
    Event,
    Tracer,
    events_from_dicts,
    events_to_dicts,
    to_chrome_trace,
    validate_chrome_trace,
    write_chrome_trace,
)
from repro_torch.serving import AutoscalerConfig, FaultPlan, ServingConfig
from repro_torch.sim.cost_model import LLAMA3_8B

RATE, DUR, SEED = 2.6, 100.0, 3
KW = dict(rate=RATE, duration=DUR, seed=SEED, max_batch=48)
POLICIES = ["parrot", "ayo", "kairos", "w/o-priority"]


def _same(a: dict, b: dict) -> bool:
    """Dict equality with NaN equal to NaN."""
    return a.keys() == b.keys() and all(
        a[k] == b[k] or (isinstance(a[k], float) and isinstance(b[k], float)
                         and math.isnan(a[k]) and math.isnan(b[k]))
        for k in a)


@pytest.fixture(scope="module")
def results():
    """{policy: (port results, JAX results)} on the co-located apps."""
    out = {}
    for p in POLICIES:
        out[p] = (tsim.run_policy(tsim.colocated_apps(), p, **KW),
                  jsim.run_policy(jsim.colocated_apps(), p, **KW))
    return out


@pytest.mark.parametrize("policy", POLICIES)
def test_run_policy_summary_equals_jax(results, policy):
    port, ref = results[policy]
    assert _same(port.summary(), ref.summary())
    assert port.n_preempted == ref.n_preempted
    assert [w.total_tokens for w in port.workflows] == \
        [w.total_tokens for w in ref.workflows]


def test_paper_orderings_hold_on_the_port(results):
    s = {p: r[0].summary() for p, r in results.items()}
    assert len({len(r[0].workflows) for r in results.values()}) == 1
    assert s["kairos"]["avg"] < s["parrot"]["avg"] * 0.85
    assert s["kairos"]["p99"] < s["parrot"]["p99"]
    assert s["kairos"]["avg"] < s["ayo"]["avg"] * 1.03
    assert s["w/o-priority"]["avg"] > s["kairos"]["avg"] * 1.2
    assert results["kairos"][0].n_preempted < \
        results["parrot"][0].n_preempted


@pytest.mark.parametrize("seed", [1, 5])
def test_single_app_qa_per_seed_equals_jax(seed):
    kw = dict(rate=6.0, duration=40.0, seed=seed, max_batch=48)
    for pol in ("kairos", "parrot"):
        port = tsim.run_policy([tsim.make_app("QA", "G+M")], pol, **kw)
        ref = jsim.run_policy([jsim.make_app("QA", "G+M")], pol, **kw)
        assert _same(port.summary(), ref.summary()), (pol, seed)


def test_donate_pool_false_pricing_equals_jax():
    """Out-of-place pools price a full pool read + write per dispatch:
    strictly slower than in place, and equal to the JAX package's."""
    t0 = LLAMA3_8B.iteration_time(4, 64, 128, n_prefill_seqs=2, fused=True)
    copy = 2 * LLAMA3_8B.pool_bytes(12288)
    tc = LLAMA3_8B.iteration_time(4, 64, 128, n_prefill_seqs=2, fused=True,
                                  hbm_bytes=copy)
    assert tc - t0 == pytest.approx(copy / (LLAMA3_8B.hbm_gbps * 1e9))
    out = {}
    for mod in (tsim, jsim):
        kw = dict(apps=[mod.make_app("QA", "G+M")], policy="kairos",
                  rate=4.0, duration=40.0, seed=7, prefill_chunk_tokens=512)
        base = mod.Simulation(mod.SimConfig(**kw)).run()
        copying = mod.Simulation(mod.SimConfig(**kw,
                                               donate_pool=False)).run()
        assert len(base.workflows) == len(copying.workflows)
        assert copying.summary()["avg"] > base.summary()["avg"]
        out[mod] = (base.summary(), copying.summary())
    assert _same(out[tsim][0], out[jsim][0])
    assert _same(out[tsim][1], out[jsim][1])


def _disagg(mod_sim, config_cls, roles):
    apps = [mod_sim.make_app("QA", "G+M")]
    serving = config_cls(num_blocks=512, block_size=16, max_batch=32,
                         policy="kairos", n_instances=2, roles=roles)
    cfg = mod_sim.SimConfig.from_serving_config(
        serving, apps, rate=1.0, duration=40.0, seed=3,
        prefill_chunk_tokens=None)
    return mod_sim.Simulation(cfg).run()


@pytest.mark.parametrize("roles", [None, ("prefill", "decode")])
def test_disaggregated_sim_equals_jax(roles):
    port = _disagg(tsim, ServingConfig, roles)
    ref = _disagg(jsim, JaxServingConfig, roles)
    assert _same(port.summary(), ref.summary())
    if roles:
        assert port.n_handoffs > 0


def _sim_kw(mod, **over):
    kw = dict(apps=[mod.make_app("QA", "G+M")], policy="kairos", rate=4.0,
              duration=10.0, n_instances=3, kv_capacity_tokens=4096,
              block_size=16, max_batch=8, seed=1)
    kw.update(over)
    return kw


def test_sim_faulted_run_loses_nothing_and_equals_jax():
    runs = {}
    for mod, plan_cls in ((tsim, FaultPlan), (jsim, JaxFaultPlan)):
        plan = plan_cls.generate(3, [0, 1, 2], horizon=12, n_crashes=1,
                                 n_straggles=1, n_ooms=1, spare=(0,))
        res = mod.Simulation(mod.SimConfig(faults=plan,
                                           recovery_backoff_s=0.1,
                                           **_sim_kw(mod))).run()
        assert res.n_crashes == 1 and res.n_lost == 0
        runs[mod] = res.summary()
    assert _same(runs[tsim], runs[jsim])


def test_sim_shedding_beats_no_shedding_goodput_under_overload():
    """``tests/test_faults_recovery.py``'s shedding case on the port, with
    the JAX package's numbers."""
    slo = 12.0
    out = {}
    for mod in (tsim, jsim):
        kw = _sim_kw(mod, rate=12.0, duration=20.0, n_instances=2,
                     kv_capacity_tokens=3072, seed=3)
        res_off = mod.Simulation(mod.SimConfig(**kw)).run()
        res_on = mod.Simulation(mod.SimConfig(slo_e2e_s=slo,
                                              shed_queue_high=4.0,
                                              **kw)).run()
        assert res_on.n_shed > 0, "valve never opened under overload"
        assert res_off.n_shed == 0
        assert res_on.goodput(slo) > res_off.goodput(slo)
        out[mod] = (res_on.goodput(slo), res_off.goodput(slo),
                    res_on.summary())
    assert out[tsim][:2] == out[jsim][:2]
    assert _same(out[tsim][2], out[jsim][2])


def test_elastic_sim_summary_equals_jax_per_seed():
    res = {}
    for mod_sim, traces, cfg_cls, as_cls in (
            (tsim, ttraces, ServingConfig, AutoscalerConfig),
            (jsim, jtraces, JaxServingConfig, JaxAutoscalerConfig)):
        for seed in (1, 4):
            trace = traces.bursty_trace(seed=seed, duration=20.0,
                                        base_rate=2.0, burst_mult=6.0)
            cfg = trace.sim_config(
                cfg_cls(num_blocks=512, block_size=16, max_batch=32,
                        policy="kairos", n_instances=2),
                autoscale=as_cls(min_instances=2, max_instances=5,
                                 queue_high=3.0, queue_low=0.5,
                                 up_patience=2, down_patience=6,
                                 decision_period_s=0.25, cooldown_s=1.0))
            r = mod_sim.Simulation(cfg).run()
            res[(mod_sim, seed)] = (r.summary(), r.scale_history)
    for seed in (1, 4):
        p, j = res[(tsim, seed)], res[(jsim, seed)]
        assert _same(p[0], j[0]) and p[1] == j[1]


def test_generated_traces_equal_jax():
    for seed in (0, 3):
        cfg_t = tworkloads.TraceConfig(seed=seed, duration=60.0)
        cfg_j = jworkloads.TraceConfig(seed=seed, duration=60.0)
        assert dataclasses.asdict(cfg_t) == dataclasses.asdict(cfg_j)
        t, j = tworkloads.generate_trace(cfg_t), jworkloads.generate_trace(
            cfg_j)
        assert t.events == j.events
        assert len(t.events) > 0


def test_sim_trace_exports_like_jax():
    """A traced simulation exports to the same Chrome trace in both
    packages, and the port's export validates."""
    out = {}
    for mod in (tsim, jsim):
        cfg = mod.SimConfig(apps=[mod.make_app("QA", "G+M")],
                            policy="kairos", rate=3.0, duration=10.0,
                            seed=2, tracing=True)
        sim = mod.Simulation(cfg)
        sim.run()
        if mod is tsim:
            trace = to_chrome_trace(sim.tracer.events())
            assert validate_chrome_trace(trace) == []
        else:
            from repro.obs import to_chrome_trace as jax_to_chrome
            trace = jax_to_chrome(sim.tracer.events())
        out[mod] = json.dumps(trace, sort_keys=True)
    assert out[tsim] == out[jsim]


# =============================================================================
# export round trip (tests/test_obs.py)
# =============================================================================


def test_event_dict_round_trip_is_loss_free():
    tr = Tracer()
    tr.emit("submit", req_id=7, instance_id=-1, agent="qa", msg_id="w1",
            ts=1.0, upstream=None)
    tr.emit("prefill-chunk", req_id=7, instance_id=0, ts=2.0,
            start=0, end=16, last=True)
    evs = tr.events()
    back = events_from_dicts(json.loads(json.dumps(events_to_dicts(evs))))
    assert [tuple(e) for e in back] == [tuple(e) for e in evs]
    assert all(isinstance(e, Event) for e in back)
    with pytest.raises(AssertionError):
        events_from_dicts([{**evs[0]._asdict(), "kind": "bogus"}])


def test_chrome_trace_collapses_missing_first_token_to_exec_span(tmp_path):
    tr = Tracer()
    tr.emit("submit", req_id=1, instance_id=-1, msg_id="w", ts=0.0)
    tr.emit("admit", req_id=1, instance_id=0, ts=1.0)
    tr.emit("finish", req_id=1, instance_id=0, ts=3.0)
    trace = to_chrome_trace(tr.events())
    assert validate_chrome_trace(trace) == []
    names = [e["name"] for e in trace["traceEvents"] if e["ph"] == "X"]
    assert "exec" in names and "prefill" not in names
    tr2 = Tracer()
    tr2.emit("submit", req_id=2, instance_id=-1, msg_id="w", ts=0.0)
    tr2.emit("admit", req_id=2, instance_id=0, ts=1.0)
    assert [e for e in to_chrome_trace(tr2.events())["traceEvents"]
            if e["ph"] == "X"] == []
    path = tmp_path / "trace.json"
    write_chrome_trace(str(path), tr.events())
    assert json.loads(path.read_text()) == trace


def test_cluster_sim_entry_point_prints_ok():
    """``python -m repro_torch.cluster_sim`` mirrors
    ``examples/cluster_sim.py`` on a short run and imports no JAX."""
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(src))
    code = ("import sys, runpy\n"
            "sys.argv = ['cluster_sim', '--duration', '60']\n"
            "try:\n"
            "    runpy.run_module('repro_torch.cluster_sim', "
            "run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert e.code == 0, e.code\n"
            "assert 'jax' not in sys.modules\n")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "CLUSTER-SIM OK" in out.stdout
