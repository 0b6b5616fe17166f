"""Spans inside the port's serving step (``repro_torch/obs/trace.py``).

A span is recorded when it ends, on the ring of the instance whose work
it times, with its parent (the span that enclosed it on the same thread),
its engine iteration, its two ends on the tracer's clock and on
``time.time_ns()``, and its thread CPU time.  Here on the CPU: nesting
and parents, CPU time within wall time, nothing recorded without a
tracer, the spans of a two-engine pipelined cluster's fused iterations,
no span left open by a step that raised, their Chrome export, and span
ids and parents under contending threads.
The card test (``tests/test_torch_cuda.py``) holds the spans against the
profiler's clock.
"""
import dataclasses
import sys
import threading
import time
from collections import Counter, defaultdict

import numpy as np
import pytest
import torch

from repro_torch import serving
from repro_torch.configs import get_config
from repro_torch.core import HardwareProfile, Orchestrator
from repro_torch.models import LanguageModel
from repro_torch.obs import (
    NULL_TRACER,
    Span,
    Tracer,
    events_from_dicts,
    events_to_dicts,
    to_chrome_trace,
    validate_chrome_trace,
)

DISPATCH_CHILDREN = ["sched.plan", "engine.flatten", "runner.upload",
                     "runner.launch"]


def _busy(seconds: float):
    t = time.perf_counter() + seconds
    while time.perf_counter() < t:
        pass


@pytest.fixture(scope="module")
def model():
    cfg = dataclasses.replace(get_config("qwen3-1.7b").reduced(),
                              dtype="float32")
    m = LanguageModel(cfg)
    return m, m.init_params(torch.Generator().manual_seed(0), "cpu")


def _reqs(n=6, max_new=5):
    rng = np.random.default_rng(5)
    system = rng.integers(0, 500, 16)
    out = []
    for i in range(n):
        toks = np.concatenate([system, rng.integers(0, 500, 7 + 3 * i)])
        out.append(serving.Request(
            agent_name="a", msg_id=f"m{i}", prompt_len=len(toks),
            prompt_tokens=toks.astype(np.int32), max_new_tokens=max_new))
    return out


def _cluster(model, tracer, pipelined=True):
    m, params = model
    serving.reset_request_ids()
    r0 = serving.PagedModelRunner(m, params, num_blocks=64, block_size=8,
                                  max_batch=4, device="cpu")
    engines = [serving.LLMEngine(r0 if i == 0 else r0.clone(),
                                 instance_id=i, max_batch=4,
                                 enable_prefix_cache=True,
                                 prefill_chunk_tokens=8, tracer=tracer)
               for i in range(2)]
    orch = Orchestrator(hardware=HardwareProfile(
        decode_tok_per_s=20.0, kv_capacity_tokens=512))
    return serving.ServingCluster(engines, orch, pipelined=pipelined,
                                  tracer=tracer)


def _drain(cluster):
    for r in _reqs():
        cluster.submit(r)
    try:
        done = cluster.run_until_drained()
    finally:
        cluster.close()
    assert len(done) == 6
    return {r.msg_id: [int(t) for t in r.output_tokens] for r in done}


@pytest.fixture(scope="module")
def pipelined(model):
    """Streams untraced, then the traced drain's streams and tracer."""
    plain = _drain(_cluster(model, NULL_TRACER))
    tr = Tracer()
    return plain, _drain(_cluster(model, tr)), tr


def _spans(tracer, name=None):
    return [e for e in tracer.events()
            if e.kind == "span" and (name is None or e.name == name)]


def test_spans_nest_with_their_parents():
    tr = Tracer()
    outer = tr.begin("engine.dispatch", 3)
    plan = tr.begin("sched.plan", 3)
    _busy(0.002)
    tr.end(plan, iteration=7)
    outer.iteration = 7
    inner = tr.begin("runner.launch", 3)
    _busy(0.002)
    tr.end(inner)
    tr.end(outer)
    tick = tr.begin("balancer.tick")
    tr.end(tick)
    by = {s.name: s for s in _spans(tr)}
    assert set(by) == {"engine.dispatch", "sched.plan", "runner.launch",
                       "balancer.tick"}
    d = by["engine.dispatch"]
    assert d.parent == -1 and by["balancer.tick"].parent == -1
    assert by["sched.plan"].parent == by["runner.launch"].parent == d.span_id
    # set on the open parent, an iteration is inherited by what it encloses
    assert {by[n].iteration for n in ("engine.dispatch", "sched.plan",
                                      "runner.launch")} == {7}
    assert by["balancer.tick"].iteration == -1
    assert all(s.data == {} for s in by.values())
    assert [s.instance_id for s in tr.events(3)] == [3, 3, 3]
    assert tr.events(-1) == [by["balancer.tick"]]
    for child in (by["sched.plan"], by["runner.launch"]):
        assert d.ts <= child.ts <= child.end <= d.end
        assert d.start_ns <= child.start_ns <= child.end_ns <= d.end_ns
    # an end left out (an exception past it) does not outlive its parent
    a = tr.begin("engine.dispatch", 0)
    tr.begin("engine.flatten", 0)
    tr.end(a)
    assert tr.begin("cluster.step").parent == -1


def test_cpu_time_within_wall_time():
    tr = Tracer()
    on = tr.begin("runner.launch", 0)
    _busy(0.02)
    tr.end(on)
    off = tr.begin("engine.sync", 0)
    time.sleep(0.05)
    tr.end(off)
    on, off = _spans(tr)
    for s in (on, off):
        assert 0 <= s.cpu_ns <= s.wall_ns
        assert s.wall_ns == s.end_ns - s.start_ns > 0
    assert on.cpu_ns > 0
    assert off.cpu_ns < 0.5 * off.wall_ns


def test_null_tracer_engine_records_nothing(model, monkeypatch):
    def opened(*a, **kw):
        raise AssertionError("a span was begun without a tracer")

    monkeypatch.setattr(NULL_TRACER, "begin", opened)
    cluster = _cluster(model, NULL_TRACER)
    assert all(e.runner.tracer is NULL_TRACER for e in cluster.engines)
    _drain(cluster)
    assert len(NULL_TRACER) == 0 and NULL_TRACER.events() == []


def test_spans_leave_the_streams_alone(pipelined):
    plain, traced, _ = pipelined
    assert traced == plain


def test_pipelined_iteration_spans(pipelined):
    """Each fused iteration of each engine: one ``engine.dispatch`` on the
    engine's ring, on the control thread inside a ``cluster.step``,
    enclosing one each of plan, flatten, upload and launch in that
    order, all with the iteration's number; then one ``engine.sync`` and
    one ``engine.collect`` in the same step.  Within a step every
    dispatch ends before the first sync begins (breadth-first)."""
    _, _, tr = pipelined
    steps = _spans(tr, "cluster.step")
    control = {s.thread for s in steps}
    assert len(control) == 1
    ticks = _spans(tr, "balancer.tick")
    assert len(ticks) == len(steps)
    step_ids = {s.span_id for s in steps}
    assert all(t.parent in step_ids and t.thread in control for t in ticks)
    for iid in (0, 1):
        spans = [e for e in tr.events(iid) if e.kind == "span"]
        assert spans and all(s.instance_id == iid for s in spans)
        by_id = {s.span_id: s for s in spans}
        by_iter = defaultdict(list)
        for s in spans:
            by_iter[s.iteration].append(s)
        iters = sorted(k for k in by_iter if k >= 0)
        assert iters == list(range(len(iters))) and len(iters) > 3
        planned = [e.ts for e in tr.events(iid) if e.kind == "iteration"]
        assert len(planned) == len(iters)
        for k in iters:
            names = Counter(s.name for s in by_iter[k])
            assert names == Counter(["engine.dispatch", "engine.sync",
                                     "engine.collect"] + DISPATCH_CHILDREN)
            d, = [s for s in by_iter[k] if s.name == "engine.dispatch"]
            assert d.parent in step_ids and d.thread in control
            kids = sorted((s for s in by_iter[k] if s.parent == d.span_id),
                          key=lambda s: s.ts)
            assert [s.name for s in kids] == DISPATCH_CHILDREN
            assert all(s.thread == d.thread for s in kids)
            assert all(d.ts <= s.ts <= s.end <= d.end for s in kids)
            for a, b in zip(kids, kids[1:]):
                assert a.end <= b.ts
            # the iteration's counts are its event, inside the dispatch
            assert sum(d.ts <= t <= d.end for t in planned) == 1
            sync, = [s for s in by_iter[k] if s.name == "engine.sync"]
            assert sync.thread == d.thread and sync.parent == d.parent
            assert sync.ts >= d.end
            coll, = [s for s in by_iter[k] if s.name == "engine.collect"]
            assert coll.thread in control and coll.ts >= sync.end
            assert by_id.get(coll.parent) is None
            assert coll.parent == d.parent
        # a dispatch that planned nothing has no iteration, and only the
        # plan inside it
        empty = by_iter.get(-1, [])
        for d in empty:
            if d.name == "engine.dispatch":
                assert not any(d.ts <= t <= d.end for t in planned)
                assert [s.name for s in empty
                        if s.parent == d.span_id] == ["sched.plan"]
            else:
                assert d.name == "sched.plan"
    assert len(_spans(tr, "engine.collect")) == sum(
        1 for s in _spans(tr, "engine.dispatch") if s.iteration >= 0)
    both = 0
    for step in steps:
        inside = defaultdict(list)
        for s in _spans(tr):
            if s.parent == step.span_id:
                inside[s.name].append(s)
        if len(inside["engine.dispatch"]) == 2 and inside["engine.sync"]:
            both += 1
            assert max(d.end for d in inside["engine.dispatch"]) <= min(
                s.ts for s in inside["engine.sync"])
    assert both > 3


def test_serial_cluster_dispatches_on_the_control_thread(model):
    tr = Tracer()
    _drain(_cluster(model, tr, pipelined=False))
    steps = {s.span_id: s for s in _spans(tr, "cluster.step")}
    control = {s.thread for s in steps.values()}
    dispatches = _spans(tr, "engine.dispatch")
    assert dispatches and all(d.thread in control and d.parent in steps
                              for d in dispatches)


def test_a_raising_step_leaves_no_span_open(model, pipelined):
    """An exception out of an engine's plan, raised through the cluster
    step, closes the step's and the dispatch's spans on the way: the
    next steps' spans have no parent, every dispatch's is its own step,
    and the drain's streams are those of a run that never raised (the
    engine dispatched before it is still collected)."""
    plain, _, _ = pipelined
    tr = Tracer()
    cluster = _cluster(model, tr)
    for r in _reqs():
        cluster.submit(r)
    sched = cluster.engines[1].sched
    plan = sched.plan

    def raising(now):
        sched.plan = plan
        raise RuntimeError("planned failure")

    sched.plan = raising
    try:
        with pytest.raises(RuntimeError, match="planned failure"):
            cluster.step()
        done = cluster.run_until_drained()
    finally:
        cluster.close()
    assert {r.msg_id: [int(t) for t in r.output_tokens]
            for r in done} == plain
    steps = _spans(tr, "cluster.step")
    assert len(steps) > 3 and all(s.parent == -1 for s in steps)
    dispatches = _spans(tr, "engine.dispatch")
    step_of = {s.span_id: s for s in steps}
    assert all(step_of[d.parent].ts <= d.ts <= d.end
               <= step_of[d.parent].end for d in dispatches)
    failed = [d for d in dispatches
              if d.instance_id == 1 and d.ts < steps[0].end]
    assert len(failed) == 1 and failed[0].iteration == -1
    assert failed[0].parent == steps[0].span_id
    # its plan, left open by the exception, is dropped with it
    assert not any(s.parent == failed[0].span_id for s in _spans(tr))


def test_spans_export_to_thread_tracks(pipelined):
    _, _, tr = pipelined
    events = tr.events()
    trace = to_chrome_trace(events, dropped=tr.dropped())
    assert validate_chrome_trace(trace) == []
    threads = {(e["pid"], e["tid"]): e["args"]["name"]
               for e in trace["traceEvents"] if e["name"] == "thread_name"}
    xs = [e for e in trace["traceEvents"] if e.get("cat") == "span"]
    assert len(xs) == len(_spans(tr))
    assert {threads[(e["pid"], e["tid"])] for e in xs} == {
        "control", "dispatch-0", "dispatch-1"}
    for e in xs:
        track = threads[(e["pid"], e["tid"])]
        if e["name"] in ("cluster.step", "balancer.tick"):
            assert track == "control"
        else:
            assert track == f"dispatch-{e['args']['instance']}"
    # the stated offset puts every span at its time_ns start
    zero = trace["otherData"]["zero_time_ns"]
    starts = sorted(s.start_ns for s in _spans(tr))
    assert sorted(zero + round(e["ts"] * 1e3) for e in xs) == starts
    # and the zero is the earliest event's time, on both clocks
    t0 = events[0].ts
    first = min(_spans(tr), key=lambda s: s.start_ns)
    assert abs((first.start_ns - zero) * 1e-9 - (first.ts - t0)) < 1e-6
    # loss-free plain-dict round trip, spans included
    back = events_from_dicts(events_to_dicts(events))
    assert back == events
    assert all(isinstance(b, Span) for b in back if b.kind == "span")


def test_span_ids_and_parents_under_contending_threads():
    """More threads than cores, switching every microsecond, nesting spans
    on their own rings: no span lost, ids unique, every parent the span
    that enclosed it on its own thread."""
    tr = Tracer()
    n_threads, n_outer = 16, 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    errors = []

    def work(i):
        try:
            for k in range(n_outer):
                o = tr.begin("engine.dispatch", i)
                o.iteration = k
                tr.end(tr.begin("sched.plan", i))
                tr.end(tr.begin("runner.launch", i))
                tr.end(o)
        except Exception as e:  # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(i,))
               for i in range(n_threads)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and not errors
    spans = _spans(tr)
    assert len(spans) == n_threads * n_outer * 3
    assert len({s.span_id for s in spans}) == len(spans)
    by_id = {s.span_id: s for s in spans}
    for i in range(n_threads):
        mine = [s for s in tr.events(i)]
        assert len(mine) == n_outer * 3
        assert len({s.thread for s in mine}) == 1
        for s in mine:
            if s.name == "engine.dispatch":
                assert s.parent == -1
            else:
                p = by_id[s.parent]
                assert p.name == "engine.dispatch" and p.instance_id == i
                assert p.iteration == s.iteration
