"""One run of one cell: set-up, traffic, the measured window, the check.

The system under test is the port's Kairos path: ``Workflow`` (agents on
the message bus) over ``ServingCluster.from_config`` (load balancer,
priority scheduler, memory-aware dispatcher, pipelined engines) over
``LLMEngine`` and ``PagedModelRunner.run_iteration``, on weights the
benchmark makes.  The benchmark only wraps public calls to watch them:
``ServingCluster.step`` (finished calls, the window's edges and, in a
traced run, the profiler), and in a traced run also the balancer's
tick, each engine's dispatch / sync / collect (host spans) and each
runner's ``run_iteration`` (what every step computed).

Timeline: set-up (weights, cluster, a burst that warms every kernel and
the shapes of the mix) ends when the first session submits; the mix runs
``warmup_s`` and then the window of ``--seconds``; then the program's
state is freed and the reference checks a sample of the window's calls.
"""
from __future__ import annotations

import dataclasses
import gc
import heapq
import queue
import subprocess
import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from portbench import check, measure, profiling
from portbench.manifest import Cell
from portbench.measure import CallRecord, WorkflowRecord
from portbench.reference.spec import Arch, arch_of
from portbench.traffic import Script, Traffic
from portbench.weights import make_weights

LLM_TIMEOUT_S = 900.0
DRAIN_S = 180.0            # the most the workflows open at the close get
PROFILE_SECONDS = 10.0     # the traced slice: the window's last seconds
SMI_PERIOD_S = 2.0
_WARM = 6                  # stream key of the warm-up burst's tokens


# =============================================================================
# the port's configuration, built from the benchmark's file
# =============================================================================


def port_config(config: dict, arch: Arch, check_registry: bool = True):
    """The port's ``ModelConfig`` for ``config``: the port's registry
    entry named ``port_arch``, with every number the file states.  With
    ``check_registry`` the registry's own numbers must already be the
    file's, but for two that the file sets: the norms' epsilon (the
    published one, where the registry keeps the port's default) and the
    MoE capacity."""
    from repro_torch.configs import get_config
    base = get_config(config["port_arch"])
    fields = dict(num_layers=arch.layers, d_model=arch.d_model,
                  num_heads=arch.heads, num_kv_heads=arch.kv_heads,
                  head_dim=arch.head_dim, vocab_size=arch.vocab,
                  norm_eps=arch.eps, rope_theta=arch.rope_theta,
                  qk_norm=arch.qk_norm, tie_embeddings=arch.tied,
                  dtype=arch.dtype)
    if arch.moe is None:
        fields["d_ff"] = arch.d_ff
    else:
        m = arch.moe
        fields["moe"] = dataclasses.replace(
            base.moe, num_experts=m.num_experts, top_k=m.top_k,
            d_expert=m.d_expert, d_shared=m.d_shared,
            num_shared_experts=base.moe.num_shared_experts if m.d_shared
            else 0, moe_layer_period=1)
    cfg = dataclasses.replace(base, **fields)
    if check_registry:
        diff = {k: (getattr(base, k), getattr(cfg, k)) for k in fields
                if k not in ("moe", "head_dim", "norm_eps")
                and getattr(base, k) != getattr(cfg, k)}
        if base.resolved_head_dim != arch.head_dim:
            diff["head_dim"] = (base.resolved_head_dim, arch.head_dim)
        if arch.moe is not None and base.moe != cfg.moe:
            diff["moe"] = (base.moe, cfg.moe)
        if diff:
            raise ValueError(f"the port's {config['port_arch']} differs "
                             f"from the configuration file: {diff}")
    if arch.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=arch.moe.capacity_factor))
    if cfg.resolved_head_dim != arch.head_dim:
        raise ValueError("head dim mismatch")
    return cfg


# =============================================================================
# the agents and the closed loop of sessions
# =============================================================================


class SessionLoop(threading.Thread):
    """Submits each session's workflows: the first when the mix's
    arrivals say, each next one (closed loop) its think time after the
    last answer.  After the window it stops submitting and only collects
    the workflows still open."""

    def __init__(self, wf, traffic: Traffic, t0: float):
        super().__init__(name="portbench-sessions", daemon=True)
        self.wf, self.traffic, self.t0 = wf, traffic, t0
        self._arrivals = traffic.arrivals()
        self._arrival = next(self._arrivals, None)
        self._due: List[Tuple[float, int, int, Script]] = []
        self._done: "queue.Queue" = queue.Queue()
        self._halt = threading.Event()
        self._closing = threading.Event()
        self._open: Dict[str, Tuple[Script, float]] = {}
        self.workflows: List[WorkflowRecord] = []
        self.calls_out: Dict[Tuple[str, int], int] = {}  # asked, not back
        self.n_failed = 0
        self.n_submitted = 0

    # called from agent threads
    def finished(self, msg_id: str, t: float, ok: bool = True) -> None:
        self._done.put((msg_id, t, ok))

    def stop_submitting(self) -> None:
        self._closing.set()

    @property
    def n_open(self) -> int:
        """Workflows submitted that have not ended (an ended one stays in
        ``_open`` until the loop takes its end off the queue)."""
        return len(self._open) - self._done.qsize()

    def stop(self) -> None:
        self._halt.set()
        self.join(timeout=10)

    def _next_due(self) -> float:
        if self._closing.is_set():
            return float("inf")
        t = self._due[0][0] if self._due else float("inf")
        if self._arrival is not None:
            t = min(t, self.t0 + self._arrival[0])
        return t

    def run(self) -> None:
        while not self._halt.is_set():
            wait = min(0.05, max(0.0, self._next_due() - time.monotonic()))
            try:
                msg_id, t, ok = self._done.get(timeout=wait)
            except queue.Empty:
                pass
            else:
                script, t_submit = self._open.pop(msg_id)
                if ok:
                    self.workflows.append(WorkflowRecord(
                        script.session, msg_id, t_submit, t))
                else:
                    self.n_failed += 1
                if script.think_s is not None:
                    nxt = self.traffic.next_script(script.session)
                    heapq.heappush(self._due, (t + script.think_s,
                                               script.session, nxt.index,
                                               nxt))
            if self._closing.is_set():
                continue
            now = time.monotonic()
            while (self._arrival is not None
                   and self.t0 + self._arrival[0] <= now):
                off, s = self._arrival
                heapq.heappush(self._due, (self.t0 + off, s, 0,
                                           self.traffic.next_script(s)))
                self._arrival = next(self._arrivals, None)
            while (self._due and self._due[0][0] <= now
                   and not self._closing.is_set()):
                _, _, _, script = heapq.heappop(self._due)
                t = time.monotonic()
                msg_id = self.wf.submit_task(
                    script.stages[0].agent,
                    {"script": script, "stage": 0, "history": [script.task],
                     "delay": 0.0, "call": 0})
                self._open[msg_id] = (script, t)
                self.n_submitted += 1


def agent_classes(traffic: Traffic, sessions: SessionLoop,
                  delays: Dict[Tuple[str, int], float]):
    """One agent class that plays its part of each workflow's script."""
    from repro_torch.agents import BaseAgent

    class ScriptedAgent(BaseAgent):
        def system_prompt_tokens(self):
            return traffic.system_tokens(self.name)

        def _run_impl(self, data, metadata):
            script, i = data["script"], data["stage"]
            hist, delay, k = data["history"], data["delay"], data["call"]
            try:
                for turn in script.stages[i].turns:
                    prompt = (np.concatenate(hist) if traffic.history
                              else script.task)
                    delays[(metadata.msg_id, k)] = delay
                    sessions.calls_out[(metadata.msg_id, k)] = turn.out
                    out = self.generate(prompt, metadata,
                                        max_new_tokens=turn.out)
                    del sessions.calls_out[(metadata.msg_id, k)]
                    k += 1
                    delay = 0.0
                    if traffic.history:
                        hist = hist + [np.asarray(out, np.int32)]
                    if turn.tool is not None:
                        time.sleep(turn.tool_latency_s)
                        delay = turn.tool_latency_s
                        if traffic.history:
                            hist = hist + [turn.tool]
            except Exception:
                sessions.finished(metadata.msg_id, time.monotonic(), ok=False)
                raise
            if i + 1 < len(script.stages):
                return ({"script": script, "stage": i + 1, "history": hist,
                         "delay": delay, "call": k},
                        script.stages[i + 1].agent)
            sessions.finished(metadata.msg_id, time.monotonic())
            return {"tokens": len(out)}, None

    return ScriptedAgent


# =============================================================================
# watching the cluster
# =============================================================================


@dataclasses.dataclass
class Iteration:
    t: float                                  # dispatch, monotonic
    decode_ctx: List[int]                     # each decode row's context
    chunks: List[Tuple[int, int]]             # (start, end) of each chunk
    sampled: int                              # rows that yield a token


class Recorder:
    """Wraps the cluster's public calls; in a traced run also the host
    spans, the iteration log and the profiler's slice."""

    def __init__(self, cluster, traced: bool):
        self.cluster, self.traced = cluster, traced
        self.calls: List[CallRecord] = []
        self.finished_tokens = 0
        self.open_due = self.close_due = float("inf")
        self.window: Optional[Tuple[float, float]] = None
        self.at_open: Optional[dict] = None
        self.at_close: Optional[dict] = None
        self.host: Dict[str, List[Tuple[int, int]]] = defaultdict(list)
        self.host_mono: List[Tuple[float, float]] = []   # dispatch calls
        self.iterations: List[Iteration] = []
        self.profile_due: Optional[Tuple[float, float]] = None
        self._prof = None
        self.profile: Optional[dict] = None
        self.profile_mono: Optional[Tuple[float, float]] = None
        self._t_open_mono = None
        self._wrap(cluster, "step", "cluster_step", self._after_step)
        if traced:
            self._wrap(cluster.balancer, "tick", "balancer_tick")
            for e in cluster.engines:
                for attr in ("dispatch_iteration", "sync", "collect"):
                    self._wrap(e, attr, f"engine_{attr}")
                self._log_iterations(e.runner)

    def _wrap(self, obj, attr, name, after=None):
        f = getattr(obj, attr)
        traced, spans = self.traced, self.host[name]
        mono = self.host_mono if name == "engine_dispatch_iteration" else None

        def wrapped(*a, **kw):
            if traced:
                t0, m0 = time.time_ns(), time.monotonic()
            out = f(*a, **kw)
            if traced:
                spans.append((t0, time.time_ns()))
                if mono is not None:
                    mono.append((m0, time.monotonic()))
            if after is not None:
                after(out)
            return out

        setattr(obj, attr, wrapped)

    def _log_iterations(self, runner):
        f = runner.run_iteration
        log = self.iterations

        def run_iteration(batch):
            lp = batch.tokens_p.shape[1] if batch.tokens_p.ndim == 2 else 0
            chunks, s = [], 0
            for seg in batch.segments:
                if seg.kind == "prefill":
                    n = int(batch.sample_rows[s]) - s * lp + 1
                    start = int(batch.positions_p[s, 0])
                    chunks.append((start, start + n))
                    s += 1
            n_dec = len(batch.segments) - s
            ctx = (batch.positions_d[:n_dec] + 1).tolist()
            log.append(Iteration(time.monotonic(), ctx, chunks,
                                 sum(seg.emits_token
                                     for seg in batch.segments)))
            return f(batch)

        runner.run_iteration = run_iteration

    # -- the window -----------------------------------------------------------
    def generated(self) -> int:
        """Every token handed out so far: those of finished calls and of
        calls still on an engine."""
        live = sum(r.output_len for e in self.cluster.engines
                   for r in list(e.running) + list(e.waiting))
        return self.finished_tokens + live

    def counters(self) -> dict:
        out = defaultdict(int)
        for e in self.cluster.engines:
            st = e.stats
            out["prefill_tokens"] += st.prefill_tokens
            out["prefill_tokens_saved"] += st.prefill_tokens_saved
            out["n_preempted"] += st.n_preempted
            out["n_finished"] += st.n_finished
        out["generated"] = self.generated()
        return dict(out)

    def _after_step(self, done):
        for r in done:
            self.calls.append(CallRecord(
                r.req_id, r.msg_id, r.agent_name,
                np.asarray(r.prompt_tokens), list(r.output_tokens),
                r.max_new_tokens, r.arrival_time, r.first_token_time,
                r.finish_time, r.state.value))
            self.finished_tokens += r.output_len
        now = time.monotonic()
        if self.at_open is None and now >= self.open_due:
            self.at_open = self.counters()
            self._t_open_mono = now
        if self.profile_due is not None:
            self._profile_step(now)

    def close_window(self) -> None:
        """The window's last counters; then the traced slice, which ends
        here, is read (its reading takes seconds, so after the close)."""
        if self._prof is not None:
            torch.cuda.synchronize()
        now = time.monotonic()
        self.at_close = self.counters()
        self.window = (self._t_open_mono, now)
        if self._prof is not None:
            self._stop_profile()

    # -- the traced slice -----------------------------------------------------
    def _profile_step(self, now: float) -> None:
        if (self._prof is None and self.profile is None
                and now >= self.profile_due[0]):
            from torch.profiler import ProfilerActivity, profile
            torch.cuda.synchronize()
            self._prof = profile(activities=[ProfilerActivity.CUDA])
            self._prof.__enter__()
            self._prof_t0 = (time.time_ns(), time.monotonic())

    def _stop_profile(self) -> None:
        t1 = (time.time_ns(), time.monotonic())
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        events = prof.profiler.kineto_results.events()
        self.profile = profiling.reduce(events, self._prof_t0[0], t1[0],
                                        self.host)
        self.profile_mono = (self._prof_t0[1], t1[1])
        del events, prof


def warm_profiler() -> None:
    """Start and stop the profiler once, so that its first start does not
    fall inside the traced window."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]):
        torch.zeros(1, device="cuda").add_(1)
        torch.cuda.synchronize()


class SmiSampler(threading.Thread):
    """``nvidia-smi`` clocks, power and temperature every few seconds."""

    QUERY = ("index,clocks.sm,clocks.mem,power.draw,power.limit,"
             "temperature.gpu")

    def __init__(self):
        super().__init__(name="portbench-smi", daemon=True)
        self.samples: List[list] = []
        self._halt = threading.Event()

    def run(self) -> None:
        t0 = time.monotonic()
        while not self._halt.is_set():
            try:
                out = subprocess.run(
                    ["nvidia-smi", f"--query-gpu={self.QUERY}",
                     "--format=csv,noheader,nounits"], capture_output=True,
                    text=True, timeout=10).stdout
                for line in out.strip().splitlines():
                    self.samples.append([round(time.monotonic() - t0, 3)]
                                        + [v.strip() for v in line.split(",")])
            except (OSError, subprocess.SubprocessError) as e:
                self.samples.append(["error", str(e)])
                return
            self._halt.wait(SMI_PERIOD_S)

    def stop(self) -> None:
        self._halt.set()
        self.join(timeout=30)


def card_name_and_limit() -> Tuple[str, str]:
    name = torch.cuda.get_device_name(0)
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        limit = "unknown"
    return name, limit


# =============================================================================
# set-up
# =============================================================================


def build_workflow(cell: Cell, arch: Arch, weights: dict, device,
                   traced: bool, check_registry: bool = True):
    """The cluster ``Workflow.add_engine`` builds, on the benchmark's
    weights at the configuration's widths."""
    from repro_torch.agents import Workflow
    from repro_torch.models import build_model
    from repro_torch.obs import Tracer
    from repro_torch.obs.trace import NULL_TRACER
    from repro_torch.serving import (
        ServingCluster,
        ServingConfig,
        reset_request_ids,
    )
    reset_request_ids()
    cfg = port_config(cell.config, arch, check_registry)
    tracer = Tracer(capacity_per_instance=1 << 21) if traced else NULL_TRACER
    wf = Workflow(app_name=cell.traffic_name,
                  config=ServingConfig(**cell.config["serving"]),
                  tracer=tracer, device=device, llm_timeout_s=LLM_TIMEOUT_S)
    wf.cluster = ServingCluster.from_config(
        build_model(cfg), weights, wf.orch, wf.config,
        pipelined=wf.pipelined, tracer=wf.tracer, device=device)
    wf.vocab_size = arch.vocab
    return wf


def warm_up(cluster, traffic: Traffic, n: int, seed: int, vocab: int):
    """A burst of ``n`` calls with prompts spread over the lengths the mix
    sends, straight into the cluster, drained: every kernel and the
    chunk, decode and context shapes of the mix run once."""
    from repro_torch.serving import Request
    lo, hi = traffic.prompt_lengths()
    rng = np.random.default_rng([seed % 2 ** 64, _WARM])
    agents = traffic.agents
    now = time.monotonic()
    for i, length in enumerate(np.geomspace(lo, hi, n).round().astype(int)):
        cluster.submit(Request(
            agent_name=agents[i % len(agents)], msg_id=f"warm-{i}",
            app_name="warm-up", prompt_len=int(length),
            prompt_tokens=rng.integers(0, vocab, int(length)).astype(np.int32),
            max_new_tokens=8, arrival_time=now, app_start_time=now))
    done = 0
    while done < n:
        done += len(cluster.step())


# =============================================================================
# the run
# =============================================================================


@dataclasses.dataclass
class RunResult:
    setup_s: float
    end_to_end: dict
    window: Tuple[float, float]
    workflows: List[WorkflowRecord]
    calls: List[CallRecord]
    failed: int
    submitted: int
    recorder: Recorder
    delays: Dict[Tuple[str, int], float]
    events: list
    memory_peak_bytes: int
    verdict: Optional[check.Verdict]
    smi: List[list]
    traffic: Traffic
    arch: Arch
    drain_s: float
    accounting: dict


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, device,
             t_start: float, *, check_registry: bool = True,
             run_check: bool = True, after_setup=None,
             drain_s: float = DRAIN_S) -> RunResult:
    """Run ``cell`` once.  ``after_setup(wf)`` (tests) may replace parts of
    the program once it is built.  After the window, no workflow starts;
    those open are waited for, ``drain_s`` at the most, so that a call
    that never comes back is counted."""
    cuda = torch.device(device).type == "cuda"
    arch = arch_of(cell.config)
    weights = make_weights(arch, seed, device)
    wf = build_workflow(cell, arch, weights, device, traced, check_registry)
    traffic = Traffic(cell.traffic, seed, arch.vocab)
    warm_up(wf.cluster, traffic, int(cell.config.get("warm_requests", 8)),
            seed, arch.vocab)
    if after_setup is not None:
        after_setup(wf)
    if cuda:
        if traced:
            warm_profiler()
        torch.cuda.synchronize()
    rec = Recorder(wf.cluster, traced)

    t_setup = time.monotonic()
    setup_s = t_setup - t_start
    # sessions start from now on; the window opens after the mix's warm-up
    sessions = SessionLoop(wf, traffic, t_setup)
    delays: Dict[Tuple[str, int], float] = {}
    cls = agent_classes(traffic, sessions, delays)
    for a in traffic.agents:
        wf.add_agent(a, cls)
    rec.open_due = t_setup + float(cell.traffic["warmup_s"])
    rec.close_due = rec.open_due + seconds
    if traced and cuda:
        rec.profile_due = (rec.close_due - min(PROFILE_SECONDS, seconds / 2),
                           rec.close_due)
    smi = SmiSampler() if cuda else None
    sessions.start()
    while True:
        now = time.monotonic()
        if smi is not None and smi.ident is None and now >= rec.open_due:
            smi.start()
        if now >= rec.close_due and rec.at_open is not None:
            break
        until = (rec.open_due if now < rec.open_due else rec.close_due)
        wf.run(timeout=max(0.01, until - now))
        if not wf.cluster.has_work:
            time.sleep(0.002)
    rec.close_window()
    sessions.stop_submitting()
    if smi is not None and smi.ident is not None:
        smi.stop()
    t_close = time.monotonic()
    while sessions.n_open and time.monotonic() < t_close + drain_s:
        wf.run(timeout=min(0.5, t_close + drain_s - time.monotonic()))
        if not wf.cluster.has_work:
            time.sleep(0.002)
    drain_s = time.monotonic() - t_close
    sessions.stop()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    e2e = measure.end_to_end(sessions.workflows, rec.calls, rec.window,
                             rec.at_open["generated"],
                             rec.at_close["generated"])
    events = wf.tracer.events() if traced else []

    # the program's state goes before the reference runs
    cluster, wf.cluster = wf.cluster, None
    cluster.close()
    rec.cluster = None
    del cluster, wf
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    in_window = [c for c in rec.calls if measure.inside(c.t_finish,
                                                        rec.window)]
    acct = check.accounting(rec.calls, sessions.n_failed,
                            len(sessions.calls_out), sessions.n_open)
    verdict = None
    if run_check:
        chk = cell.config["check"]
        picked = check.sample(in_window, seed, chk["min_tokens"],
                              chk["max_calls"])
        gaps = check.served_gaps(weights, arch, picked, device)
        verdict = check.verdict(
            acct, gaps,
            {k: float(v) for k, v in chk["limits"].items()},
            int(chk["min_tokens"]))
        verdict.gaps = check.gap_numbers(gaps)
    return RunResult(setup_s, e2e, rec.window, sessions.workflows, rec.calls,
                     sessions.n_failed, sessions.n_submitted, rec, delays,
                     events, peak, verdict, smi.samples if smi else [],
                     traffic, arch, drain_s, acct)
