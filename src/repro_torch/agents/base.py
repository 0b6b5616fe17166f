"""Kairos developer API (paper Listing 1): ``BaseAgent`` + ``Workflow``.

Agents subclass :class:`BaseAgent`, override ``_run_impl`` and call
``self.generate(...)`` to hit the shared LLM service — the call blocks
(the paper's multi-threaded architecture) while the driver loop runs the
load balancer and engine iterations.  System identifiers are injected and
propagated transparently through the message bus.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.agents.messaging import Headers, MessageBus
from repro_torch.core import Orchestrator
from repro_torch.core.orchestrator import HardwareProfile
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.obs.trace import NULL_TRACER, TraceContext, Tracer
from repro_torch.serving import LLMEngine, ServingCluster, ServingConfig
from repro_torch.serving.request import Request, RequestState


class BaseAgent:
    """Subclass and override ``_run_impl(input_data, metadata)``; return
    ``(output_payload, next_agent_name_or_None)``.

    ``system_prompt`` (class attribute or ``add_agent`` argument) declares
    the agent's fixed preamble.  It is prepended to every ``generate``
    call and flagged as a shareable prefix, so engines with prefix caching
    serve its KV from shared pages instead of re-prefilling it, and the
    dispatcher's memory ramps stop double-counting it."""

    system_prompt: str = ""

    def __init__(self, name: str, workflow: "Workflow"):
        self.name = name
        self.workflow = workflow
        self._sys_tokens: Optional[np.ndarray] = None

    def system_prompt_tokens(self) -> np.ndarray:
        if self._sys_tokens is None:
            self._sys_tokens = (self.encode_prompt(self.system_prompt)
                                if self.system_prompt
                                else np.zeros((0,), np.int32))
        return self._sys_tokens

    # -- LLM access (Listing 1: ``self.generate``) ---------------------------
    def generate(self, prompt_tokens, metadata: Headers, max_new_tokens: int = 16) -> List[int]:
        sys_toks = self.system_prompt_tokens()
        shared = len(sys_toks)
        if shared:
            prompt_tokens = np.concatenate(
                [sys_toks, np.asarray(prompt_tokens, np.int32)])
        return self.workflow._llm_call(self.name, prompt_tokens, metadata,
                                       max_new_tokens, shared_prefix_len=shared)

    def encode_prompt(self, text: str, length: Optional[int] = None) -> np.ndarray:
        """Deterministic synthetic tokenizer stand-in."""
        rng = np.random.default_rng(abs(hash(text)) & 0x7FFFFFFF)
        n = length or max(4, len(text) // 4)
        return rng.integers(0, self.workflow.vocab_size, n).astype(np.int32)

    def _run_impl(self, input_data: dict, metadata: Headers) -> Tuple[dict, Optional[str]]:
        raise NotImplementedError


class Workflow:
    """Define engines + agents, then ``run(...)`` user tasks through the
    Kairos load balancer over real paged-KV engine instances.

    Serving knobs come in as ONE :class:`ServingConfig` (``config=``).
    The per-knob constructor kwargs (``num_blocks=...``, ...) raise
    ``TypeError`` pointing at ``ServingConfig``.

    ``device`` is where :meth:`add_engine` builds the model and its
    pools: ``None`` means the CUDA card and raises without one (checked
    here, not later); tests pass ``device="cpu"``."""

    _REMOVED_KWARGS = ("n_instances", "num_blocks", "block_size",
                       "max_batch", "prefix_caching",
                       "prefill_chunk_tokens")

    def __init__(self, app_name: str = "app",
                 config: Optional[ServingConfig] = None, *,
                 pipelined: bool = True, llm_timeout_s: float = 300.0,
                 tracer: Tracer = NULL_TRACER, device=None, **legacy):
        if legacy:
            removed = sorted(k for k in legacy if k in self._REMOVED_KWARGS)
            if removed:
                raise TypeError(
                    "Workflow's per-knob serving kwargs were removed; pass "
                    f"config=ServingConfig({', '.join(removed)}, ...) "
                    "instead")
            raise TypeError(
                f"unexpected keyword arguments {sorted(legacy)}")
        if config is None:
            config = ServingConfig(max_batch=4)
        self.device = resolve_device(device)
        self.app_name = app_name
        self.config = config
        self.prefix_caching = config.prefix_caching
        self.prefill_chunk_tokens = config.prefill_chunk_tokens
        self.pipelined = pipelined
        self.llm_timeout_s = llm_timeout_s
        self.tracer = tracer
        self.bus = MessageBus()
        self.orch = Orchestrator(hardware=HardwareProfile(
            decode_tok_per_s=20.0,
            kv_capacity_tokens=config.kv_capacity_tokens),
            prefix_caching=config.prefix_caching, tracer=tracer)
        self.agents: Dict[str, BaseAgent] = {}
        self.vocab_size = 512
        self._submissions: "queue.Queue[Tuple[Request, threading.Event, list]]" = queue.Queue()
        self._pending: Dict[int, Tuple[Request, threading.Event, list]] = {}
        self._threads: List[threading.Thread] = []
        self._results: Dict[str, dict] = {}
        self._outstanding = 0
        self._lock = threading.Lock()
        self.cluster: Optional[ServingCluster] = None

    @property
    def balancer(self):
        """Back-compat alias: the cluster owns the load balancer now."""
        return self.cluster.balancer if self.cluster is not None else None

    @property
    def engines(self) -> List[LLMEngine]:
        """Back-compat alias; under elasticity the engine list changes at
        runtime, so don't cache it — prefer the cluster contract
        (``submit``/``step``/``drain``/``metrics_snapshot``)."""
        return self.cluster.engines if self.cluster is not None else []

    # ------------------------------------------------------------------ setup
    def add_engine(self, name: str, model: str = "qwen3-1.7b", seed: int = 0):
        """Instantiate the serving cluster described by ``self.config``,
        serving the REDUCED variant of the named architecture (CPU
        container; full configs go through the dry-run), with weights
        from the port's initialiser seeded by an explicit
        ``torch.Generator(device).manual_seed(seed)``.
        ``ServingCluster.from_config`` wires everything the hand-rolled
        loop used to: per-instance runners cloned from one runner,
        orchestrator-backed instance scheduling, OOM fencing feedback,
        the instance schedulers' ``can_admit`` as the dispatcher's admit
        probe — and an engine factory so an attached autoscaler can grow
        the cluster later."""
        from repro_torch.configs import get_config
        cfg = get_config(model).reduced()
        self.vocab_size = cfg.vocab_size
        m = build_model(cfg)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        params = m.init_params(gen, device=self.device)
        self.cluster = ServingCluster.from_config(
            m, params, self.orch, self.config, device=self.device,
            pipelined=self.pipelined, tracer=self.tracer)

    def add_agent(self, agent_name: str, agent_class, use_model: str = "",
                  system_prompt: Optional[str] = None):
        agent = agent_class(agent_name, self)
        if system_prompt is not None:
            agent.system_prompt = system_prompt
        self.agents[agent_name] = agent
        self.bus.subscribe(agent_name, self._on_message)

    # ------------------------------------------------------------------ llm
    def _llm_call(self, agent_name: str, prompt_tokens, metadata: Headers,
                  max_new_tokens: int, shared_prefix_len: int = 0) -> List[int]:
        retries = self.config.llm_retries
        backoff = self.config.llm_backoff_s
        for attempt in range(retries + 1):
            req = Request(
                agent_name=agent_name, msg_id=metadata.msg_id,
                upstream_name=metadata.upstream_name, app_name=metadata.app_name,
                prompt_len=len(prompt_tokens), prompt_tokens=np.asarray(prompt_tokens),
                max_new_tokens=max_new_tokens,
                shared_prefix_len=shared_prefix_len, cache_key=agent_name,
                arrival_time=time.monotonic(), app_start_time=metadata.app_start_time)
            if self.tracer.enabled:
                # workflow trace context: msg_id is the trace id, this LLM
                # call is one span, descended from the upstream agent stage —
                # obs/critical_path.py stitches these into the workflow DAG
                req.trace = TraceContext(trace_id=metadata.msg_id,
                                         span_id=req.req_id,
                                         parent_name=metadata.upstream_name)
            ev = threading.Event()
            box: list = []
            self._submissions.put((req, ev, box))
            if ev.wait(timeout=self.llm_timeout_s):
                if req.state in (RequestState.FAILED, RequestState.SHED):
                    # the serving layer gave up on this request (recovery
                    # budget spent, or the overload valve shed it) — fail
                    # the workflow rather than hand back a bogus stream
                    raise RuntimeError(
                        f"LLM call by agent {agent_name!r} "
                        f"(msg {metadata.msg_id}) was "
                        f"{'shed' if req.state is RequestState.SHED else 'failed'}"
                        " by the serving layer")
                return box[0]
            if attempt < retries:
                # capped exponential backoff, then a FRESH request: the
                # timed-out one may still finish later — its orphaned
                # event/box pair just gets dropped.  Retries stay inside
                # this call, so the workflow's outstanding count is
                # untouched until the stage truly fails.
                time.sleep(min(backoff * (2.0 ** attempt), 8.0 * backoff))
        # surface the deadlock instead of masking it as an empty
        # generation: the exception propagates through the agent
        # thread, which marks this workflow failed in the results
        raise TimeoutError(
            f"LLM call by agent {agent_name!r} (msg {metadata.msg_id}) "
            f"timed out after {self.llm_timeout_s:.0f}s "
            f"({retries + 1} attempt{'s' if retries else ''})")

    # ------------------------------------------------------------------ agents
    def _on_message(self, msg):
        agent = self.agents[msg.topic]

        def work():
            try:
                out, nxt = agent._run_impl(msg.payload, msg.headers)
            except Exception as e:
                # a failed stage (e.g. an LLM-call TimeoutError) ends its
                # workflow with an error result instead of hanging run()
                # on an _outstanding count that never reaches zero
                with self._lock:
                    self._results[msg.headers.msg_id] = {
                        "failed": True, "agent": agent.name,
                        "error": f"{type(e).__name__}: {e}"}
                    self._outstanding -= 1
                # finalize the partial trace like the success path does:
                # earlier stages' completion records must not park in the
                # analyzer forever (and their latency samples still feed
                # the priority distributions)
                self.orch.on_workflow_complete(msg.headers.msg_id)
                return
            if nxt is not None:
                self.bus.publish(nxt, out, Headers(
                    msg_id=msg.headers.msg_id, app_name=msg.headers.app_name,
                    upstream_name=agent.name,
                    app_start_time=msg.headers.app_start_time))
            else:
                with self._lock:
                    self._results[msg.headers.msg_id] = out
                    self._outstanding -= 1
                self.orch.on_workflow_complete(msg.headers.msg_id)

        t = threading.Thread(target=work, daemon=True)
        t.start()
        self._threads.append(t)

    # ------------------------------------------------------------ observability
    def trace_spans(self):
        """Agent-stage spans stitched from the shared tracer's event
        streams (one span per LLM call, linked by upstream agent)."""
        from repro_torch.obs.critical_path import spans_from_events
        return spans_from_events(self.tracer.events())

    def critical_path(self, msg_id: str):
        """End-to-end critical path of one workflow: the causal chain of
        agent stages ending at the last finisher, with per-stage
        queue/prefill/decode and orchestration-gap breakdown."""
        from repro_torch.obs.critical_path import critical_path
        return critical_path(self.trace_spans(), msg_id)

    def metrics_snapshot(self) -> dict:
        """The cluster's flattened metrics registry snapshot."""
        assert self.cluster is not None, "call add_engine first"
        return self.cluster.metrics_snapshot()

    def prefix_cache_stats(self) -> dict:
        """Aggregate prefill-token savings across engine instances,
        derived from the cluster's public metrics snapshot."""
        snap = self.cluster.metrics_snapshot()

        def total(metric: str) -> float:
            return sum(v for k, v in snap.items()
                       if k.endswith(f".{metric}"))

        saved = total("prefill_tokens_saved")
        prefill = total("prefill_tokens")
        return {"prefill_tokens": prefill, "prefill_tokens_saved": saved,
                "kv_cached_tokens": total("kv_cached_tokens"),
                "savings": saved / max(prefill + saved, 1)}

    # ------------------------------------------------------------------ run
    def submit_task(self, entry_agent: str, input_data: dict) -> str:
        msg_id = self.bus.new_msg_id(self.app_name)
        with self._lock:
            self._outstanding += 1
        self.bus.publish(entry_agent, input_data, Headers(
            msg_id=msg_id, app_name=self.app_name, upstream_name=None,
            app_start_time=time.monotonic()))
        return msg_id

    def run(self, timeout: float = 300.0) -> Dict[str, dict]:
        """Driver loop: drain bus -> agent threads -> cluster step.

        The cluster step runs the balancer tick, the breadth-first
        pipelined engine iterations, and the control-plane feedback
        (completion records, dispatcher slot release, OOM fencing); this
        loop only bridges agent threads to it."""
        assert self.cluster is not None, "call add_engine first"
        t_end = time.monotonic() + timeout
        while time.monotonic() < t_end:
            with self._lock:
                if self._outstanding == 0 and self._submissions.empty():
                    break
            # prune finished agent threads (long-lived workflows would
            # otherwise accumulate one dead Thread object per message)
            self._threads = [t for t in self._threads if t.is_alive()]
            self.bus.drain()
            while not self._submissions.empty():
                req, ev, box = self._submissions.get()
                self._pending[req.req_id] = (req, ev, box)
                self.cluster.submit(req)
            for r in self.cluster.step():
                _, ev, box = self._pending.pop(r.req_id)
                box.append(list(r.output_tokens))
                ev.set()
            if not self.cluster.has_work:
                time.sleep(0.002)
        return dict(self._results)
