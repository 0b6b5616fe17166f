"""Workflow Orchestrator (§4): collects execution info online, updates the
workflow analyzer and the distribution profiler, and serves the derived
signals (agent priorities, expected execution times, memory ramps) to the
scheduler and dispatcher.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.distributions import DistributionProfiler
from repro_torch.core.memory_model import MemoryRamp, make_ramp
from repro_torch.core.priority import PriorityTable
from repro_torch.core.workflow import WorkflowAnalyzer
from repro_torch.obs.trace import NULL_TRACER, Tracer
from repro_torch.serving.request import CompletionRecord, Request

# EMA smoothing for the measured per-agent TTFT / TPOT feeds (tracing
# mode): recent completions dominate, old load regimes decay in ~10
# completions — the same spirit as the paper's online profile updates.
_EMA_ALPHA = 0.2


@dataclasses.dataclass
class HardwareProfile:
    """Prior profiling constants (paper: A40; here: v5e-class, DESIGN.md §3)."""
    decode_tok_per_s: float = 30.0        # per-request decode speed (Eq.1 `k`)
    kv_capacity_tokens: int = 8192        # per instance


@dataclasses.dataclass
class ArchMemoryTraits:
    """Architecture adaptation of Eq. 1 (DESIGN.md §4)."""
    kv_ratio: float = 1.0                 # fraction of layers with KV growth
    state_tokens: float = 0.0             # constant recurrent state (token-equiv)


class Orchestrator:
    def __init__(self, hardware: Optional[HardwareProfile] = None,
                 arch_traits: Optional[ArchMemoryTraits] = None,
                 priority_refresh: int = 64,
                 prefix_caching: bool = False,
                 tracer: Tracer = NULL_TRACER):
        self.hw = hardware or HardwareProfile()
        self.traits = arch_traits or ArchMemoryTraits()
        self.analyzer = WorkflowAnalyzer()
        self.profiler = DistributionProfiler()
        self.priorities = PriorityTable(interval=priority_refresh)
        # engines run the shared-prefix KV cache: memory ramps discount the
        # declared shared prefix so the dispatcher doesn't double-count it
        self.prefix_caching = prefix_caching
        # with tracing enabled, expected_exec_time feeds from *measured*
        # first-token/decode timings (EMA per agent) instead of the
        # static mode-of-distribution guess; the static path stays the
        # fallback for agents with no measured spans yet
        self.tracer = tracer
        self._ttft_ema: dict = {}
        self._tpot_ema: dict = {}

    # ------------------------------------------------------------------ intake
    def on_completion(self, rec: CompletionRecord):
        self.analyzer.add_record(rec)
        # single-request distribution uses pure execution latency (Eq. 2)
        self.profiler.record(rec.agent_name, rec.exec_latency, rec.output_len)
        if self.tracer.enabled and rec.first_token_time >= 0 \
                and rec.exec_start_time >= 0:
            ttft = rec.first_token_time - rec.exec_start_time
            tpot = (rec.end_time - rec.first_token_time) \
                / max(rec.output_len - 1, 1)
            if ttft >= 0 and tpot >= 0:
                a = rec.agent_name
                old_f, old_p = self._ttft_ema.get(a), self._tpot_ema.get(a)
                self._ttft_ema[a] = ttft if old_f is None \
                    else old_f + _EMA_ALPHA * (ttft - old_f)
                self._tpot_ema[a] = tpot if old_p is None \
                    else old_p + _EMA_ALPHA * (tpot - old_p)
        self.priorities.tick_completion()

    def on_workflow_complete(self, msg_id: str):
        self.analyzer.finalize_trace(msg_id)
        self.priorities.maybe_refresh(
            {k: v.samples for k, v in self.analyzer.remaining.items()})

    def refresh_priorities(self):
        self.priorities.maybe_refresh(
            {k: v.samples for k, v in self.analyzer.remaining.items()}, force=True)

    # ------------------------------------------------------------------ queries
    def priority_score(self, app: str, agent: str) -> float:
        s = self.priorities.score(app, agent)
        if s == float("inf"):
            # cold start: fall back to single-request expected latency
            return 1e6 + self.profiler.expected_exec_time(agent, default=1.0)
        return s

    def remaining_stages(self, app: str, agent: str) -> int:
        return self.analyzer.remaining_stages(app, agent)

    def expected_exec_time(self, agent: str) -> float:
        """Expected single-request execution latency for one agent call.

        Traced mode composes it from measured spans — EMA(TTFT) +
        EMA(TPOT) x expected output length — which tracks load shifts
        (queue-free TTFT vs congested TTFT) the static
        mode-of-distribution estimate averages away.  Untraced, or for
        an agent with no measured completions yet, the profiler's mode
        estimate answers exactly as before."""
        if self.tracer.enabled and agent in self._ttft_ema:
            return self._ttft_ema[agent] + self._tpot_ema[agent] \
                * max(self.profiler.expected_output_len(agent) - 1, 1)
        return self.profiler.expected_exec_time(agent)

    def memory_ramp(self, req: Request, now: float) -> MemoryRamp:
        # conservative reservation: P75 of the agent's exec-latency samples
        # (the paper's mode estimate under-reserves for heavy-tailed agents;
        # EXPERIMENTS.md §Perf records this beyond-paper refinement)
        d = self.profiler.latency.get(req.agent_name)
        t = d.percentile(75) if d and len(d) >= 8 else self.expected_exec_time(req.agent_name)
        return make_ramp(
            prompt_len=req.prompt_len,
            expected_exec_time=t,
            decode_tok_per_s=self.hw.decode_tok_per_s,
            t_start=now,
            kv_ratio=self.traits.kv_ratio,
            state_tokens=self.traits.state_tokens,
            shared_prefix_tokens=(req.shared_prefix_len
                                  if self.prefix_caching else 0),
        )
