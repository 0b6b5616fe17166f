"""Request objects shared by the load balancer, engines, and simulator.

A request carries the Kairos **system identifiers** (§4.1): agent name,
globally unique message id, upstream agent name, and execution timestamps.
``app_start_time`` is the application-level start time used by the
intra-agent scheduling mechanism (§5.2).
"""
from __future__ import annotations

import dataclasses
import enum
import itertools
from typing import Optional

_req_counter = itertools.count()


def reset_request_ids():
    """Restart the process-global request-id counter at zero.

    Request ids are tie-breakers in scheduling sort keys and preemption
    victim choice, so harnesses that need reproducible trajectories (the
    discrete-event simulator, property tests) call this instead of
    reaching into the private counter."""
    global _req_counter
    _req_counter = itertools.count()


class RequestState(enum.Enum):
    QUEUED = "queued"          # waiting at the load balancer
    WAITING = "waiting"        # dispatched to an instance, not yet admitted
    RUNNING = "running"
    PREEMPTED = "preempted"
    FINISHED = "finished"
    FAILED = "failed"          # recovery retry budget exhausted
    SHED = "shed"              # dropped by the overload valve (never ran)


class RequestPhase(enum.Enum):
    """Where the request sits in its compute lifecycle — orthogonal to
    :class:`RequestState` (a PREFILL request can be queued, waiting, or
    mid-chunked-prefill).  Role-typed dispatch routes on this: PREFILL
    work may only land on ``prefill``/``general`` instances, DECODE work
    on ``decode``/``general`` ones.  The scheduler flips PREFILL→DECODE
    when the last prompt chunk is composed, and back on
    recompute-preemption (resident KV is dropped, the prompt must be
    re-prefilled)."""
    PREFILL = "prefill"        # prompt KV not yet fully resident
    DECODE = "decode"          # prompt resident; generating tokens


@dataclasses.dataclass
class Request:
    # --- identity / Kairos system identifiers (§4.1) ------------------------
    agent_name: str
    msg_id: str
    upstream_name: Optional[str] = None
    app_name: str = ""
    req_id: int = dataclasses.field(default_factory=lambda: next(_req_counter))

    # --- workload ------------------------------------------------------------
    prompt_len: int = 0
    prompt_tokens: Optional[object] = None      # jnp array for the real engine
    max_new_tokens: int = 512
    true_output_len: int = 0                    # sim: hidden until executed

    # --- shared-prefix KV reuse (prefix_cache.py) ----------------------------
    shared_prefix_len: int = 0      # declared shareable prefix (agent system
    #                                 prompt) — the dispatcher discounts these
    #                                 tokens so shared KV isn't double-counted
    cache_key: Optional[str] = None  # sim: identity of the shared prefix
    cached_prefix_len: int = 0      # observed at admission: tokens served
    #                                 from cache (prefill skipped)
    prefix_hashes: Optional[list] = None  # memoized block-hash chain of the
    #                                 (immutable) prompt — a stalled request
    #                                 retries admission every engine step

    # --- timestamps (§4.1 Execution Timestamps) ------------------------------
    app_start_time: float = 0.0                 # arrival at the frontend
    arrival_time: float = 0.0                   # arrival at this LLM stage
    exec_start_time: float = -1.0               # LLM execution start
    first_token_time: float = -1.0              # first generated token (TTFT)
    finish_time: float = -1.0

    # --- observability -------------------------------------------------------
    trace: Optional[object] = None              # obs.TraceContext when traced

    # --- runtime state --------------------------------------------------------
    state: RequestState = RequestState.QUEUED
    phase: RequestPhase = RequestPhase.PREFILL
    prefilled_len: int = 0          # prompt tokens whose KV is resident
    #                                 (cached prefix + executed prefill
    #                                 chunks); == prompt_len once decodable
    output_len: int = 0
    n_preemptions: int = 0
    instance_id: int = -1
    output_tokens: list = dataclasses.field(default_factory=list)

    @property
    def total_len(self) -> int:
        return self.prompt_len + self.output_len

    @property
    def exec_latency(self) -> float:
        if self.exec_start_time < 0 or self.finish_time < 0:
            return float("nan")
        return self.finish_time - self.exec_start_time

    @property
    def e2e_latency(self) -> float:
        return self.finish_time - self.arrival_time

    def queueing_time(self) -> float:
        if self.exec_start_time < 0:
            return float("nan")
        return self.exec_start_time - self.arrival_time


@dataclasses.dataclass
class CompletionRecord:
    """What the orchestrator collects when a request finishes (§4).

    ``start_time`` is the stage arrival (used for *remaining* end-to-end
    latency, which legitimately includes queueing); ``exec_start_time`` is
    the LLM execution start (used for the single-request execution latency
    distribution that feeds the memory ramps, Eq. 2)."""
    agent_name: str
    msg_id: str
    upstream_name: Optional[str]
    app_name: str
    start_time: float
    end_time: float
    prompt_len: int
    output_len: int
    exec_start_time: float = -1.0
    first_token_time: float = -1.0

    @property
    def latency(self) -> float:
        return self.end_time - self.start_time

    @property
    def exec_latency(self) -> float:
        t0 = self.exec_start_time if self.exec_start_time >= 0 else self.start_time
        return self.end_time - t0
