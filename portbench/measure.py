"""The arithmetic of the measured window, on plain records.

Every percentile is taken over all samples of the window (numpy's linear
interpolation), never over a bounded history or over chunks.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class WorkflowRecord:
    session: int
    msg_id: str
    t_submit: float          # the session's Workflow.submit_task
    t_done: float            # the last agent's answer in hand


@dataclasses.dataclass
class CallRecord:
    """One finished LLM call, as the cluster handed it back."""
    req_id: int
    msg_id: str
    agent: str
    prompt: np.ndarray
    output: List[int]
    max_new_tokens: int
    t_arrival: float
    t_first: float
    t_finish: float
    state: str


def percentile(xs: Sequence[float], p: float) -> Optional[float]:
    return float(np.percentile(np.asarray(xs, float), p)) if len(xs) else None


def inside(t: float, window) -> bool:
    return window[0] <= t <= window[1]


def end_to_end(workflows: Sequence[WorkflowRecord],
               calls: Sequence[CallRecord], window,
               tokens_at_open: int, tokens_at_close: int) -> Dict[str, float]:
    """The end-to-end metrics of one window ``(t_open, t_close)``."""
    e2e = [w.t_done - w.t_submit for w in workflows
           if inside(w.t_done, window)]
    tpot = [(c.t_finish - c.t_first) / (len(c.output) - 1) for c in calls
            if inside(c.t_finish, window) and len(c.output) > 1]
    span = window[1] - window[0]
    return {"workflow_e2e_p50_s": percentile(e2e, 50),
            "workflow_e2e_p90_s": percentile(e2e, 90),
            "output_tokens_per_s": (tokens_at_close - tokens_at_open) / span,
            "tpot_p95_ms": (None if not tpot
                            else percentile(tpot, 95) * 1e3),
            "workflows": len(e2e), "calls": len(tpot)}
