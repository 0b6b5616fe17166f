"""SLO attainment and goodput-under-SLO (ROADMAP item 5).

Bare wall/token says how fast a system is; *goodput under SLO* says how
much of that speed users actually experience — the fraction (and rate)
of workflows whose end-to-end deadline was met, plus per-request TTFT /
TPOT / e2e attainment (Astraea's deadline-aware framing, PAPERS.md).

Inputs are deliberately plain: per-request records need ``msg_id``,
``arrival``/``exec_start``/``first_token``/``finish`` timestamps and an
``output_len`` — satisfied by both :class:`~repro_torch.serving.request.Request`
(real path and sim) and the stage spans ``critical_path.py`` rebuilds
from trace events, so SLO reports diff across sim and real runs.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, List, Optional


@dataclasses.dataclass(frozen=True)
class SLO:
    """Per-request latency targets + per-workflow deadline (seconds).
    ``None`` disables a clause (it neither passes nor fails)."""
    ttft_s: Optional[float] = None        # time to first token
    tpot_s: Optional[float] = None        # mean time per output token
    e2e_s: Optional[float] = None         # request arrival -> finish
    workflow_deadline_s: Optional[float] = None   # workflow start -> done


@dataclasses.dataclass
class RequestSample:
    """The timing tuple one finished request contributes."""
    msg_id: str
    arrival: float
    finish: float
    output_len: int
    exec_start: float = -1.0
    first_token: float = -1.0

    @classmethod
    def from_request(cls, r) -> "RequestSample":
        return cls(msg_id=r.msg_id, arrival=r.arrival_time,
                   finish=r.finish_time, output_len=r.output_len,
                   exec_start=r.exec_start_time,
                   first_token=getattr(r, "first_token_time", -1.0))

    @property
    def ttft(self) -> float:
        if self.first_token < 0:
            return float("nan")
        return self.first_token - self.arrival

    @property
    def tpot(self) -> float:
        if self.first_token < 0:
            return float("nan")
        return (self.finish - self.first_token) / max(self.output_len - 1, 1)

    @property
    def e2e(self) -> float:
        return self.finish - self.arrival

    def meets(self, slo: SLO) -> bool:
        """Every enabled per-request clause holds.  A clause whose input
        timing is missing (NaN) fails closed — an unmeasured latency is
        not an attained one."""
        for target, value in ((slo.ttft_s, self.ttft),
                              (slo.tpot_s, self.tpot),
                              (slo.e2e_s, self.e2e)):
            if target is not None and not (value == value and value <= target):
                return False
        return True


def request_samples(requests: Iterable) -> List[RequestSample]:
    return [RequestSample.from_request(r) for r in requests
            if getattr(r, "finish_time", -1.0) >= 0]


def slo_report(samples: List[RequestSample], slo: SLO,
               duration_s: Optional[float] = None) -> Dict[str, float]:
    """Attainment + goodput in one flat dict.

    * ``request_attainment`` — fraction of finished requests meeting all
      enabled per-request clauses;
    * ``workflow_attainment`` (a.k.a. ``goodput_slo``) — fraction of
      workflows (grouped by ``msg_id``) whose span from first request
      arrival to last finish is within ``workflow_deadline_s`` AND whose
      every member request met its per-request clauses;
    * ``goodput_wf_per_s`` — attained workflows per second of
      ``duration_s`` (omitted when no duration is given);
    * ``good_token_frac`` — output tokens produced inside attained
      workflows / all output tokens (tokens spent on deadline-missing
      workflows are wasted work).
    """
    out: Dict[str, float] = {"n_requests": float(len(samples))}
    if not samples:
        out.update(request_attainment=0.0, workflow_attainment=0.0,
                   goodput_slo=0.0, good_token_frac=0.0, n_workflows=0.0)
        return out
    req_ok = [s.meets(slo) for s in samples]
    out["request_attainment"] = sum(req_ok) / len(samples)

    by_wf: Dict[str, List[int]] = {}
    for i, s in enumerate(samples):
        by_wf.setdefault(s.msg_id, []).append(i)
    n_good, good_tokens, all_tokens = 0, 0, 0
    for idxs in by_wf.values():
        span = max(samples[i].finish for i in idxs) \
            - min(samples[i].arrival for i in idxs)
        tokens = sum(samples[i].output_len for i in idxs)
        all_tokens += tokens
        ok = all(req_ok[i] for i in idxs)
        if slo.workflow_deadline_s is not None:
            ok = ok and span <= slo.workflow_deadline_s
        if ok:
            n_good += 1
            good_tokens += tokens
    out["n_workflows"] = float(len(by_wf))
    out["workflow_attainment"] = n_good / len(by_wf)
    out["goodput_slo"] = out["workflow_attainment"]
    out["good_token_frac"] = good_tokens / max(all_tokens, 1)
    if duration_s is not None and duration_s > 0:
        out["goodput_wf_per_s"] = n_good / duration_s
    return out


def percentile(xs: List[float], p: float) -> float:
    """Nearest-rank percentile over finite values; NaN-safe, no numpy."""
    xs = sorted(x for x in xs if x == x and not math.isinf(x))
    if not xs:
        return float("nan")
    i = min(len(xs) - 1, max(0, int(round(p / 100.0 * (len(xs) - 1)))))
    return xs[i]
