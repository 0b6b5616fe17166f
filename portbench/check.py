"""What decides ``correct``.

Two kinds of number are compared, each beside its limit:

* the control plane's accounting, exact (limit 0), over every call the
  traffic made, the window's and those before and after it (once the
  window closes no workflow starts and those open are waited for):
  calls that came back with another number of tokens than they asked
  for, calls that came back twice, calls asked for that never came
  back, workflows that failed or never ended;
* the served tokens: after the window, a sample drawn from the seed of
  the calls that finished in it, the call with the longest context
  always among them, until it holds ``min_tokens`` served tokens or
  ``max_calls`` calls.  The reference (``reference/model.py``) runs once
  over each prompt with its served tokens and reads, for each served
  token, the gap by which its logit lies below the reference's best at
  its position.  A configuration compares the widest gap
  (``logit_gap``), or where rounding alone spreads that as wide as the
  control does, the mean gap (``mean_logit_gap``); its file says which,
  with the limit.

The control puts the reference, in a lower precision, in the program's
place: at the served positions of the same sample it reads the float32
reference's gap of the token the lower precision puts first
(``control_gaps``); those gaps go through ``verdict`` as a run's do.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np
import torch

from portbench.measure import CallRecord
from portbench.reference.model import Forward
from portbench.reference.spec import Arch

_CHECK = 5      # the sample's stream key beside the seed


def sample(calls: Sequence[CallRecord], seed: int, min_tokens: int,
           max_calls: int) -> List[CallRecord]:
    if not calls:
        return []
    longest = max(calls, key=lambda c: len(c.prompt) + len(c.output))
    rng = np.random.default_rng([seed % 2 ** 64, _CHECK])
    out, served = [longest], len(longest.output)
    for i in rng.permutation(len(calls)):
        if served >= min_tokens or len(out) >= max_calls:
            break
        c = calls[int(i)]
        if c is not longest:
            out.append(c)
            served += len(c.output)
    return out


def _inputs(c: CallRecord, device):
    seq = np.concatenate([np.asarray(c.prompt, np.int64),
                          np.asarray(c.output[:-1], np.int64)])
    p = len(c.prompt)
    rows = torch.arange(p - 1, p - 1 + len(c.output), device=device)
    served = torch.as_tensor(np.asarray(c.output, np.int64), device=device)
    return torch.as_tensor(seq, device=device), rows, served


def served_gaps(weights: dict, arch: Arch, calls: Sequence[CallRecord],
                device) -> np.ndarray:
    """Each served token's gap below the reference's best logit."""
    ref = Forward(weights, arch)
    gaps = []
    for c in calls:
        seq, rows, served = _inputs(c, device)
        lg = ref.logits(seq, rows)
        gaps.append((lg.max(-1).values
                     - lg.gather(1, served[:, None])[:, 0]).cpu().numpy())
        del lg
    return np.concatenate(gaps) if gaps else np.zeros(0)


def control_gaps(weights: dict, arch: Arch, calls: Sequence[CallRecord],
                 device, precision: str) -> Dict[str, np.ndarray]:
    """At each served position of ``calls``, the reference's gap of the
    served token (``served``) and of the token that the reference
    computed in ``precision`` puts first (``control``)."""
    ref, low = Forward(weights, arch), Forward(weights, arch, precision)
    out = {"served": [], "control": []}
    for c in calls:
        seq, rows, served = _inputs(c, device)
        lg = ref.logits(seq, rows)
        pick = low.logits(seq, rows).argmax(-1)
        best = lg.max(-1).values
        out["served"].append((best - lg.gather(
            1, served[:, None])[:, 0]).cpu().numpy())
        out["control"].append((best - lg.gather(
            1, pick[:, None])[:, 0]).cpu().numpy())
        del lg, pick, best
    return {k: np.concatenate(v) if v else np.zeros(0)
            for k, v in out.items()}


@dataclasses.dataclass
class Verdict:
    correct: bool
    compared: Dict[str, Dict[str, float]]
    gaps: Dict[str, float] = dataclasses.field(default_factory=dict)


def accounting(calls: Sequence[CallRecord], failed_workflows: int,
               calls_never_back: int, workflows_open: int) -> dict:
    """``calls``: every call the cluster handed back."""
    seen = [c.req_id for c in calls]
    return {
        "short_or_long_answers": sum(
            1 for c in calls
            if len(c.output) != c.max_new_tokens or c.state != "finished"),
        "repeated_answers": len(seen) - len(set(seen)),
        "calls_never_back": calls_never_back,
        "failed_workflows": failed_workflows,
        "open_workflows": workflows_open,
    }


NO_FAULT = accounting([], 0, 0, 0)


GAP_NUMBERS = {
    # the widest gap of a served token below the reference's best
    "logit_gap": lambda g: float(g.max()),
    # the mean gap over the served tokens
    "mean_logit_gap": lambda g: float(g.mean()),
}


def gap_numbers(gaps: np.ndarray) -> Dict[str, float]:
    if not gaps.size:
        return {k: float("inf") for k in GAP_NUMBERS}
    return {k: f(gaps) for k, f in GAP_NUMBERS.items()}


def verdict(acct: dict, gaps: np.ndarray, limits: Dict[str, float],
            min_tokens: int) -> Verdict:
    """``limits`` names the gap numbers the configuration compares."""
    compared = {k: {"value": v, "limit": 0} for k, v in acct.items()}
    compared["tokens_checked"] = {"value": int(gaps.size),
                                  "limit": min_tokens}
    numbers = gap_numbers(gaps)
    ok = all(v == 0 for v in acct.values()) and gaps.size >= min_tokens
    for name, limit in limits.items():
        compared[name] = {"value": numbers[name], "limit": limit}
        ok = ok and numbers[name] <= limit
    return Verdict(ok, compared)
