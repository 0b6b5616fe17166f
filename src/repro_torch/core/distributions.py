"""Latency distribution analysis (§4.3).

Kairos maintains, per agent, (1) the single-request execution latency
distribution — convergence detected with the Wasserstein distance each
time the sample count doubles — and (2) the remaining end-to-end latency
distribution derived from reconstructed workflows.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np


def wasserstein_1d(a, b) -> float:
    """W1 distance between two 1-D empirical distributions.

    Equals the integral of |F_a^{-1}(q) - F_b^{-1}(q)| dq, evaluated on a
    common quantile grid (no scipy dependency).
    """
    a = np.sort(np.asarray(a, np.float64))
    b = np.sort(np.asarray(b, np.float64))
    if len(a) == 0 or len(b) == 0:
        return float("inf")
    q = np.linspace(0.0, 1.0, 256)
    qa = np.quantile(a, q)
    qb = np.quantile(b, q)
    return float(np.mean(np.abs(qa - qb)))


@dataclasses.dataclass
class EmpiricalDistribution:
    samples: List[float] = dataclasses.field(default_factory=list)

    def add(self, x: float):
        self.samples.append(float(x))

    def __len__(self):
        return len(self.samples)

    def mean(self) -> float:
        return float(np.mean(self.samples)) if self.samples else 0.0

    def percentile(self, p: float) -> float:
        return float(np.percentile(self.samples, p)) if self.samples else 0.0

    def mode(self) -> float:
        """Highest-probability-density point (§6: expected execution time).

        Histogram-based density estimate with Freedman–Diaconis-ish bins.
        """
        if not self.samples:
            return 0.0
        xs = np.asarray(self.samples, np.float64)
        if len(xs) < 8 or np.ptp(xs) == 0:
            return float(np.median(xs))
        nbins = max(8, min(64, int(np.sqrt(len(xs)))))
        hist, edges = np.histogram(xs, bins=nbins)
        i = int(np.argmax(hist))
        return float(0.5 * (edges[i] + edges[i + 1]))


class ConvergenceTracker:
    """Exponential doubling + Wasserstein convergence test (§4.3)."""

    def __init__(self, threshold: float = 0.15, min_samples: int = 8):
        self.threshold = threshold
        self.min_samples = min_samples
        self._snapshot: Optional[np.ndarray] = None
        self._next_check = min_samples
        self.converged = False
        self.last_distance = float("inf")

    def observe(self, samples: List[float]):
        n = len(samples)
        if n < self._next_check:
            return
        cur = np.asarray(samples, np.float64)
        if self._snapshot is not None:
            d = wasserstein_1d(cur, self._snapshot)
            scale = max(float(np.mean(cur)), 1e-9)
            self.last_distance = d / scale          # relative W1
            self.converged = self.last_distance < self.threshold
        self._snapshot = cur
        self._next_check = n * 2                    # doubling strategy


class DistributionProfiler:
    """Per-agent single-request execution latency + output-length profiles."""

    def __init__(self, convergence_threshold: float = 0.15):
        self.latency: Dict[str, EmpiricalDistribution] = {}
        self.output_len: Dict[str, EmpiricalDistribution] = {}
        self._trackers: Dict[str, ConvergenceTracker] = {}
        self._threshold = convergence_threshold

    def record(self, agent: str, latency: float, output_len: int):
        self.latency.setdefault(agent, EmpiricalDistribution()).add(latency)
        self.output_len.setdefault(agent, EmpiricalDistribution()).add(output_len)
        tr = self._trackers.setdefault(agent, ConvergenceTracker(self._threshold))
        tr.observe(self.latency[agent].samples)

    def converged(self, agent: str) -> bool:
        tr = self._trackers.get(agent)
        return bool(tr and tr.converged)

    def expected_exec_time(self, agent: str, default: float = 1.0) -> float:
        d = self.latency.get(agent)
        return d.mode() if d and len(d) else default

    def expected_output_len(self, agent: str, default: int = 128) -> int:
        d = self.output_len.get(agent)
        return int(d.mode()) if d and len(d) else default

    def agents(self) -> List[str]:
        return list(self.latency)
