"""Zero-dependency metrics registry: counters, gauges, histograms.

One registry per instrumented object (a :class:`PagedModelRunner`, an
:class:`~repro_torch.serving.engine.LLMEngine`), merged upward by
``snapshot()`` calls — the cluster's snapshot prefixes each engine's so
the whole serving stack flattens into one dict the benchmarks and the
BENCH JSON pipeline consume directly.

The engine's ad-hoc perf counters
(``PagedModelRunner.n_dispatches``, jit recompile counts, pool-bytes
probes in ``benchmarks/iteration_fusion.py``) now live here; the old
attributes remain as thin property aliases so existing tests and CI
gates keep reading them unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Union


@dataclasses.dataclass
class Counter:
    """Monotonic-by-convention accumulator.  ``value`` is plain
    read/write so legacy ``obj.n_dispatches += 1`` aliases keep working
    through a property."""
    name: str
    value: float = 0.0

    def inc(self, n: float = 1.0):
        self.value += n


@dataclasses.dataclass
class Gauge:
    """Last-write-wins sample (queue depth, pool bytes, cache size)."""
    name: str
    value: float = 0.0

    def set(self, v: float):
        self.value = float(v)


class Histogram:
    """Running count/sum/min/max plus a bounded sample window for
    percentiles.  The window keeps the most recent ``window`` samples
    (overwrite-oldest) — adequate for serving-latency quantiles at the
    scales the benchmarks run, with strictly bounded memory."""

    __slots__ = ("name", "count", "total", "min", "max", "_win", "_n", "window")

    def __init__(self, name: str, window: int = 2048):
        self.name = name
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self.window = window
        self._win: List[float] = [0.0] * window
        self._n = 0

    def observe(self, v: float):
        v = float(v)
        self.count += 1
        self.total += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        self._win[self._n % self.window] = v
        self._n += 1

    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def percentile(self, p: float) -> float:
        n = min(self._n, self.window)
        if n == 0:
            return 0.0
        xs = sorted(self._win[:n])
        i = min(n - 1, max(0, int(round(p / 100.0 * (n - 1)))))
        return xs[i]

    def summary(self) -> Dict[str, float]:
        if self.count == 0:
            return {"count": 0.0}
        return {"count": float(self.count), "mean": self.mean(),
                "p50": self.percentile(50), "p95": self.percentile(95),
                "p99": self.percentile(99), "max": self.max}


Metric = Union[Counter, Gauge, Histogram]


class MetricsRegistry:
    """Name -> metric, create-on-first-use.  ``snapshot()`` flattens to a
    plain dict (histograms expand to ``name.count`` / ``name.mean`` /
    ``name.p50`` / ``name.p95`` / ``name.p99`` / ``name.max``) — the
    exact shape ``benchmarks/common.write_bench_json`` expects."""

    def __init__(self):
        self._metrics: Dict[str, Metric] = {}

    def _get(self, name: str, cls, **kw) -> Metric:
        m = self._metrics.get(name)
        if m is None:
            m = cls(name, **kw)
            self._metrics[name] = m
        assert isinstance(m, cls), \
            f"metric {name!r} already registered as {type(m).__name__}"
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, window: int = 2048) -> Histogram:
        return self._get(name, Histogram, window=window)

    # ------------------------------------------------------------ convenience
    def inc(self, name: str, n: float = 1.0):
        self.counter(name).inc(n)

    def set(self, name: str, v: float):
        self.gauge(name).set(v)

    def observe(self, name: str, v: float):
        self.histogram(name).observe(v)

    # ---------------------------------------------------------------- export
    def snapshot(self, prefix: str = "") -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, m in self._metrics.items():
            key = prefix + name
            if isinstance(m, Histogram):
                for k, v in m.summary().items():
                    out[f"{key}.{k}"] = v
            else:
                out[key] = m.value
        return out


def merge_snapshots(parts: Dict[str, Optional[Dict[str, float]]]) -> Dict[str, float]:
    """Merge labelled snapshots into one flat dict: ``{"engine0": {...}}``
    becomes ``{"engine0.metric": ...}``.  ``None`` parts are skipped."""
    out: Dict[str, float] = {}
    for label, snap in parts.items():
        if snap is None:
            continue
        for k, v in snap.items():
            out[f"{label}.{k}" if label else k] = v
    return out


def rollup_by_role(snapshot: Dict[str, float]) -> Dict[str, Dict[str, float]]:
    """Regroup a merged cluster snapshot by instance ROLE.

    Per-instance keys carry the cluster's :meth:`metrics_label` prefix —
    ``prefill0.n_admitted``, ``decode1.n_finished`` for role-typed
    instances, ``engine<i>.*`` (rolled up as ``general``) for flat ones.
    Returns ``{role: {metric: summed value}}``; additive metrics
    (counters, gauges, histogram ``.count``s) sum across a role's
    instances, which is what per-role attribution consumes.  Keys
    without an ``<alpha><digits>.`` instance prefix (cluster aggregates
    like ``queue_depth``) are skipped."""
    out: Dict[str, Dict[str, float]] = {}
    for key, v in snapshot.items():
        label, dot, metric = key.partition(".")
        if not dot or not label or not label[-1].isdigit():
            continue
        role = label.rstrip("0123456789")
        if not role.isalpha():
            continue
        if role == "engine":
            role = "general"
        bucket = out.setdefault(role, {})
        bucket[metric] = bucket.get(metric, 0.0) + v
    return out
