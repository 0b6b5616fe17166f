"""Seeded multi-tenant arrival traces: bursty, diurnal, heavy-tailed.

The paper's excess-load experiments drive the cluster with production
arrival traces [41] whose defining features are (a) a diurnal baseline,
(b) superimposed short bursts whose intensity is heavy-tailed (most
bursts are mild, a few are brutal), and (c) several tenants (agent apps)
sharing the fleet with skewed popularity.  This module synthesizes such
traces deterministically from a seed, as an explicit event list
``[(t, app_idx)]`` — the SAME list replays through the discrete-event
simulator (``SimConfig(arrivals=...)``) and through the real cluster
(submit each workflow at its timestamp relative to the run clock), so
elastic-vs-fixed comparisons run the identical workload on both paths.

Generation is non-homogeneous Poisson via Lewis-Shedler thinning: the
intensity is

    rate(t) = base_rate * diurnal(t) * burst(t)

with ``diurnal`` a sinusoid (period scaled into the trace duration — a
"day" compressed to minutes, as in trace-replay papers) and ``burst`` a
piecewise-constant elevation: burst windows arrive as a Poisson process,
each lasting ``burst_duration`` and multiplying the rate by a
Pareto-distributed factor (heavy tail, truncated so thinning stays
exact).  Within-window inter-arrivals further jitter with a Gamma
renewal of coefficient-of-variation ``cv`` like the existing
:func:`repro_torch.sim.workload.arrival_times` sampler.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.sim.workload import AppSpec, make_app


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    """Knobs for one synthetic multi-tenant arrival trace."""
    seed: int = 0
    duration: float = 120.0
    base_rate: float = 4.0          # workflows/s at diurnal midpoint
    # diurnal: rate swings base_rate * (1 +- amplitude) over one period
    diurnal_amplitude: float = 0.5
    diurnal_period: float = 60.0
    # bursts: windows arrive at burst_rate/s, each burst_duration long,
    # multiplying intensity by 1 + Pareto(alpha) (truncated at max_mult)
    burst_rate: float = 0.05
    burst_duration: float = 5.0
    pareto_alpha: float = 1.5
    burst_max_mult: float = 8.0
    # within-process inter-arrival burstiness (Gamma renewal CV)
    cv: float = 1.6
    # tenants: (app_kind, group, weight) — weight is relative popularity
    tenants: Sequence[Tuple[str, str, float]] = (
        ("QA", "G+M", 3.0), ("RG", "TQ", 1.0), ("CG", "HE", 1.0))

    def __post_init__(self):
        assert self.duration > 0 and self.base_rate > 0
        assert 0.0 <= self.diurnal_amplitude < 1.0
        assert self.pareto_alpha > 1.0 and self.burst_max_mult >= 1.0
        assert self.tenants and all(w > 0 for _, _, w in self.tenants)


@dataclasses.dataclass
class Trace:
    """An explicit arrival list plus the tenant apps it indexes into."""
    events: List[Tuple[float, int]]   # (arrival time, app index), sorted
    apps: List[AppSpec]
    config: TraceConfig

    @property
    def n_workflows(self) -> int:
        return len(self.events)

    def rate_profile(self, bin_s: float = 1.0) -> np.ndarray:
        """Arrivals-per-second histogram (for plots and burst asserts)."""
        n = int(np.ceil(self.config.duration / bin_s))
        hist = np.zeros(n)
        for t, _ in self.events:
            hist[min(n - 1, int(t / bin_s))] += 1.0 / bin_s
        return hist

    def sim_config(self, serving=None, **overrides):
        """A :class:`~repro_torch.sim.simulator.SimConfig` replaying this
        trace — from a :class:`ServingConfig` when given (field-parity
        path), else from sim defaults."""
        from repro_torch.sim.simulator import SimConfig
        common = dict(arrivals=list(self.events),
                      duration=self.config.duration,
                      seed=self.config.seed)
        common.update(overrides)
        if serving is not None:
            return SimConfig.from_serving_config(serving, self.apps, **common)
        return SimConfig(apps=self.apps, **common)


def _burst_windows(rng: np.random.Generator,
                   cfg: TraceConfig) -> List[Tuple[float, float, float]]:
    """(start, end, multiplier) burst elevations over the trace."""
    n = rng.poisson(cfg.burst_rate * cfg.duration)
    starts = np.sort(rng.uniform(0.0, cfg.duration, n))
    mults = 1.0 + np.minimum(rng.pareto(cfg.pareto_alpha, n),
                             cfg.burst_max_mult - 1.0)
    return [(float(s), float(s + cfg.burst_duration), float(m))
            for s, m in zip(starts, mults)]


def _intensity(t: np.ndarray, cfg: TraceConfig,
               bursts: List[Tuple[float, float, float]]) -> np.ndarray:
    rate = cfg.base_rate * (
        1.0 + cfg.diurnal_amplitude
        * np.sin(2.0 * np.pi * t / cfg.diurnal_period))
    for s, e, m in bursts:
        rate = np.where((t >= s) & (t < e), rate * m, rate)
    return rate


def generate_trace(cfg: TraceConfig = TraceConfig()) -> Trace:
    """Deterministic trace synthesis (same seed => identical events).

    Thinning against the exact intensity ceiling keeps the process
    non-homogeneous Poisson; a final Gamma-CV jitter perturbs each
    arrival within a fraction of its local inter-arrival gap to mimic
    renewal burstiness without reordering across burst boundaries."""
    rng = np.random.default_rng(cfg.seed)
    bursts = _burst_windows(rng, cfg)
    lam_max = cfg.base_rate * (1.0 + cfg.diurnal_amplitude) \
        * max([m for _, _, m in bursts], default=1.0)
    # Lewis-Shedler: candidate homogeneous process at lam_max, thin to rate(t)
    n_cand = rng.poisson(lam_max * cfg.duration) + 8
    cand = np.sort(rng.uniform(0.0, cfg.duration, n_cand))
    keep = rng.uniform(0.0, 1.0, n_cand) * lam_max \
        <= _intensity(cand, cfg, bursts)
    times = cand[keep]
    if cfg.cv != 1.0 and len(times) > 1:
        # renewal-style jitter: move each arrival within its local gap by
        # a Gamma(1/cv^2) factor, clamped so ordering survives
        shape = 1.0 / (cfg.cv ** 2)
        gaps = np.diff(np.concatenate([[0.0], times]))
        jitter = rng.gamma(shape, 1.0 / shape, len(gaps))
        times = np.cumsum(gaps * np.clip(jitter, 0.25, 4.0))
        times = times[times < cfg.duration]
    weights = np.array([w for _, _, w in cfg.tenants])
    weights = weights / weights.sum()
    app_idx = rng.choice(len(cfg.tenants), size=len(times), p=weights)
    apps = [make_app(kind, group) for kind, group, _ in cfg.tenants]
    events = [(float(t), int(a)) for t, a in zip(times, app_idx)]
    return Trace(events=events, apps=apps, config=cfg)


def bursty_trace(seed: int = 0, duration: float = 60.0,
                 base_rate: float = 4.0,
                 burst_mult: float = 6.0,
                 burst_at: Optional[float] = None,
                 burst_duration: float = 8.0) -> Trace:
    """A trace with ONE guaranteed burst window — the committed
    benchmark workload (``benchmarks/autoscale_burst.py``) uses this so
    the burst is always present regardless of seed, while all arrival
    randomness stays seed-deterministic."""
    cfg = TraceConfig(seed=seed, duration=duration, base_rate=base_rate,
                      burst_rate=0.0, burst_duration=burst_duration,
                      burst_max_mult=burst_mult)
    rng = np.random.default_rng(cfg.seed)
    s = duration * 0.4 if burst_at is None else burst_at
    bursts = [(s, s + burst_duration, burst_mult)]
    lam_max = base_rate * (1.0 + cfg.diurnal_amplitude) * burst_mult
    n_cand = rng.poisson(lam_max * duration) + 8
    cand = np.sort(rng.uniform(0.0, duration, n_cand))
    keep = rng.uniform(0.0, 1.0, n_cand) * lam_max \
        <= _intensity(cand, cfg, bursts)
    times = cand[keep]
    weights = np.array([w for _, _, w in cfg.tenants])
    weights = weights / weights.sum()
    app_idx = rng.choice(len(cfg.tenants), size=len(times), p=weights)
    apps = [make_app(kind, group) for kind, group, _ in cfg.tenants]
    events = [(float(t), int(a)) for t, a in zip(times, app_idx)]
    return Trace(events=events, apps=apps, config=cfg)
