"""Agent-level priority determination (§5.1).

Pairwise Wasserstein distances between the agents' *remaining execution
latency* distributions (plus the ideal "zero latency" anchor) are embedded
into a 1-D coordinate space with classical MDS.  The coordinate is
oriented so the anchor sits at the low end; agents closer to the anchor
have shorter remaining work and get higher priority (smaller score).
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np


ANCHOR = ("__anchor__", "__zero_latency__")


def classical_mds_1d(dist: np.ndarray) -> np.ndarray:
    """Classical (Torgerson) MDS to 1 dimension.

    dist: (n, n) symmetric distance matrix -> (n,) coordinates.
    Only the TOP eigenvector is needed, so beyond n=512 we use power
    iteration (O(n^2) per sweep) instead of a full O(n^3) eigh — this is
    what keeps the §7.7 large-agent-count overhead in the paper's 0.1–4.3 s
    envelope (full eigh measured 132 s at n=5000).
    """
    n = dist.shape[0]
    d2 = dist ** 2
    # double centering without the O(n^3) J @ D2 @ J matmuls
    rm = d2.mean(axis=1, keepdims=True)
    cm = d2.mean(axis=0, keepdims=True)
    b = -0.5 * (d2 - rm - cm + d2.mean())
    if n <= 512:
        w, v = np.linalg.eigh(b)
        i = int(np.argmax(w))
        return v[:, i] * np.sqrt(max(w[i], 0.0))
    rng = np.random.default_rng(0)
    x = rng.normal(size=n)
    lam = 0.0
    for _ in range(100):
        y = b @ x
        lam = float(np.linalg.norm(y))
        if lam < 1e-12:
            break
        y /= lam
        if np.linalg.norm(y - x) < 1e-9:
            x = y
            break
        x = y
    return x * np.sqrt(max(lam, 0.0))


def agent_priorities(samples: Dict[Tuple[str, str], Sequence[float]]) -> Dict[Tuple[str, str], float]:
    """Map (app, agent) -> priority score; LOWER = scheduled first.

    ``samples`` holds remaining-latency samples per (app, agent).  The
    zero-latency anchor orients the MDS axis (§5.1).
    """
    keys = [k for k, v in samples.items() if len(v) > 0]
    if not keys:
        return {}
    if len(keys) == 1:
        return {keys[0]: 0.0}
    # W1 between empirical dists = mean |quantile difference|: precompute
    # each agent's quantile vector once, then the full pairwise matrix is
    # one broadcasted subtraction — O(n^2 * 256) vectorized (the naive
    # per-pair np.quantile version took 37 s at n=500; this takes ~0.1 s,
    # within the paper's §7.7 envelope).
    grid = 64 if len(keys) > 512 else 256   # coarser grid at scale (~1% W1 err)
    q = np.linspace(0.0, 1.0, grid)
    quants = np.stack(
        [np.quantile(np.asarray(samples[k], np.float64), q) for k in keys]
        + [np.zeros_like(q)]).astype(np.float32)                # anchor
    n = quants.shape[0]
    dist = np.empty((n, n), np.float32)
    blk = max(1, int(256e6 // (n * grid * 4)))  # ~256 MB working blocks
    for i in range(0, n, blk):
        dist[i:i + blk] = np.mean(
            np.abs(quants[i:i + blk, None, :] - quants[None, :, :]), axis=2)
    coord = classical_mds_1d(dist.astype(np.float64))
    # orient: anchor at the minimum end
    anchor_c = coord[-1]
    if anchor_c > np.median(coord):
        coord = -coord
        anchor_c = -anchor_c
    return {k: float(coord[i] - anchor_c) for i, k in enumerate(keys)}


class PriorityTable:
    """Incrementally refreshed agent priorities with background-style updates.

    Real deployment recomputes on a fixed interval / asynchronously (§7.7);
    here `maybe_refresh` recomputes when `interval` new completions landed.
    """

    def __init__(self, interval: int = 64):
        self.interval = interval
        self._since = 0
        self.scores: Dict[Tuple[str, str], float] = {}
        self.n_refreshes = 0

    def tick_completion(self):
        self._since += 1

    def maybe_refresh(self, samples: Dict[Tuple[str, str], Sequence[float]], force=False):
        if not force and self._since < self.interval and self.scores:
            return False
        self.scores = agent_priorities(samples)
        self._since = 0
        self.n_refreshes += 1
        return True

    def score(self, app: str, agent: str, default: float = float("inf")) -> float:
        return self.scores.get((app, agent), default)
