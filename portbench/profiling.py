"""The device trace of a traced run, reduced.

``torch.profiler`` records CUDA activity over a slice of the measured
window.  From its raw events this module takes: the busy time (the union
of every device operation's interval), device time by kernel name, and
the idle gaps between operations, each gap attributed to what the host
was doing at its middle (the benchmark's own host spans, stamped with
``time.time_ns``, the profiler's clock).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# host span kinds, the first that covers a gap's middle names it
HOST_ORDER = ("engine_dispatch_iteration", "engine_sync", "engine_collect",
              "balancer_tick", "cluster_step")


def device_intervals(events) -> Tuple[np.ndarray, np.ndarray, List[str]]:
    """(start ns, end ns, name) of every device operation."""
    from torch.autograd import DeviceType
    starts, ends, names = [], [], []
    for e in events:
        if e.device_type() != DeviceType.CUDA:
            continue
        s = e.start_ns()
        starts.append(s)
        ends.append(s + e.duration_ns())
        names.append(e.name())
    return np.asarray(starts, np.int64), np.asarray(ends, np.int64), names


def merge(starts: np.ndarray, ends: np.ndarray):
    """The union of intervals, as sorted disjoint (start, end) arrays."""
    if not len(starts):
        return starts, ends
    o = np.argsort(starts, kind="stable")
    s, e = starts[o], ends[o]
    run_end = np.maximum.accumulate(e)
    new = np.ones(len(s), bool)
    new[1:] = s[1:] > run_end[:-1]
    idx = np.flatnonzero(new)
    last = np.append(idx[1:] - 1, len(s) - 1)
    return s[idx], run_end[last]


def _covered(points: np.ndarray, spans: Sequence[Tuple[int, int]]):
    if not spans:
        return np.zeros(len(points), bool)
    a = np.asarray(spans, np.int64)
    s, e = merge(a[:, 0], a[:, 1])
    i = np.searchsorted(s, points, side="right") - 1
    return (i >= 0) & (points < e[np.clip(i, 0, None)])


def reduce(events, t0_ns: int, t1_ns: int,
           host: Dict[str, List[Tuple[int, int]]]) -> Optional[dict]:
    """Busy seconds, kernel seconds by name and idle gaps by host activity
    over the traced slice ``[t0_ns, t1_ns]``; None with no device op."""
    starts, ends, names = device_intervals(events)
    if not len(starts):
        return None
    starts, ends = np.clip(starts, t0_ns, t1_ns), np.clip(ends, t0_ns, t1_ns)
    by_name: Dict[str, float] = {}
    for n, d in zip(names, (ends - starts).tolist()):
        by_name[n] = by_name.get(n, 0.0) + d * 1e-9
    s, e = merge(starts, ends)
    busy = float((e - s).sum()) * 1e-9
    gap_s = np.concatenate([[t0_ns], e])
    gap_e = np.concatenate([s, [t1_ns]])
    keep = gap_e > gap_s
    gap_s, gap_e = gap_s[keep], gap_e[keep]
    mid = (gap_s + gap_e) // 2
    length = (gap_e - gap_s) * 1e-9
    left = np.ones(len(mid), bool)
    idle: Dict[str, float] = {}
    for kind in HOST_ORDER:
        hit = left & _covered(mid, host.get(kind, []))
        if hit.any():
            idle[kind] = float(length[hit].sum())
        left &= ~hit
    if left.any():
        idle["outside_cluster_step"] = float(length[left].sum())
    return {"busy_s": busy, "window_s": (t1_ns - t0_ns) * 1e-9,
            "kernel_s": by_name, "idle_gaps_s": idle}


def breakdown(red: dict, top: int = 10) -> dict:
    ops = sorted(red["kernel_s"].items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(red["idle_gaps_s"].items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:96], v] for n, v in ops],
            "idle_gaps": [[n, v] for n, v in gaps]}


def kernel_seconds(red: dict, fragment: str) -> float:
    """Device seconds of the kernels whose name holds ``fragment``."""
    return sum(v for n, v in red["kernel_s"].items() if fragment in n)
