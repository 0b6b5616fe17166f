"""The window's arithmetic on a synthetic timeline: a stall inside the
window moves the tail of workflow latency and the token rate."""
import numpy as np

from portbench.measure import (
    CallRecord,
    WorkflowRecord,
    end_to_end,
    percentile,
)

WINDOW = (100.0, 160.0)


def timeline(stall_at=None, stall_s=0.0):
    """A closed loop of 8 sessions; each workflow takes 2 s and makes one
    call of 20 tokens at 0.1 s a token.  A stall from ``stall_at`` for
    ``stall_s`` makes every workflow that runs into it three times as
    slow."""
    wfs, calls, tokens = [], [], {}
    for s in range(8):
        t = 90.0 + 0.25 * s
        while t < 170.0:
            end = t + 2.0
            if stall_at is not None and stall_at - 2.0 < t < stall_at + stall_s:
                end = t + 6.0
            first = t + 0.1
            wfs.append(WorkflowRecord(s, f"{s}-{t}", t, end))
            calls.append(CallRecord(len(calls), f"{s}-{t}", "A",
                                    np.zeros(4, np.int32), [0] * 20, 20,
                                    t, first, end, "finished"))
            t = end
    return wfs, calls


def counted(calls, t):
    """Tokens handed out by time ``t`` (spread evenly over each call)."""
    n = 0.0
    for c in calls:
        if t >= c.t_finish:
            n += 20
        elif t > c.t_first:
            n += 20 * (t - c.t_first) / (c.t_finish - c.t_first)
    return n


def metrics(wfs, calls):
    return end_to_end(wfs, calls, WINDOW, counted(calls, WINDOW[0]),
                      counted(calls, WINDOW[1]))


def test_steady_timeline():
    m = metrics(*timeline())
    assert abs(m["workflow_e2e_p50_s"] - 2.0) < 1e-9
    assert abs(m["workflow_e2e_p90_s"] - 2.0) < 1e-9
    assert abs(m["output_tokens_per_s"] - 8 * 20 / 2.0) < 2.0
    assert abs(m["tpot_p95_ms"] - 1.9 / 19 * 1e3) < 1e-6
    assert 8 * 30 - 1 <= m["workflows"] <= 8 * 30 + 1


def test_stall_moves_tail_and_rate():
    calm = metrics(*timeline())
    hit = metrics(*timeline(stall_at=125.0, stall_s=15.0))
    assert hit["workflow_e2e_p90_s"] > calm["workflow_e2e_p90_s"] + 1.0
    assert hit["output_tokens_per_s"] < 0.95 * calm["output_tokens_per_s"]
    assert hit["tpot_p95_ms"] > calm["tpot_p95_ms"]


def test_stall_outside_window_changes_nothing():
    calm = metrics(*timeline())
    late = metrics(*timeline(stall_at=170.0, stall_s=15.0))
    for k in ("workflow_e2e_p50_s", "workflow_e2e_p90_s", "tpot_p95_ms"):
        assert late[k] == calm[k]


def test_percentile_uses_every_sample():
    xs = list(range(1, 10001))
    assert percentile(xs, 90) == np.percentile(xs, 90)
    assert percentile([], 50) is None
