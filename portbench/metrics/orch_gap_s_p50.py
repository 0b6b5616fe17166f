"""Orchestration gap: from one LLM call's ``finish`` event to the next
call's ``submit`` event in the same workflow (the router's answer to the
expert's call; one agent turn to the next), less the tool latency the
script drew between them.  Median over the window's gaps, from the
tracer's events."""
from collections import defaultdict

from portbench.measure import inside, percentile

UNIT = "s"
LAYER = "agents"
MOVES = "workflow_e2e_p50_s"


def read(res):
    submits, finish = defaultdict(list), {}
    for e in res.events:
        if e.kind == "submit" and e.msg_id:
            submits[e.msg_id].append((e.ts, e.req_id))
        elif e.kind == "finish":
            finish[e.req_id] = e.ts
    gaps = []
    for msg, subs in submits.items():
        subs.sort()
        for k in range(1, len(subs)):
            t, prev = subs[k][0], subs[k - 1][1]
            if (prev in finish and (msg, k) in res.delays
                    and inside(t, res.window)):
                gaps.append(t - finish[prev] - res.delays[(msg, k)])
    return percentile(gaps, 50)
