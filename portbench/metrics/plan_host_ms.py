"""Host milliseconds of one batch-scheduler ``plan`` (admission, prefix
matching, chunk and decode composition), from the program's
``sched.plan`` spans: mean wall time over the spans that start in the
window."""
from portbench.measure import inside

UNIT = "ms"
LAYER = "control plane"
MOVES = "tpot_p95_ms"


def read(res):
    walls = [e.wall_ns for e in res.events
             if e.kind == "span" and e.name == "sched.plan"
             and inside(e.ts, res.window)]
    return 1e-6 * sum(walls) / len(walls) if walls else None
