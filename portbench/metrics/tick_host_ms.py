"""Host milliseconds of the load balancer's tick (order the queue by
priority, place with memory awareness), one per cluster step, from the
program's ``balancer.tick`` spans: mean wall time over the spans that
start in the window."""
from portbench.measure import inside

UNIT = "ms"
LAYER = "control plane"
MOVES = "output_tokens_per_s"


def read(res):
    walls = [e.wall_ns for e in res.events
             if e.kind == "span" and e.name == "balancer.tick"
             and inside(e.ts, res.window)]
    return 1e-6 * sum(walls) / len(walls) if walls else None
