"""Host milliseconds of one fused step's launches (``_step``: the
copy-on-write, the embedding, every layer, the head and the argmax), from
the program's ``runner.launch`` spans: mean wall time over the spans that
start in the window."""
from portbench.measure import inside

UNIT = "ms"
LAYER = "model step"
MOVES = "tpot_p95_ms"


def read(res):
    walls = [e.wall_ns for e in res.events
             if e.kind == "span" and e.name == "runner.launch"
             and inside(e.ts, res.window)]
    return 1e-6 * sum(walls) / len(walls) if walls else None
