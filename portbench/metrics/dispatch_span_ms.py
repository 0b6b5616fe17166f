"""Wall milliseconds of one ``LLMEngine.dispatch_iteration`` (plan,
flatten, upload, every launch of the step), from the program's own
``engine.dispatch`` spans (``repro_torch/obs/trace.py``): mean over the
spans that start in the window.  The in-program twin of
``dispatch_host_ms``, which times the same calls from outside."""
from portbench.measure import inside

UNIT = "ms"
LAYER = "cluster stepping and engine dispatch"
MOVES = "tpot_p95_ms"


def read(res):
    walls = [e.wall_ns for e in res.events
             if e.kind == "span" and e.name == "engine.dispatch"
             and inside(e.ts, res.window)]
    return 1e-6 * sum(walls) / len(walls) if walls else None
