"""Share of the dispatch threads' ``engine.dispatch`` spans in which the
thread was off the CPU: the sum over the spans that start in the window
of wall time less the thread's CPU time (``time.thread_time_ns``), over
the sum of wall time.  Off the CPU is time the thread was blocked (on
the interpreter lock, a sleep or a device wait) or runnable but not
scheduled.  Contention that spins (a busy wait on a lock in the CUDA
launch path, atomic reference counts) is CPU time, and this share does
not see it."""
from portbench.measure import inside

UNIT = "%"
LAYER = "cluster stepping and engine dispatch"
MOVES = "tpot_p95_ms"


def read(res):
    spans = [e for e in res.events
             if e.kind == "span" and e.name == "engine.dispatch"
             and inside(e.ts, res.window)]
    wall = sum(e.wall_ns for e in spans)
    if wall <= 0:
        return None
    return 100.0 * (wall - sum(e.cpu_ns for e in spans)) / wall
