"""Queue time of an LLM call: its ``submit`` event to its first
``admit`` event (a batch slot and KV memory granted on an instance).
90th percentile over the calls admitted in the window, from the tracer's
events."""
from portbench.measure import inside, percentile

UNIT = "s"
LAYER = "control plane"
MOVES = "workflow_e2e_p90_s"


def read(res):
    submit, admit = {}, {}
    for e in res.events:
        if e.kind == "submit":
            submit[e.req_id] = e.ts
        elif e.kind == "admit" and e.req_id not in admit:
            admit[e.req_id] = e.ts
    waits = [t - submit[r] for r, t in admit.items()
             if r in submit and inside(t, res.window)]
    return percentile(waits, 90)
