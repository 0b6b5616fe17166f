"""Share of the traced slice in which no operation ran on the card, from
the profiler's device events (their union is the busy time)."""
UNIT = "%"
LAYER = "device"
MOVES = "output_tokens_per_s"


def read(res):
    p = res.recorder.profile
    if p is None or p["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
