"""Host milliseconds of one ``LLMEngine.dispatch_iteration`` (plan,
flatten, upload, every launch of the step), mean over the calls that
start in the window; timed around the call by the benchmark."""
UNIT = "ms"
LAYER = "cluster stepping and engine dispatch"
MOVES = "tpot_p95_ms"


def read(res):
    lo, hi = res.window
    spans = [t1 - t0 for t0, t1 in res.recorder.host_mono if lo <= t0 <= hi]
    return 1e3 * sum(spans) / len(spans) if spans else None
