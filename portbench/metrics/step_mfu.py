"""The serving steps' share of the chip's bf16 peak: the operations the
window's computed tokens need (``roofline.step_flops``: 2 x the
parameters a token passes through, MoE counted at its top-k and shared
experts, attention at each token's context, the head on rows that yield
a token) over the window's seconds x 989 TFLOP/s."""
from portbench import roofline
from portbench.measure import inside

UNIT = "%"
LAYER = "model step"
MOVES = "output_tokens_per_s"


def read(res):
    n = ctx = rows = 0
    for it in res.recorder.iterations:
        if not inside(it.t, res.window):
            continue
        n += len(it.decode_ctx) + sum(e - s for s, e in it.chunks)
        ctx += sum(it.decode_ctx) + sum(roofline.chunk_contexts_sum(s, e)
                                        for s, e in it.chunks)
        rows += it.sampled
    if n == 0:
        return None
    flops = roofline.step_flops(res.arch, n, ctx, rows)
    span = res.window[1] - res.window[0]
    return 100.0 * flops / (span * roofline.PEAK_FLOPS)
