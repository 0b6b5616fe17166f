"""The paged decode kernel (``kernels/csrc/paged_attention.cu``) against
its roofline: the least time the bytes of the traced slice's decode rows
need at 3.35 TB/s (each row's K/V context read once, its query and
output; ``roofline.paged_bytes``, every layer), over the kernel's device
time by name in the profiler's trace of the same slice."""
from portbench import profiling, roofline

UNIT = "%"
LAYER = "kernels"
MOVES = "tpot_p95_ms"


def read(res):
    rec = res.recorder
    if rec.profile is None:
        return None
    t = profiling.kernel_seconds(rec.profile, "paged_attention")
    lo, hi = rec.profile_mono
    by = sum(roofline.paged_bytes(res.arch, it.decode_ctx)
             for it in rec.iterations if lo <= it.t <= hi and it.decode_ctx)
    if t <= 0 or by <= 0:
        return None
    bound = res.arch.layers * by / roofline.PEAK_BYTES_PER_S
    return 100.0 * bound / t
