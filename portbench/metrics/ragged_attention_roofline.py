"""The ragged prefill kernel (``kernels/csrc/ragged_attention.cu``)
against its roofline: for each launch in the traced slice the larger of
its chunks' operations at 989 TFLOP/s and their bytes at 3.35 TB/s
(``roofline.ragged_cost``, every layer), summed, over the kernel's
device time by name in the profiler's trace of the same slice."""
from portbench import profiling, roofline

UNIT = "%"
LAYER = "kernels"
MOVES = "workflow_e2e_p50_s"


def read(res):
    rec = res.recorder
    if rec.profile is None:
        return None
    t = profiling.kernel_seconds(rec.profile, "ragged_attention")
    lo, hi = rec.profile_mono
    bound = sum(roofline.bound_s(*roofline.ragged_cost(res.arch, it.chunks))
                for it in rec.iterations if lo <= it.t <= hi and it.chunks)
    if t <= 0 or bound <= 0:
        return None
    return 100.0 * res.arch.layers * bound / t
