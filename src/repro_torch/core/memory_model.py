"""Per-request dynamic memory model (§6, Eq. 1–3).

KV usage of request *i* is a linear ramp in token units:

    f_i(t) = P_i + k * (t - t_start)   for t_start < t < t_end,  else 0

P_i = prompt KV tokens (known at dispatch), k = decode speed (tokens/s,
from hardware profiling), t_end = t_start + T_i with T_i the mode of the
agent's single-request latency distribution (Eq. 2).

Architecture adaptation (DESIGN.md §4): attention-free archs have slope 0
and a constant state footprint; hybrids scale the slope by the fraction
of attention layers.
"""
from __future__ import annotations

import dataclasses
from typing import List


@dataclasses.dataclass
class MemoryRamp:
    p_tokens: float          # prompt KV (token units)
    slope: float             # tokens/sec during decode
    t_start: float
    t_end: float

    def usage(self, t: float) -> float:
        if self.t_start < t < self.t_end:
            return self.p_tokens + self.slope * (t - self.t_start)
        return 0.0

    @property
    def peak(self) -> float:
        return self.p_tokens + self.slope * max(self.t_end - self.t_start, 0.0)

    def slot_usage(self, slot_starts, slot_len: float) -> List[float]:
        """Max usage within each slot (ramp is increasing -> slot end)."""
        out = []
        for s0 in slot_starts:
            s1 = s0 + slot_len
            if s1 <= self.t_start or s0 >= self.t_end:
                out.append(0.0)
            else:
                out.append(self.usage(min(s1, self.t_end) - 1e-9))
        return out


def make_ramp(prompt_len: int, expected_exec_time: float, decode_tok_per_s: float,
              t_start: float, kv_ratio: float = 1.0, state_tokens: float = 0.0,
              shared_prefix_tokens: int = 0) -> MemoryRamp:
    """kv_ratio: fraction of layers holding KV (1.0 dense, 4/32 jamba,
    0.0 rwkv); state_tokens: constant recurrent-state footprint expressed
    in KV-token-equivalents.

    ``shared_prefix_tokens``: prompt tokens expected to be served by the
    engine's shared-prefix KV cache (``serving/prefix_cache.py``).  Their
    pages are held once per instance, not once per request, so per-request
    ramps must not count them — otherwise the time-slot dispatcher
    double-counts the shared pages for every concurrent agent call and
    under-packs the instance."""
    eff_prompt = max(prompt_len - max(shared_prefix_tokens, 0), 1)
    return MemoryRamp(
        p_tokens=eff_prompt * kv_ratio + state_tokens,
        slope=decode_tok_per_s * kv_ratio,
        t_start=t_start,
        t_end=t_start + max(expected_exec_time, 1e-6),
    )
