"""Iteration-level LLM engine cost model for the discrete-event simulator.

Calibrated to an 8B-class dense decoder.  The paper profiles Llama3-8B on
an A40; our target hardware is a v5e-class accelerator (DESIGN.md §3) —
the *relative* agent behaviour (Figs 3–6) is hardware-independent, and
only these constants set the absolute scale.

One continuous-batching iteration with `n_decode` decoding sequences,
`prefill_tokens` newly computed prompt tokens, `cached_tokens` resident
tokens that prefill work attends over without recomputing (shared-prefix
cache hits and, under chunked prefill, the already-prefilled context of
later chunks), and `n_prefill_seqs` prompt segments in the batch costs

    t = t_base + beta * n_decode + gamma * prefill_tokens
             + gamma_cached * cached_tokens
             + beta_prefill * n_prefill_seqs
             + hbm_bytes / hbm_bandwidth                       [seconds]

which reproduces the paper's two key observations: decode dominates
(>96.6% of latency for typical output lengths) and per-request decode
speed is roughly constant (Eq. 1's slope `k`).  An attended-but-resident
token costs only the page-table plumbing and the extra attention context
— roughly 5% of recomputing it (`gamma_cached`) — which is exactly the
re-read overhead chunked prefill trades for not head-of-line-blocking the
decode batch.

Per-segment overhead depends on the execution model.  The legacy
per-chunk engine path issues one jitted dispatch per prefill chunk plus a
blocking argmax sync, so mixing K prompt chunks into an iteration costs
K+1 dispatches: `beta_prefill` prices that per-segment launch + sync +
pipeline bubble.  The fused single-dispatch path
(`LLMEngine(fused_iteration=True)`, the default) executes the whole
ragged batch in ONE dispatch — the per-iteration fixed overhead `t_base`
is paid once and amortized across every segment, and only a small ragged
mask / metadata cost `beta_seg_fused` remains per segment
(``iteration_time(..., fused=True)``).

Two memory-system effects of the zero-copy engine hot path (PR 5) are
priced explicitly:

* **Pool-copy traffic** — a jitted step without buffer donation
  materializes a second full-size KV-pool buffer per dispatch (a
  read+write of `pool_bytes` through HBM at `hbm_gbps`); donated
  in-place pools price those bytes at 0.
* **Segment-bounded attention** — the native ragged kernel gathers each
  page of a chunk's (bounded) context exactly once per chunk, while the
  flatten-and-repeat lowering re-gathers the batch-padded table width
  once per query *token* (S·L decode-style rows), so its extra traffic
  scales with chunk length × padded context.

Both are genuine HBM traffic, so both flow through one term: the
simulator sums them into ``hbm_bytes`` (copies count read+write, gathers
read-only) and ``iteration_time`` prices it at ``hbm_gbps``.  With the
default knobs (``donate_pool=True``, ``ragged_native=True``) the term is
0 and the trajectory is unchanged.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class CostModel:
    name: str = "llama3-8b"
    t_base: float = 0.008          # fixed per-iteration overhead (s)
    beta: float = 0.0012           # per decoding sequence (s)
    gamma: float = 0.00015         # per prefill token (s)
    gamma_cached: float = 0.0000075  # per attended resident token (s)
    beta_prefill: float = 0.0004   # per prefill segment, per-chunk path:
    #                                extra dispatch + blocking argmax sync (s)
    beta_seg_fused: float = 0.00008  # per segment, fused single-dispatch
    #                                path: ragged mask / metadata only (s)
    kv_bytes_per_token: int = 131072  # fp16 KV per token (8B-class:
    #                                32 layers x 2 x 8 kv heads x 128 hd x 2B)
    hbm_gbps: float = 800.0        # device memory bandwidth (GB/s) pricing
    #                                non-donated pool-copy traffic
    # --- tensor parallelism (sharded instances) ---------------------------
    # The sharded engine's only per-layer collectives are the two megatron
    # all-reduces, each moving one activation row (d_model x dtype bytes)
    # per token per layer over the interconnect.  A ring all-reduce over
    # tp shards moves 2*(tp-1)/tp of the payload per link.
    num_layers: int = 32
    allreduce_bytes_per_token_layer: int = 16384  # 2 psums x d_model=4096 x 2B
    ici_gbps: float = 100.0        # per-link interconnect bandwidth (GB/s)

    def iteration_time(self, n_decode: int, prefill_tokens: int,
                       cached_tokens: int = 0,
                       n_prefill_seqs: int = 0,
                       fused: bool = False,
                       hbm_bytes: int = 0,
                       tp_degree: int = 1) -> float:
        """``tp_degree`` > 1 models a megatron-sharded instance: the
        compute terms divide across shards (each holds 1/tp of heads and
        d_ff) while ``t_base`` — dispatch/launch overhead — does not,
        and a per-token-per-layer ring all-reduce term is added.  At the
        default ``tp_degree=1`` the collective term is exactly 0 and
        every compute term divides by 1, so all pre-sharding trajectories
        and committed BENCH baselines are numerically unchanged."""
        seg = (self.beta_seg_fused if fused else self.beta_prefill) \
            * n_prefill_seqs
        tp = max(1, tp_degree)
        coll = 0.0
        if tp > 1:
            tokens = n_decode + prefill_tokens
            coll = (tokens * self.num_layers
                    * self.allreduce_bytes_per_token_layer
                    * 2 * (tp - 1) / tp) / (self.ici_gbps * 1e9)
        return (self.t_base
                + (self.beta * n_decode
                   + self.gamma * prefill_tokens
                   + self.gamma_cached * cached_tokens
                   + seg) / tp
                + coll + hbm_bytes / (self.hbm_gbps * 1e9))

    def pool_bytes(self, kv_capacity_tokens: int) -> int:
        """Resident KV-pool size of an instance with the given capacity —
        a non-donated dispatch moves 2x this (read + write) just to
        thread the pool through."""
        return kv_capacity_tokens * self.kv_bytes_per_token

    def decode_tok_per_s(self, typical_batch: int = 8) -> float:
        """Per-request decode speed at a typical batch (Eq. 1 `k`)."""
        return 1.0 / self.iteration_time(typical_batch, 0)

    def transfer_time(self, n_tokens: int) -> float:
        """Prefill→decode handoff wire time for a request with
        ``n_tokens`` resident KV: a gathered pool-to-pool block copy
        (intra-host disaggregation), so the bytes move at HBM rate —
        read on the source + write on the target."""
        return 2 * n_tokens * self.kv_bytes_per_token / (self.hbm_gbps * 1e9)


LLAMA3_8B = CostModel("llama3-8b")
# 13B-class: ~1.7x per-token cost, same structure (§7.5 scalability study);
# llama2-13b is MHA, so its KV rows are much fatter than the 8B's GQA
# (40 layers x 2 x 40 heads x 128 hd x 2B)
LLAMA2_13B = CostModel("llama2-13b", t_base=0.013, beta=0.0021, gamma=0.00026,
                       gamma_cached=0.000013, beta_prefill=0.0007,
                       beta_seg_fused=0.00014, kv_bytes_per_token=1638400,
                       hbm_gbps=800.0, num_layers=40,
                       allreduce_bytes_per_token_layer=20480)

COST_MODELS = {m.name: m for m in (LLAMA3_8B, LLAMA2_13B)}
