#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Drives the port (``src/repro_torch``) through its main path, the fused
serving iteration, and holds each hand-written CUDA kernel against its
plain PyTorch version.  Each phase prints one JSON line; a phase that
fails prints its error and the script exits non-zero.

1. build     compile the kernels from ``src/repro_torch/kernels/csrc`` with
             nvcc for sm_90a; print the card's name and power limit.
2. kernels   each kernel against its plain version on the card: the sweeps
             of tests/test_kernels.py, a head dim of 112, the full-width
             qwen3-1.7b shapes, the served families' head shapes (KV 16
             G 1 hd 128, KV 32 G 1 hd 80, KV 8 G 3 hd 128) and the
             tensor_parallel phase's local ones (KV 4 and 2, G 2, hd 128),
             each also timed at full width, in float32 (tolerance 2e-5) and bfloat16
             (2e-2); contexts at, one past and short of the decode kernel's
             split boundaries; prefill chunks whose length is no multiple of
             the row tile and whose offsets are no multiple of the key tile;
             poisoned pages past each context or page bound; cl = 1 and
             cl = 0.  Times each kernel, its plain version and SDPA on a
             dense-gathered copy of the same inputs at the full-width
             shapes, each as CUDA-graph replays of back-to-back calls (the
             device's time, without the host's launch gaps) and as eager
             calls.
3. drain     qwen3-1.7b at full width (28 layers, bf16, seeded random
             weights) through ``LLMEngine`` with the prefix cache on and
             512-token prefill chunks: 16 requests from 4 agents.  The
             kernels' launch counters are zeroed just before the drain and
             read just after.  A second, profiled drain of the same traffic
             gives the device's busy and idle shares.
4. identity  the same traffic at full width and 4 layers in float32, on
             the CUDA kernels and on the plain versions: token streams must
             agree wherever the plain run's top-2 logit margin exceeds 1e-4,
             and each request's first token must be the argmax of
             ``LanguageModel.prefill`` on its prompt.
5. workflow  the Kairos multi-agent path: the quickstart's QA application
             (Router -> MathAgent | HumanitiesAgent, system prompts of 256
             and 1024 tokens, questions of 64-512 tokens, 4 and 64 new
             tokens) through ``repro_torch.agents.Workflow`` on a
             2-instance ``ServingCluster`` of full-width bf16 qwen3-1.7b
             (Kairos priorities, memory-aware time-slot dispatch, prefix
             cache, 512-token chunks): 32 tasks submitted at once.  The
             launch counters are zeroed just before and read just after.
             Reports workflow end-to-end latency, per-agent TTFT and TPOT,
             per-instance requests and iterations, the learned priority
             table, the slowest workflow's critical path and the host
             seconds of each part of the cluster step.  The same traffic
             again through the serial loop (``pipelined=False``), and once
             more pipelined under the profiler (the card's busy and idle
             shares).  Then 8 tasks
             at 4 layers in float32, every LLM call replayed alone through
             one engine on the plain versions: streams must agree wherever
             the plain run's top-2 margin exceeds 1e-4.
6. elastic   the elastic, disaggregated and shedding cluster at full width
             (bf16; the launch counters are zeroed before its first run and
             read after its last): the legacy per-chunk engine
             (``fused_iteration=False``) drains the drain phase's requests;
             an out-of-place pool (``donate_pool=False``, 512 blocks) moves
             at every step and gives the in-place run's tokens bit for bit;
             a 2-instance cluster retires instance 1 mid-decode through live
             migration (``scale_down``), one gathered ``write_blocks`` per
             target, the moved blocks read back bit-equal; a prefill and a
             decode instance hand every request over; an autoscaler grows
             a 1-instance cluster under a burst and shrinks it through
             migration; a tight ``slo_e2e_s`` sheds part of a 32-request
             burst and completes the rest; the tracer exports to a Chrome
             trace and reads back loss-free.  The migration pair runs once
             more on the plain versions of both kernels (``backend="ref"``),
             reporting how many bf16 streams diverge there.  Then, at 4
             layers in float32,
             the legacy, migrated and disaggregated streams against the
             fused, unmigrated and colocated ones under the margin rule.

7. moe       this slice's path: qwen2-moe-a2.7b at its published widths and
             full depth (24 layers, 60 experts top-4 plus the shared FFN,
             bf16, 14,315,587,584 seeded parameters) through one
             ``LLMEngine`` (4096 blocks, 16 sequences, prefix cache,
             512-token chunks) on the drain phase's 16 requests, fused and
             then legacy; each path's launch counters are zeroed just
             before and read just after.  A replay of each counts the
             expert assignments of real rows that capacity drops, a
             profiled fused replay gives the device's busy time and the
             MoE FFN's share of it.  Then, at 4 layers in float32, the CUDA
             kernels against the plain versions under the margin rule,
             extended for MoE: a diverging stream is excused also where
             the plain run routed some token of that sequence with a
             top-k gap below 1e-5.
8. families  every other arch of the registry at its published widths:
             llama3.2-3b (G = 3) and stablelm-3b (hd 80) at full depth and
             chameleon-34b at 4 layers drain 8 requests fused and legacy in
             bf16, with a float32 identity check at 2 layers; gemma3-27b
             (6 layers: 5 local, 1 global; a 1536-token prompt), rwkv6-3b
             (2 layers), jamba-v0.1-52b (one 8-layer block) and
             seamless-m4t-large-v2 (full depth) run prefill and decode_step
             at the model level, the decode logits held to a prefill one
             token longer in bf16 (2e-2) and in float32 at 2 layers (1e-4).
             kimi-k2-1t-a32b is not run on the card (one MoE layer alone
             holds 16.9 B parameters); the CPU tests cover it.
9. train     the training path (model-level causal attention: neither
             kernel may launch): full-width qwen3-1.7b in bf16 (1,720,574,976
             seeded parameters) on ``PackedStream`` batches of 4 x 1024
             tokens through ``make_train_step``, 20 Adam steps, then 10
             Adafactor steps from fresh weights; the loss of each must
             fall.  Each reports its losses, median step seconds split
             into forward, backward and update (CUDA events), tokens/s,
             model FLOPs over the bf16 peak (``mfu``), peak GB and one
             profiled step; Adam's run also times forward + backward with
             the layer stacks indexed per layer against unbound once.
             qwen2-moe-a2.7b at its published widths and 4 of 24 layers
             trains 5 Adam steps at 2 x 1024.  Every reduced arch, in
             float32: loss and every gradient leaf on the card against the
             CPU, then one Adam and one Adafactor update from the same
             params, gradients and state, all within 1e-4 of each leaf's
             largest magnitude (rwkv6's gradients 1e-3: see
             TRAIN_TOL_BY_ARCH); one ``train_step`` on each device's own
             gradients is reported beside them.
10. dryrun   the multi-pod dry-run (``repro_torch.launch.dryrun``: DTensor
             over a fake process group, fake tensors, nothing allocated;
             no kernel runs).  On the host, in two subprocesses started
             first (one a mesh): qwen3-1.7b train_4k and decode_32k on the
             16x16 and 2x16x16 meshes, each record ``ok``.  Meanwhile, full-width
             qwen3-1.7b (bf16, seeded weights) on a one-rank mesh (NCCL,
             one card): the dry-run of one Adam step at 4 x 1024 and of one
             decode_step at batch 16 against a 4096-token cache (7.5 GB of
             KV) on a fake one-rank mesh, then the same steps for real.
             The dry-run's ``argument_bytes`` must equal the storage the
             card holds for the state, cache and tokens to the byte, and its
             ``peak_bytes`` may lie at most 10 % under
             ``torch.cuda.max_memory_allocated()`` over the real step;
             no collective is dispatched on one rank.
11. tensor_parallel
             tensor-parallel serving (``repro_torch.serving.
             tensor_parallel``): 2, then 4 processes of this script on the
             one card in a gloo group (NCCL refuses two ranks on one
             device; gloo's all-reduces of CUDA tensors go through host
             memory), one slice of every rank.  Each rank shards
             full-width qwen3-1.7b (bf16, the drain phase's weights; KV
             heads 4 or 2 a rank, both kernels at those shapes) and rank 0
             drains the drain phase's 16 requests through ``LLMEngine``
             while the others serve; every rank's launch counters are
             zeroed just before and read just after.  Reports iterations,
             TPOT, the all-reduces' share of the wall time (CUDA events
             around each), per-rank peak memory and how many bf16 streams
             left the drain phase's; every shard's pool address must stay
             put.  Then float32 at 4 layers: the streams held to the
             identity phase's CUDA run under its margin rule.
             qwen2-moe-a2.7b at tp 2 must be refused.  A process that
             fails or outlives its deadline fails the phase.
12. overload excessive load and faults at full width (bf16; the launch
             counters are zeroed before its first drain and read after its
             last bf16 run).  A host replay of the scheduler (no model)
             picks the pool: the smallest power of two of at least twice
             the largest request's blocks on which the drain's 16 prompts,
             asking 192 new tokens, preempt at least 4 times.  On it the
             drain must preempt and evict exactly as replayed, keep its
             pool in place and launch both kernels; a 4096-block drain of
             the same traffic is its baseline.  Collect deferred, the same
             drain without EOS, with an eos_token no stream emits (the
             cost of collect's per-iteration sync) and with one that stops
             at least 4 streams early: each stream must stop where its run
             sampled that token.  A 3-instance cluster (Kairos policy,
             1024-block pools, pipelined) drains 24 shared-prefix requests
             fault-free, under the crash storm of
             benchmarks/chaos_drain.py and under a mixed plan (2 crashes,
             a straggle, an oom): no request failed, lost or duplicated,
             every fault fired, each straggle and nothing else fenced by
             the step deadline, and each dead pool unreferenced and off the
             card once the step that found the crash returns (cycle
             collector off).  On the fault-free cluster mid-drain, a
             migrate_many under a planned transfer fault must roll back
             (target blocks as before, source blocks bit-equal, streams
             unchanged).  The workflow phase's QA burst on 256-block pools
             under an oom storm on both instances, with the dispatcher's
             OOM feedback and without.  Then float32 at 4 layers: the tight
             drain on the CUDA kernels against the 4096-block drain on the
             plain versions, an EOS drain against the run without, and the
             mixed plan against the fault-free cluster (serial loop), each
             under the margin rule; the preemptions, evictions, crashes
             and replays traced are exported to a Chrome trace.

Then the per-kernel summary line, and last
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without CUDA, or without the rest of the repository beside it, the script
exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib
import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time
import traceback
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# published peaks of one H100 SXM (dense): HBM bytes/s, and operations/s by
# the type the kernels' inputs have
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}

TOL = {"float32": 2e-5, "bfloat16": 2e-2}     # as tests/test_kernels.py
MARGIN = 1e-4                                 # argmax ties below this
ROUTE_GAP = 1e-5                              # MoE routing ties below this

# tests/test_kernels.py, copied as literals
SHAPES = [
    # b, kv, g, hd, bs, nb_per_seq, n_pool
    (2, 2, 4, 64, 8, 3, 16),
    (1, 1, 8, 128, 16, 2, 8),
    (3, 4, 2, 64, 4, 5, 64),
    (2, 8, 1, 32, 8, 4, 64),
]
RAGGED_SWEEP = [
    # (seg_specs [(len, n_cached)...], kv, g, hd, bs, nb, n_pool)
    ([(6, 0), (3, 13), (1, 20)], 2, 4, 64, 8, 4, 40),
    ([(5, 3), (5, 11), (5, 19)], 1, 8, 128, 16, 2, 8),
    ([(7, 9)], 4, 2, 64, 4, 6, 32),
    ([(1, 0), (1, 7), (1, 15), (1, 30)], 8, 1, 32, 8, 4, 64),
]
# the remaining head dim the kernels take
SHAPES_HD112 = (2, 2, 4, 112, 16, 4, 16)
RAGGED_HD112 = ([(9, 5), (3, 17)], 2, 4, 112, 16, 3, 16)
# full-width qwen3-1.7b: KV 8, G 2, hd 128, block 16; 16 decode sequences
# at contexts 256-4096; 4 prefill chunks of 512 tokens at offsets 0-1536
FULL_PAGED = (16, 8, 2, 128, 16, 256, 4096)
FULL_CONTEXTS = (256, 4096)
FULL_RAGGED = ([(512, 0), (512, 512), (512, 1024), (512, 1536)],
               8, 2, 128, 16, 128, 1024)
# the kernels' tile edges at full width: decode contexts around the split
# boundaries (SPLIT_TOKENS = 256: 1 to 513 tokens); prefill chunks of 100,
# 65, 1 and 130 tokens (no multiple of the 64-token row tile at G = 2) at
# offsets 37, 0, 63 and 64 (no multiple of the 64-token key tile but one)
EDGE_PAGED = (8, 8, 2, 128, 16, 40, 512)
EDGE_CONTEXTS = (1, 17, 255, 256, 257, 511, 512, 513)
EDGE_RAGGED = ([(100, 37), (65, 0), (1, 63), (130, 64)], 8, 2, 128, 16, 13,
               64)

# the head shapes the served families give the kernels at full width:
# (KV, G, hd) of qwen2-moe-a2.7b (16 over 16), stablelm-3b (32 over 32,
# hd 80) and llama3.2-3b (24 over 8); each is checked on a sweep-sized
# case (contexts across the decode splits, chunks across the row and key
# tiles) in both dtypes and timed in bf16 at the full-width sizes above
HEAD_SHAPES = {"qwen2-moe": (16, 1, 128), "stablelm": (32, 1, 80),
               "llama3.2": (8, 3, 128)}
# the tensor_parallel phase's local head shapes: qwen3-1.7b's 8 KV heads
# over 2 and 4 shards
TP_HEAD_SHAPES = {"qwen3-tp2": (4, 2, 128), "qwen3-tp4": (2, 2, 128)}
HEAD_PAGED = (3, 16, 40, 128)               # b, bs, nb, n_pool
HEAD_RAGGED = ([(130, 37), (65, 0), (1, 300)], 16, 24, 96)

DEVICE = "cuda"

PAGED_SRC = "src/repro_torch/kernels/csrc/paged_attention.cu"
RAGGED_SRC = "src/repro_torch/kernels/csrc/ragged_attention.cu"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class PhaseFailed(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseFailed(msg)


# =============================================================================
# inputs (numpy, from a seed) and comparisons
# =============================================================================


def paged_case(rng, b, kv, g, hd, bs, nb, n_pool, contexts=None):
    q = rng.standard_normal((b, kv, g, hd), np.float32)
    kp = rng.standard_normal((n_pool, bs, kv, hd), np.float32)
    vp = rng.standard_normal((n_pool, bs, kv, hd), np.float32)
    bt = rng.permutation(n_pool)[:b * nb].reshape(b, nb).astype(np.int32)
    lo, hi = contexts or (1, nb * bs)
    cl = rng.integers(lo, hi + 1, b).astype(np.int32)
    return q, kp, vp, bt, cl


def ragged_case(rng, seg_specs, kv, g, hd, bs, nb, n_pool):
    kp = rng.standard_normal((n_pool, bs, kv, hd), np.float32)
    vp = rng.standard_normal((n_pool, bs, kv, hd), np.float32)
    perm = rng.permutation(n_pool)
    s, lmax = len(seg_specs), max(n for n, _ in seg_specs)
    bt = np.stack([perm[i * nb:(i + 1) * nb] for i in range(s)]).astype(np.int32)
    pos = np.zeros((s, lmax), np.int32)
    for i, (n, c) in enumerate(seg_specs):
        pos[i, :n] = np.arange(c, c + n)
    q = rng.standard_normal((s, lmax, kv, g, hd), np.float32)
    return q, kp, vp, bt, pos


def on_card(arrays, dtype):
    import torch
    return [torch.from_numpy(a).to(DEVICE, dtype if a.dtype == np.float32
                                   else torch.int32) for a in arrays]


def compare(out, ref, tol: float, what: str) -> float:
    """allclose(rtol=atol=tol) as the tests do; returns the max abs err."""
    import torch
    o, r = out.float(), ref.float()
    require(bool(torch.isfinite(o).all()), f"{what}: non-finite output")
    err = (o - r).abs()
    require(bool((err <= tol + tol * r.abs()).all()),
            f"{what}: max abs err {float(err.max())} beyond tol {tol}")
    return float(err.max())


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (CUDA
    events); inputs stay resident, so what fits the 50 MB L2 is warm."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, calls: int = 20, replays: int = 5) -> float:
    """Mean device time of ``fn`` with the host out of the way: ``calls``
    back-to-back calls captured in one CUDA graph, replayed ``replays``
    times between CUDA events.  Inputs stay resident, as in ``time_ms``."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def timings(kernel, plain, library, b_ms: float, b_by: str, shape) -> dict:
    """Device times (graph replays) and eager times of a kernel, its plain
    version and the library call, beside the kernel's bound."""
    ms = graph_ms(kernel)
    library_ms = graph_ms(library)
    return {"kernel_ms": ms, "ref_ms": graph_ms(plain, calls=5),
            "library_ms": library_ms,
            "kernel_eager_ms": time_ms(kernel),
            "ref_eager_ms": time_ms(plain, iters=5),
            "library_eager_ms": time_ms(library),
            "bound_ms": b_ms, "bound_us": b_ms * 1e3, "bound_by": b_by,
            "bound_share": b_ms / ms, "vs_library": ms / library_ms,
            "shape": shape}


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound(bytes_moved: int, ops: int, dtype: str):
    """(bound_ms, bound_by): the larger of bytes over HBM bandwidth and
    operations over the peak rate of the input type."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# =============================================================================
# phase 1: build
# =============================================================================


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


def phase_build(state):
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    lib = build.load_library()
    seconds = time.perf_counter() - t0
    for name in ("paged_attention_launch", "ragged_attention_launch"):
        require(hasattr(lib, name), f"library lacks {name}")
    smi = nvidia_smi()
    print(smi, flush=True)
    state["smi"] = smi
    spills = [ln.strip() for ln in build.build_log.splitlines()
              if "spill" in ln and not ln.strip().startswith("0 bytes")]
    return {"build_s": seconds, "nvcc_s": build.build_seconds,
            "sources": [PAGED_SRC, RAGGED_SRC], "nvidia_smi": smi,
            "ptxas_spill_lines": spills}


# =============================================================================
# phase 2: kernels against their plain versions
# =============================================================================


def sdpa_paged(q, kp, vp, bt, cl):
    """SDPA on a dense-gathered copy of the decode inputs: a callable that
    runs only the library call."""
    import torch
    import torch.nn.functional as F
    b, kv, g, hd = q.shape
    s_max = bt.shape[1] * kp.shape[1]
    k = kp[bt.long()].reshape(b, s_max, kv, hd).transpose(1, 2)
    v = vp[bt.long()].reshape(b, s_max, kv, hd).transpose(1, 2)
    k = k.repeat_interleave(g, dim=1).contiguous()
    v = v.repeat_interleave(g, dim=1).contiguous()
    qd = q.reshape(b, kv * g, 1, hd)
    mask = (torch.arange(s_max, device=q.device)[None, :]
            < cl.long()[:, None])[:, None, None, :]
    return lambda: F.scaled_dot_product_attention(qd, k, v, attn_mask=mask)


def sdpa_ragged(q, kp, vp, bt, pos):
    import torch
    import torch.nn.functional as F
    s, lq, kv, g, hd = q.shape
    s_max = bt.shape[1] * kp.shape[1]
    k = kp[bt.long()].reshape(s, s_max, kv, hd).transpose(1, 2)
    v = vp[bt.long()].reshape(s, s_max, kv, hd).transpose(1, 2)
    k = k.repeat_interleave(g, dim=1).contiguous()
    v = v.repeat_interleave(g, dim=1).contiguous()
    qd = q.reshape(s, lq, kv * g, hd).transpose(1, 2).contiguous()
    mask = (pos.long()[:, :, None]
            >= torch.arange(s_max, device=q.device)[None, None, :])[:, None]
    return lambda: F.scaled_dot_product_attention(qd, k, v, attn_mask=mask)


def poison_paged(args, value_k, value_v):
    """Copies of the pools with every token at or past each sequence's
    context set to poison: the tail of the last page, and the pages the
    table lists past it."""
    q, kp, vp, bt, cl = args
    kp2, vp2 = kp.clone(), vp.clone()
    bs = kp.shape[1]
    for b, c in enumerate(cl.tolist()):
        last, off = (c - 1) // bs, (c - 1) % bs + 1
        kp2[bt[b, last], off:] = value_k
        vp2[bt[b, last], off:] = value_v
        rest = bt[b, last + 1:].long()
        kp2[rest] = value_k
        vp2[rest] = value_v
    return q, kp2, vp2, bt, cl


def poison_ragged(args, value_k, value_v):
    """Table entries past each segment's page bound pointed at one block
    of poison (a block no segment's reachable pages use)."""
    q, kp, vp, bt, pos = args
    bs = kp.shape[1]
    kp2, vp2, bt2 = kp.clone(), vp.clone(), bt.clone()
    used = set()
    for s in range(bt.shape[0]):
        used.update(bt[s, :int(pos[s].max()) // bs + 1].tolist())
    spare = next(i for i in range(kp.shape[0] - 1, -1, -1) if i not in used)
    kp2[spare], vp2[spare] = value_k, value_v
    for s in range(bt.shape[0]):
        bt2[s, int(pos[s].max()) // bs + 1:] = spare
    return q, kp2, vp2, bt2, pos


def phase_kernels(state, seed: int):
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.kernels.ragged_attention import ragged_segment_attention
    rng = np.random.default_rng(seed)
    # the served head shapes draw from a generator of their own, so the
    # shapes timed above keep the inputs of earlier runs
    served_rng = np.random.default_rng(seed + 2)
    tp_rng = np.random.default_rng(seed + 3)
    errs = {"paged_attention": {}, "ragged_segment_attention": {}}
    checks = 0
    for name, tdt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        tol = TOL[name]
        # decode: the sweep, hd 112 and the full-width shape
        worst = 0.0
        for shape in SHAPES + [SHAPES_HD112]:
            args = on_card(paged_case(rng, *shape), tdt)
            worst = max(worst, compare(paged_attention(*args),
                                       ref.paged_attention_ref(*args), tol,
                                       f"paged {name} {shape}"))
            checks += 1
        full = on_card(paged_case(rng, *FULL_PAGED, contexts=FULL_CONTEXTS),
                       tdt)
        out_full = paged_attention(*full)
        err_full = compare(out_full, ref.paged_attention_ref(*full), tol,
                           f"paged {name} full width")
        # poison past the context: 1e4 in K, NaN in V
        require(torch.equal(paged_attention(
            *poison_paged(full, 1e4, float("nan"))), out_full),
            f"paged {name}: poison past the context changed the output")
        edge = on_card(paged_case(rng, *EDGE_PAGED), tdt)
        edge[4] = torch.tensor(EDGE_CONTEXTS, dtype=torch.int32,
                               device=DEVICE)
        out_edge = paged_attention(*edge)
        worst = max(worst, compare(out_edge, ref.paged_attention_ref(*edge),
                                   tol, f"paged {name} split edges"))
        require(torch.equal(paged_attention(
            *poison_paged(edge, 1e4, float("nan"))), out_edge),
            f"paged {name}: poison past the split-edge contexts changed "
            "the output")
        # the legacy decode step's padded batch: dead rows with context 1
        # and all-zero table rows, at full width and at a sweep shape
        # (drawn from a generator of their own, so the timed shapes keep
        # the contexts of earlier runs)
        dead_rng = np.random.default_rng(seed + 1)
        for shape, live, what in ((FULL_PAGED, 10, "full width"),
                                  (SHAPES[2], 1, "sweep")):
            dead = on_card(paged_case(
                dead_rng, *shape, contexts=FULL_CONTEXTS
                if shape is FULL_PAGED else None), tdt)
            dead[3][live:] = 0
            dead[4][live:] = 1
            worst = max(worst, compare(
                paged_attention(*dead), ref.paged_attention_ref(*dead), tol,
                f"paged {name} dead rows ({what})"))
            checks += 1
        small = on_card(paged_case(rng, 1, 2, 2, 64, 8, 4, 32), tdt)
        small[4] = torch.tensor([11], dtype=torch.int32, device=DEVICE)
        require(torch.equal(paged_attention(*poison_paged(small, 1e4,
                                                          float("nan"))),
                            paged_attention(*small)),
                f"paged {name}: poison past cl = 11 changed the output")
        # cl = 1 attends the first token only; cl = 0 gives zero rows
        q, kp, vp, bt, _ = on_card(paged_case(rng, 1, 1, 2, 64, 8, 2, 8), tdt)
        one = torch.ones(1, dtype=torch.int32, device=DEVICE)
        out1 = paged_attention(q, kp, vp, bt, one)
        compare(out1, vp[bt[0, 0], 0][None, :, None, :].expand_as(out1),
                tol, f"paged {name} cl=1")
        zero = torch.zeros(3, dtype=torch.int32, device=DEVICE)
        q, kp, vp, bt, _ = on_card(paged_case(rng, 3, 2, 2, 64, 8, 2, 8), tdt)
        require(not paged_attention(q, kp, vp, bt, zero).any(),
                f"paged {name}: cl = 0 must give zero rows")
        checks += 7
        errs["paged_attention"][name] = max(worst, err_full)
        errs["paged_attention"][name + "_full"] = err_full

        # prefill chunks: the sweep, hd 112 and the full-width shape
        worst = 0.0
        for case in RAGGED_SWEEP + [RAGGED_HD112]:
            args = on_card(ragged_case(rng, *case), tdt)
            out = ragged_segment_attention(*args)
            worst = max(worst, compare(out,
                                       ref.ragged_segment_attention_ref(*args),
                                       tol, f"ragged {name} {case[0]}"))
            # the flatten-and-repeat lowering over the decode kernel
            compare(out, ops.ragged_segment_attention(*args, backend="flat"),
                    tol, f"ragged {name} {case[0]} vs flat")
            checks += 2
        rfull = on_card(ragged_case(rng, *FULL_RAGGED), tdt)
        rout_full = ragged_segment_attention(*rfull)
        rerr_full = compare(rout_full,
                            ref.ragged_segment_attention_ref(*rfull), tol,
                            f"ragged {name} full width")
        require(torch.equal(ragged_segment_attention(
            *poison_ragged(rfull, 1e4, float("nan"))), rout_full),
            f"ragged {name}: poison past the page bound changed the output")
        redge = on_card(ragged_case(rng, *EDGE_RAGGED), tdt)
        rout_edge = ragged_segment_attention(*redge)
        worst = max(worst, compare(rout_edge,
                                   ref.ragged_segment_attention_ref(*redge),
                                   tol, f"ragged {name} tile edges"))
        require(torch.equal(ragged_segment_attention(
            *poison_ragged(redge, 1e4, float("nan"))), rout_edge),
            f"ragged {name}: poison past the tile-edge page bounds changed "
            "the output")
        small = on_card(ragged_case(rng, [(4, 6), (2, 0)], 2, 2, 64, 8, 4, 40),
                        tdt)
        require(torch.equal(ragged_segment_attention(
            *poison_ragged(small, 1e4, float("nan"))),
            ragged_segment_attention(*small)),
            f"ragged {name}: poison past a small page bound changed the "
            "output")
        checks += 5
        errs["ragged_segment_attention"][name] = max(worst, rerr_full)
        errs["ragged_segment_attention"][name + "_full"] = rerr_full

        if name == "bfloat16":      # the main path's type: time it
            state["timing"] = {
                "paged_attention": time_paged(full),
                "ragged_segment_attention": time_ragged(rfull),
            }
        checks += served_head_shapes(state, served_rng, name, tdt, tol)
        checks += served_head_shapes(state, tp_rng, name, tdt, tol,
                                     TP_HEAD_SHAPES)
    torch.cuda.synchronize()
    state["errs"] = errs
    return {"checks": checks, "max_abs_err": errs,
            "max_abs_err_by_head_shape": state["shape_errs"],
            "timing_bf16_full_width": {"qwen3-1.7b": state["timing"],
                                       **state["shape_timing"]}}


def served_head_shapes(state, rng, name: str, tdt, tol: float,
                       shapes=HEAD_SHAPES) -> int:
    """Both kernels against their plain versions at each of ``shapes``,
    with poison past every bound; in bf16 each is also timed at the
    full-width sizes.  Returns the number of checks."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.kernels.ragged_attention import ragged_segment_attention
    errs = state.setdefault("shape_errs", {})
    timing = state.setdefault("shape_timing", {})
    nan = float("nan")
    for label, (kv, g, hd) in shapes.items():
        b, bs, nb, n_pool = HEAD_PAGED
        args = on_card(paged_case(rng, b, kv, g, hd, bs, nb, n_pool), tdt)
        out = paged_attention(*args)
        e_paged = compare(out, ref.paged_attention_ref(*args), tol,
                          f"paged {name} {label}")
        require(torch.equal(paged_attention(*poison_paged(args, 1e4, nan)),
                            out), f"paged {name} {label}: poison past the "
                            "context changed the output")
        segs, bs, nb, n_pool = HEAD_RAGGED
        args = on_card(ragged_case(rng, segs, kv, g, hd, bs, nb, n_pool), tdt)
        out = ragged_segment_attention(*args)
        e_ragged = compare(out, ref.ragged_segment_attention_ref(*args), tol,
                           f"ragged {name} {label}")
        require(torch.equal(ragged_segment_attention(
            *poison_ragged(args, 1e4, nan)), out),
            f"ragged {name} {label}: poison past the page bound changed the "
            "output")
        row = errs.setdefault(label, {"KV": kv, "G": g, "hd": hd})
        row[f"paged_{name}"], row[f"ragged_{name}"] = e_paged, e_ragged
        if name == "bfloat16":
            b, _, _, _, bs, nb, n_pool = FULL_PAGED
            full = on_card(paged_case(rng, b, kv, g, hd, bs, nb, n_pool,
                                      contexts=FULL_CONTEXTS), tdt)
            row["paged_bfloat16_full"] = compare(
                paged_attention(*full), ref.paged_attention_ref(*full), tol,
                f"paged {name} {label} full width")
            segs, _, _, _, bs, nb, n_pool = FULL_RAGGED
            rfull = on_card(ragged_case(rng, segs, kv, g, hd, bs, nb, n_pool),
                            tdt)
            row["ragged_bfloat16_full"] = compare(
                ragged_segment_attention(*rfull),
                ref.ragged_segment_attention_ref(*rfull), tol,
                f"ragged {name} {label} full width")
            timing[label] = {"paged_attention": time_paged(full),
                             "ragged_segment_attention": time_ragged(rfull)}
            del full, rfull
    return 4 * len(shapes) + (2 * len(shapes) if name == "bfloat16" else 0)


def time_paged(args):
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attention import paged_attention
    q, kp, vp, bt, cl = args
    kv, hd = q.shape[1], q.shape[3]
    tokens = int(cl.sum())
    kv_bytes = 2 * tokens * kv * hd * kp.element_size()
    ops = 4 * tokens * kv * q.shape[2] * hd
    b_ms, b_by = bound(kv_bytes + nbytes(q, q, bt, cl), ops, "bfloat16")
    return timings(lambda: paged_attention(*args),
                   lambda: ref.paged_attention_ref(*args), sdpa_paged(*args),
                   b_ms, b_by,
                   {"B": q.shape[0], "KV": kv, "G": q.shape[2], "hd": hd,
                    "bs": kp.shape[1], "context_tokens": tokens})


def time_ragged(args):
    from repro_torch.kernels import ref
    from repro_torch.kernels.ragged_attention import ragged_segment_attention
    q, kp, vp, bt, pos = args
    s, lq, kv, g, hd = q.shape
    bs = kp.shape[1]
    # each segment reads its pages up to its largest position, once
    reach = int(((pos.max(dim=1).values // bs + 1) * bs).sum())
    kv_bytes = 2 * reach * kv * hd * kp.element_size()
    ops = 4 * kv * g * hd * int((pos.long() + 1).sum())
    b_ms, b_by = bound(kv_bytes + nbytes(q, q, bt, pos), ops, "bfloat16")
    return timings(lambda: ragged_segment_attention(*args),
                   lambda: ref.ragged_segment_attention_ref(*args),
                   sdpa_ragged(*args), b_ms, b_by,
                   {"S": s, "L": lq, "KV": kv, "G": g, "hd": hd, "bs": bs,
                    "max_positions": pos.max(dim=1).values.tolist()})


# =============================================================================
# phases 3 and 4: the fused serving iteration
# =============================================================================


def make_requests(mod, seed: int, vocab: int, max_new: int = 32):
    """16 requests from 4 agents: each agent has a system prompt of
    256-1024 tokens, each request adds 64-512 tokens of its own and asks
    for ``max_new`` new tokens.  Returns (first wave: one request per
    agent, second wave: the other 12)."""
    rng = np.random.default_rng(seed)
    system = [rng.integers(0, vocab, int(rng.integers(256, 1025)))
              for _ in range(4)]
    reqs = []
    for i in range(16):
        a = i % 4
        own = rng.integers(0, vocab, int(rng.integers(64, 513)))
        toks = np.concatenate([system[a], own]).astype(np.int32)
        reqs.append(mod.Request(agent_name=f"agent{a}", msg_id=f"m{i:02d}",
                                prompt_len=len(toks), prompt_tokens=toks,
                                max_new_tokens=max_new,
                                shared_prefix_len=len(system[a])))
    return reqs[:4], reqs[4:]


def drain(engine, waves, max_iters: int = 2000, addr_seq=None,
          force_sync: bool = True):
    """Submit the first wave; submit the second once every first-wave
    request has its first token (so its system prompt is in the prefix
    cache); step until drained.  Returns (finished, iterations, the pool
    addresses seen, wall seconds, per-iteration (has prefill chunks — None
    on the legacy path, which composes no batch — seconds)).  The pool
    address after each iteration is appended to ``addr_seq`` when
    given.  ``force_sync=False`` collects without waiting for the card:
    the new tokens stay there until the next iteration's batch or a
    finished request needs them."""
    import torch
    first, second = waves
    clock = engine.clock
    t0 = time.perf_counter()
    for r in first:
        r.arrival_time = clock()
        engine.submit(r)
    done, iters, addrs = [], 0, {engine.runner.pool_address()}
    steps = []
    pending = list(second)
    while pending or engine.running or engine.waiting:
        if pending and all(r.first_token_time >= 0 for r in first):
            for r in pending:
                r.arrival_time = clock()
                engine.submit(r)
            pending = []
        require(iters < max_iters, "drain did not finish")
        t_step = time.perf_counter()
        require(engine.dispatch_iteration(), "engine planned no iteration")
        batch = engine._pending
        has_prefill = (batch[0].tokens_p.size > 0 if batch is not None
                       else None)
        iters += 1
        done.extend(engine.collect(force_sync=force_sync))
        steps.append((has_prefill, time.perf_counter() - t_step))
        addrs.add(engine.runner.pool_address())
        if addr_seq is not None:
            addr_seq.append(engine.runner.pool_address())
    torch.cuda.synchronize()
    return done, iters, addrs, time.perf_counter() - t0, steps


def full_config():
    """qwen3-1.7b at its published widths."""
    from repro_torch.configs import get_config
    cfg = get_config("qwen3-1.7b")
    require(cfg.num_layers == 28 and cfg.d_model == 2048
            and cfg.resolved_head_dim == 128 and cfg.dtype == "bfloat16",
            "not the full-width qwen3-1.7b")
    return cfg


def served(cfg, seed: int):
    """A model with seeded random weights on the card."""
    import torch
    from repro_torch.models import LanguageModel
    model = LanguageModel(cfg)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    return model, model.init_params(gen, device=DEVICE)


def runner_for(model, params, backend=None, num_blocks=4096,
               donate_pool=True):
    from repro_torch import serving
    return serving.PagedModelRunner(model, params, num_blocks=num_blocks,
                                    block_size=16, max_batch=16,
                                    backend=backend, donate_pool=donate_pool,
                                    device=DEVICE)


def engine_for(runner, fused=True, **kw):
    from repro_torch import serving
    serving.reset_request_ids()
    return serving.LLMEngine(runner, max_batch=16, enable_prefix_cache=True,
                             prefill_chunk_tokens=512, fused_iteration=fused,
                             **kw)


def device_busy(profile_events, wall_s: float, ranges=()):
    """Busy and idle shares of the card over ``wall_s``, and each kernel
    family's share of the busy time, from a torch.profiler trace.  The
    device-side spans of the ``record_function`` ranges named in
    ``ranges`` are not kernels and are left out."""
    from torch.autograd import DeviceType
    spans, by_name, count = [], {}, {}
    for e in profile_events:
        if e.device_type != DeviceType.CUDA or e.name in ranges:
            continue
        s, t = e.time_range.start, e.time_range.end
        spans.append((s, t))
        name = e.name
        # paged_attention_split_kernel; ragged_attention_tc_kernel (bf16)
        # and ragged_attention_kernel (fp32)
        key = ("paged_attention" if "paged_attention" in name
               else "ragged_segment_attention"
               if "ragged_attention" in name
               else "gemm" if ("gemm" in name.lower() or "cutlass" in name
                               or name.startswith("nvjet"))
               else "other")
        by_name[key] = by_name.get(key, 0.0) + (t - s)
        count[key] = count.get(key, 0) + 1
    if not spans:
        return None
    spans.sort()
    busy, cur_s, cur_t = 0.0, *spans[0]
    for s, t in spans[1:]:
        if s > cur_t:
            busy += cur_t - cur_s
            cur_s, cur_t = s, t
        else:
            cur_t = max(cur_t, t)
    busy += cur_t - cur_s
    busy_s = busy * 1e-6
    return {"device_busy_s": busy_s, "wall_s": wall_s,
            "idle_share": max(0.0, 1.0 - busy_s / wall_s),
            "busy_share_by_kernel": {k: v * 1e-6 / busy_s
                                     for k, v in sorted(by_name.items())},
            "attention_ms_per_launch": {
                k: by_name[k] * 1e-3 / count[k] for k in
                ("paged_attention", "ragged_segment_attention")
                if count.get(k)}}


def phase_drain(state, seed: int):
    import torch
    from repro_torch import serving
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.kernels.ragged_attention import ragged_segment_attention
    cfg = full_config()
    model, params = served(cfg, seed)
    runner = runner_for(model, params)
    require(runner.backend == "cuda" and runner.ragged_backend == "cuda",
            "the runner must default to the CUDA kernels on the card")
    # warm-up: one request on a clone (cuBLAS handles, allocator)
    warm = runner.clone()
    eng = engine_for(warm)
    first, _ = make_requests(serving, seed + 1, cfg.vocab_size)
    drain(eng, (first[:1], []))
    del eng, warm
    torch.cuda.empty_cache()

    waves = make_requests(serving, seed, cfg.vocab_size)
    eng = engine_for(runner)
    addr = runner.pool_address()
    paged_attention.launches = 0
    ragged_segment_attention.launches = 0
    done, iters, addrs, wall, steps = drain(eng, waves)
    launches = {"paged_attention": paged_attention.launches,
                "ragged_segment_attention": ragged_segment_attention.launches}
    state["launches"] = launches
    require(min(launches.values()) > 0, f"a kernel never launched: {launches}")
    # the split merges run inside the kernels: at most one launch of each
    # kernel per layer and iteration
    require(max(launches.values()) <= cfg.num_layers * iters,
            f"more than one launch per layer and iteration: {launches}")
    require(runner.n_dispatches == iters,
            f"{runner.n_dispatches} dispatches for {iters} iterations")
    state["fused_dispatches_per_iteration"] = runner.n_dispatches / iters
    require(addrs == {addr}, "the pool moved during the drain")
    require(len(done) == 16, f"{len(done)} of 16 requests finished")
    for r in done:
        require(len(r.output_tokens) == 32 and all(
            0 <= int(t) < cfg.vocab_size for t in r.output_tokens),
            f"{r.msg_id}: bad output {r.output_tokens[:4]}...")
    # the tensor_parallel phase's tp 1 streams
    state["drain_streams"] = streams_of(done)
    ttft = [r.first_token_time - r.arrival_time for r in done]
    tpot = [(r.finish_time - r.first_token_time) / (r.output_len - 1)
            for r in done]
    generated = sum(r.output_len for r in done)
    snap = eng.metrics_snapshot()
    out = {"model": "qwen3-1.7b", "layers": cfg.num_layers,
           "dtype": cfg.dtype, "params": cfg.param_count(),
           "requests": len(done), "iterations": iters,
           "wall_s": wall, "generated_tokens": generated,
           "tokens_per_s": generated / wall,
           "prefill_tokens": eng.stats.prefill_tokens,
           "prefill_tokens_saved": eng.stats.prefill_tokens_saved,
           "ttft_median_s": statistics.median(ttft),
           "tpot_median_s": statistics.median(tpot),
           "iteration_s_mean": wall / iters,
           "iterations_with_prefill": sum(p for p, _ in steps),
           "iteration_s_median_with_prefill": statistics.median(
               t for p, t in steps if p),
           "iteration_s_median_decode_only": statistics.median(
               t for p, t in steps if not p),
           "kernel_launches": launches,
           "launches_per_iteration": {k: v / iters
                                      for k, v in launches.items()},
           "pool_bytes": snap["pool_bytes"],
           "pool_address_stable": True,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    # the overload phase reports its drains beside this one
    state["drain_summary"] = {k: out[k] for k in (
        "iterations", "wall_s", "generated_tokens", "prefill_tokens",
        "prefill_tokens_saved", "ttft_median_s", "tpot_median_s",
        "iteration_s_median_with_prefill", "iteration_s_median_decode_only")}

    # the same traffic again, under the profiler, for the idle share
    try:
        from torch.profiler import ProfilerActivity, profile
        eng2 = engine_for(runner.clone())
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            replay = drain(eng2, make_requests(serving, seed,
                                               cfg.vocab_size))
        busy = device_busy(prof.events(), replay[3])
        if busy:
            top = sorted(prof.key_averages(),
                         key=lambda e: -e.self_cpu_time_total)
            busy["host_top_ops_s"] = {e.key: e.self_cpu_time_total * 1e-6
                                      for e in top[:8]}
            busy["kernel_launches_per_iteration"] = sum(
                e.count for e in top if e.key == "cudaLaunchKernel"
            ) / replay[1]
            # the profiler slows the host: read the busy time against the
            # unprofiled drain's wall time too
            busy["idle_share_of_unprofiled_wall"] = max(
                0.0, 1.0 - busy["device_busy_s"] / wall)
        out["profiled"] = busy or "not measured"
    except Exception as e:          # the profiler is a measurement only
        out["profiled"] = f"not measured: {type(e).__name__}: {e}"
    return out


def record_margins(*runners):
    """Hook the runners so every iteration records, per real segment row,
    the top-2 logit margin of its argmax and whether the logits were
    finite.  The logits hook is shared: step the runners from one thread.
    Returns (log, undo)."""
    import torch
    from repro_torch.serving import engine as engine_mod
    log, last = [], {}
    orig_logits = engine_mod.lm_logits
    origs = [(r, r.run_iteration) for r in runners]

    def logits_hook(params, x, cfg):
        logits = orig_logits(params, x, cfg)
        top = logits.float().topk(2, dim=-1).values
        last["margin"] = top[:, 0] - top[:, 1]
        last["finite"] = torch.isfinite(logits).all()
        return logits

    def hooked(orig_run):
        def run_hook(batch):
            nxt = orig_run(batch)
            log.append(([(s.req.msg_id, s.kind == "decode" or s.emits_token)
                         for s in batch.segments], last["margin"],
                        last["finite"]))
            return nxt
        return run_hook

    def undo():
        engine_mod.lm_logits = orig_logits
        for runner, orig_run in origs:
            runner.run_iteration = orig_run

    engine_mod.lm_logits = logits_hook
    for runner, orig_run in origs:
        runner.run_iteration = hooked(orig_run)
    return log, undo


def streams_and_margins(done, log, max_new: int):
    margins = {}
    for segs, m, finite in log:
        require(bool(finite), "non-finite logits")
        m = m.cpu().tolist()
        for j, (msg, emits) in enumerate(segs):
            if emits:
                margins.setdefault(msg, []).append(m[j])
    streams = {r.msg_id: [int(t) for t in r.output_tokens] for r in done}
    return streams, {k: v[:max_new] for k, v in margins.items()}


def margin_rule(got, want, margins, what: str, routing=None) -> dict:
    """``got`` against ``want``: at the first token where a stream differs,
    ``want``'s run must have had a top-2 margin at or below MARGIN.  For
    an MoE model ``routing`` (msg -> per emitted token, whether the plain
    run had routed some token of that sequence, in some layer, with a
    top-k gap below ROUTE_GAP by then) excuses a divergence too."""
    compared = identical = near_ties = routed = 0
    min_margin = float("inf")
    for msg in sorted(want):
        g, w, m = got[msg], want[msg], margins[msg]
        require(len(g) == len(w) <= len(m), f"{what} {msg}: stream lengths")
        for i in range(len(w)):
            if g[i] != w[i]:
                if m[i] <= MARGIN:
                    near_ties += 1
                else:
                    require(routing is not None and routing[msg][i],
                            f"{what} {msg} token {i}: {g[i]} vs {w[i]} at "
                            f"margin {m[i]}, no routing near-tie")
                    routed += 1
                break
            compared += 1
            min_margin = min(min_margin, m[i])
        else:
            identical += 1
    out = {"streams": len(want), "identical_streams": identical,
           "tokens_compared": compared, "near_tie_divergences": near_ties,
           "min_margin_compared": min_margin}
    if routing is not None:
        out["routing_near_tie_divergences"] = routed
        out["streams_with_routing_near_ties"] = sum(
            any(v) for v in routing.values())
        out["unexplained_divergences"] = 0
    return out


def phase_identity(state, seed: int):
    import torch
    from repro_torch import serving
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.kernels.ragged_attention import ragged_segment_attention
    cfg = dataclasses.replace(full_config(), num_layers=4, dtype="float32")
    model, params = served(cfg, seed)
    runs = {}
    for backend in ("cuda", "ref"):
        runner = runner_for(model, params, backend)
        log, undo = record_margins(runner)
        before = (paged_attention.launches, ragged_segment_attention.launches)
        try:
            eng = engine_for(runner)
            done = drain(eng, make_requests(serving, seed,
                                            cfg.vocab_size))[0]
        finally:
            undo()
        launched = (paged_attention.launches - before[0],
                    ragged_segment_attention.launches - before[1])
        require((min(launched) > 0) == (backend == "cuda"),
                f"backend {backend} launched {launched}")
        require(eng.stats.n_preempted == 0, "identity drain preempted")
        runs[backend] = streams_and_margins(done, log, 32) + (done,)
        del runner, eng
        torch.cuda.empty_cache()

    cuda_streams, _, cuda_done = runs["cuda"]
    # the tensor_parallel phase's float32 tp 1 streams and margins
    state["fp32_tp1"] = runs["cuda"][:2]
    ref_streams, ref_margins, _ = runs["ref"]
    require(all(len(v) == 32 for v in ref_streams.values()),
            "stream lengths")
    agreement = margin_rule(cuda_streams, ref_streams, ref_margins, "cuda")

    # each request's first token against the dense prefill's argmax
    first_checked = first_ties = 0
    for r in cuda_done:
        logits, _ = model.prefill(params, torch.as_tensor(
            np.asarray(r.prompt_tokens), device=DEVICE)[None])
        top = logits[0].topk(2)
        margin = float(top.values[0] - top.values[1])
        if margin <= MARGIN:
            first_ties += 1
            continue
        require(int(top.indices[0]) == int(r.output_tokens[0]),
                f"{r.msg_id}: first token {int(r.output_tokens[0])} vs "
                f"prefill argmax {int(top.indices[0])} (margin {margin})")
        first_checked += 1
    return {"layers": cfg.num_layers, "dtype": cfg.dtype, **agreement,
            "first_tokens_vs_prefill": first_checked,
            "first_token_ties_skipped": first_ties}


# =============================================================================
# phase 5: the Kairos multi-agent path
# =============================================================================

# the quickstart's QA topology at realistic lengths
WF_SYSTEM = {"Router": 256, "MathAgent": 1024, "HumanitiesAgent": 1024}
WF_QUESTION = (64, 513)
WF_NEW = {"Router": 4, "MathAgent": 64, "HumanitiesAgent": 64}
WF_TASKS, WF_CHECK_TASKS = 32, 8
WF_CONFIG = dict(n_instances=2, num_blocks=2048, block_size=16,
                 max_batch=16, prefix_caching=True, prefill_chunk_tokens=512,
                 policy="kairos")


def qa_agents(seed: int, vocab: int, calls: list):
    """Router -> MathAgent | HumanitiesAgent, as ``examples/quickstart.py``,
    with system prompts drawn from ``seed``.  Every LLM call is appended
    to ``calls`` as (agent, prompt with its system prompt, max_new_tokens,
    output tokens)."""
    from repro_torch.agents import BaseAgent
    rng = np.random.default_rng(seed)
    system = {a: rng.integers(0, vocab, n).astype(np.int32)
              for a, n in WF_SYSTEM.items()}
    lock = threading.Lock()

    class QAAgent(BaseAgent):
        def system_prompt_tokens(self):
            return system[self.name]

        def ask(self, question, metadata):
            out = self.generate(question, metadata,
                                max_new_tokens=WF_NEW[self.name])
            with lock:
                calls.append((self.name,
                              np.concatenate([system[self.name], question]),
                              WF_NEW[self.name], list(out)))
            return out

    class Router(QAAgent):
        def _run_impl(self, input_data, metadata):
            out = self.ask(input_data["question"], metadata)
            # route by content (synthetic: parity of the first token)
            return input_data, ("MathAgent" if out[0] % 2 == 0
                                else "HumanitiesAgent")

    class Expert(QAAgent):
        def _run_impl(self, input_data, metadata):
            return {"answer": self.ask(input_data["question"], metadata),
                    "by": self.name}, None

    return {"Router": Router, "MathAgent": Expert, "HumanitiesAgent": Expert}


def host_clock(wf):
    """Wrap the cluster's parts so that each records its host seconds and
    calls: the cluster step, the balancer tick, the orchestrator's
    completion hook, and each engine's dispatch (plan, flatten, launches),
    device wait (``sync``) and collect.  Returns the running totals."""
    totals = {}
    lock = threading.Lock()

    def wrap(obj, attr, key):
        f = getattr(obj, attr)

        def timed(*a, **kw):
            t = time.perf_counter()
            try:
                return f(*a, **kw)
            finally:
                dt = time.perf_counter() - t
                with lock:
                    s, n = totals.get(key, (0.0, 0))
                    totals[key] = (s + dt, n + 1)

        setattr(obj, attr, timed)

    c = wf.cluster
    wrap(c, "step", "cluster_step")
    wrap(c.balancer, "tick", "balancer_tick")
    wrap(c.orch, "on_completion", "orchestrator_on_completion")
    for e in c.engines:
        for attr in ("dispatch_iteration", "sync", "collect"):
            wrap(e, attr, f"engine_{attr}")
    return totals


def run_workflow(model, params, seed: int, n_tasks: int, device=DEVICE,
                 pipelined: bool = True, profile: bool = False,
                 config=None, cluster_kwargs=None):
    """The QA app with ``n_tasks`` tasks submitted at once, on the
    cluster ``Workflow.add_engine`` would build, but at the given model's
    width; ``config`` replaces WF_CONFIG and ``cluster_kwargs`` go to
    ``ServingCluster.from_config``.  Returns (workflow, msg ids, results,
    LLM calls, submit time, wall seconds, host seconds and calls by part,
    the torch.profiler events of the run's device activity when
    ``profile``)."""
    from repro_torch.agents import Workflow
    from repro_torch.obs import Tracer
    from repro_torch.serving import (
        ServingCluster,
        ServingConfig,
        reset_request_ids,
    )
    reset_request_ids()
    wf = Workflow(app_name="QA",
                  config=ServingConfig(**(config or WF_CONFIG)),
                  tracer=Tracer(), device=device, pipelined=pipelined)
    # what add_engine does, on these weights
    wf.cluster = ServingCluster.from_config(
        model, params, wf.orch, wf.config, pipelined=wf.pipelined,
        tracer=wf.tracer, device=device, **(cluster_kwargs or {}))
    wf.vocab_size = model.cfg.vocab_size
    calls = []
    for name, cls in qa_agents(seed, wf.vocab_size, calls).items():
        wf.add_agent(name, cls)
    rng = np.random.default_rng(seed + 1)
    questions = [rng.integers(0, wf.vocab_size,
                              int(rng.integers(*WF_QUESTION))).astype(np.int32)
                 for _ in range(n_tasks)]
    totals = host_clock(wf)
    prof = None
    if profile:
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as torch_profile
        prof = torch_profile(activities=[ProfilerActivity.CUDA])
        prof.__enter__()
    t0 = time.monotonic()
    ids = [wf.submit_task("Router", {"question": q}) for q in questions]
    try:
        results = wf.run(timeout=900)
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    wall = time.monotonic() - t0
    wf.cluster.close()
    return (wf, ids, results, calls, t0, wall, totals,
            prof.events() if prof is not None else None)


def workflow_report(wf, ids, results, t0: float, wall: float, vocab: int,
                    totals=None):
    """Checks of one workflow run, and what it measured."""
    from repro_torch.obs import percentile
    require(len(results) == len(ids),
            f"{len(results)} of {len(ids)} workflows completed")
    for m in ids:
        r = results[m]
        require(not r.get("failed"), f"{m} failed: {r.get('error')}")
        require(r["by"] in ("MathAgent", "HumanitiesAgent")
                and len(r["answer"]) == WF_NEW[r["by"]]
                and all(0 <= int(t) < vocab for t in r["answer"]),
                f"{m}: bad result {r['by']} {r['answer'][:4]}...")
    snap = wf.metrics_snapshot()
    instances = {}
    for e in wf.cluster.engines:
        label = wf.cluster.metrics_label(e)
        iters = int(snap.get(f"{label}.iteration_tokens.count", 0))
        inst = {"requests": int(snap[f"{label}.n_finished"]),
                "iterations": iters,
                "n_dispatches": int(snap[f"{label}.n_dispatches"]),
                "n_preempted": int(snap[f"{label}.n_preempted"]),
                "prefill_tokens_saved": int(
                    snap[f"{label}.prefill_tokens_saved"])}
        require(inst["requests"] >= 1, f"{label} served no request")
        require(inst["n_dispatches"] == iters,
                f"{label}: {inst['n_dispatches']} dispatches for {iters} "
                "iterations")
        instances[label] = inst
    agents = {"Router", "MathAgent", "HumanitiesAgent"}
    require(set(wf.orch.profiler.agents()) == agents,
            f"profiles learned for {wf.orch.profiler.agents()}")
    wf.orch.refresh_priorities()
    table = {k[1]: v for k, v in wf.orch.priorities.scores.items()}
    require(set(table) == agents, f"priority table over {sorted(table)}")
    pc = wf.prefix_cache_stats()

    spans = wf.trace_spans()
    e2e = {m: max(s.finish for s in spans if s.msg_id == m) - t0
           for m in ids}
    lat = sorted(e2e.values())
    by_agent = {}
    for s in spans:
        a = by_agent.setdefault(s.name, {"ttft": [], "tpot": []})
        a["ttft"].append(s.first_token - s.arrival)
        a["tpot"].append((s.finish - s.first_token) / (WF_NEW[s.name] - 1))
    slowest = max(e2e, key=e2e.get)
    cp = wf.critical_path(slowest)
    return {"workflows": len(results), "wall_s": wall,
            "e2e_median_s": statistics.median(lat),
            "e2e_p90_s": percentile(lat, 90),
            "per_agent": {a: {"calls": len(v["ttft"]),
                              "ttft_median_s": statistics.median(v["ttft"]),
                              "tpot_median_s": statistics.median(v["tpot"])}
                          for a, v in sorted(by_agent.items())},
            "instances": instances,
            "priority_table": dict(sorted(table.items(),
                                          key=lambda kv: kv[1])),
            "prefill_tokens": pc["prefill_tokens"],
            "prefill_tokens_saved": pc["prefill_tokens_saved"],
            "slowest_workflow": {"e2e_s": e2e[slowest],
                                 "critical_path": cp.breakdown(),
                                 "stages": cp.stage_rows()},
            "host_s_by_part": {k: {"s": v[0], "calls": v[1]}
                               for k, v in sorted((totals or {}).items())}}


def replay_check(model, params, calls, device=DEVICE):
    """Every recorded LLM call, alone through one engine on the plain
    versions: the workflow's stream must equal the replay's wherever the
    replay's top-2 margin exceeds MARGIN."""
    from repro_torch import serving
    runner = serving.PagedModelRunner(model, params, num_blocks=256,
                                      block_size=16, max_batch=16,
                                      backend="ref", device=device)
    log, undo = record_margins(runner)
    compared = identical = near_ties = 0
    min_margin = float("inf")
    try:
        eng = serving.LLMEngine(runner, max_batch=16,
                                prefill_chunk_tokens=512)
        for k, (agent, prompt, max_new, out) in enumerate(calls):
            start = len(log)
            eng.submit(serving.Request(
                agent_name=agent, msg_id=f"c{k}", prompt_len=len(prompt),
                prompt_tokens=prompt, max_new_tokens=max_new))
            done = eng.run_until_drained()
            streams, margins = streams_and_margins(done, log[start:],
                                                   max_new)
            r, m = streams[f"c{k}"], margins[f"c{k}"]
            require(len(out) == len(r) == len(m) == max_new,
                    f"call {k}: stream lengths")
            for i in range(max_new):
                if int(out[i]) != r[i]:
                    require(m[i] <= MARGIN, f"call {k} ({agent}) token {i}: "
                            f"cuda {out[i]} vs ref {r[i]} at margin {m[i]}")
                    near_ties += 1
                    break
                compared += 1
                min_margin = min(min_margin, m[i])
            else:
                identical += 1
    finally:
        undo()
    return {"calls": len(calls), "identical_streams": identical,
            "tokens_compared": compared, "near_tie_divergences": near_ties,
            "min_margin_compared": min_margin}


def release_pools() -> None:
    """Free the pools of engines that are gone: a Workflow and an engine
    hold reference cycles (agents and the workflow, the scheduler's
    preemption hook and its engine), so their pools wait for the cycle
    collector unless it runs now."""
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def phase_workflow(state, seed: int):
    import torch
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.kernels.ragged_attention import ragged_segment_attention
    release_pools()
    cfg = full_config()
    model, params = served(cfg, seed)
    # warm-up: the dispatch workers' cuBLAS handles, the allocator
    run_workflow(model, params, seed + 7, 2)
    release_pools()
    torch.cuda.reset_peak_memory_stats()
    paged_attention.launches = 0
    ragged_segment_attention.launches = 0
    wf, ids, results, _, t0, wall, totals, _ = run_workflow(
        model, params, seed, WF_TASKS)
    launches = {"paged_attention": paged_attention.launches,
                "ragged_segment_attention": ragged_segment_attention.launches}
    state["workflow_launches"] = launches
    require(min(launches.values()) > 0, f"a kernel never launched: {launches}")
    out = workflow_report(wf, ids, results, t0, wall, cfg.vocab_size, totals)
    require(out["prefill_tokens_saved"] > 0, "the prefix cache saved nothing")
    iters = sum(i["iterations"] for i in out["instances"].values())
    require(max(launches.values()) <= cfg.num_layers * iters,
            f"more than one launch per layer and iteration: {launches}")
    out.update({"model": "qwen3-1.7b", "layers": cfg.num_layers,
                "dtype": cfg.dtype, "config": WF_CONFIG,
                "kernel_launches": launches,
                "launches_per_iteration": {k: v / iters
                                           for k, v in launches.items()},
                "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                "card": state["smi"]})
    del wf
    release_pools()
    # the same traffic stepped by the serial loop (one thread, engine by
    # engine), and once more pipelined under the profiler for the card's
    # busy and idle shares
    wf, ids, results, _, t0, wall, totals, _ = run_workflow(
        model, params, seed, WF_TASKS, pipelined=False)
    serial = workflow_report(wf, ids, results, t0, wall, cfg.vocab_size,
                             totals)
    out["serial_loop"] = {k: serial[k] for k in (
        "wall_s", "e2e_median_s", "e2e_p90_s", "per_agent", "instances",
        "host_s_by_part")}
    del wf
    release_pools()
    wf, ids, results, _, t0, wall, _, events = run_workflow(
        model, params, seed, WF_TASKS, profile=True)
    require(len(results) == len(ids), "profiled run incomplete")
    busy = device_busy(events, wall)
    require(busy is not None, "the profiler saw no device activity")
    # the profiler slows the host: read the busy time against the
    # unprofiled runs' wall times too
    for key, w in (("pipelined", out["wall_s"]),
                   ("serial_loop", out["serial_loop"]["wall_s"])):
        busy[f"idle_share_of_unprofiled_{key}_wall"] = max(
            0.0, 1.0 - busy["device_busy_s"] / w)
    out["profiled"] = busy
    del wf, events, model, params
    release_pools()

    cfg32 = dataclasses.replace(cfg, num_layers=4, dtype="float32")
    model32, params32 = served(cfg32, seed)
    wf, ids, results, calls, t0, wall, _, _ = run_workflow(
        model32, params32, seed, WF_CHECK_TASKS)
    check = workflow_report(wf, ids, results, t0, wall, cfg32.vocab_size)
    require(len(calls) == 2 * WF_CHECK_TASKS, f"{len(calls)} LLM calls")
    out["float32_check"] = {"layers": cfg32.num_layers, "tasks": len(ids),
                            **replay_check(model32, params32, calls)}
    out["float32_check"]["e2e_median_s"] = check["e2e_median_s"]
    return out


# =============================================================================
# phase 6: the elastic, disaggregated and shedding cluster
# =============================================================================

EL_BLOCKS = 2048          # per instance of the cluster runs: 3.76 GB pools
EL_OOP_BLOCKS = 512       # the out-of-place pool: 0.94 GB copied per step
EL_SHED_TASKS = 32
EL_SHED_SLO_S = 8.0
EL_AUTOSCALE = dict(min_instances=1, max_instances=3, queue_high=2.0,
                    queue_low=0.5, up_patience=2, down_patience=3,
                    decision_period_s=0.2, cooldown_s=0.2)


def el_cluster(model, params, **cfg):
    """A ``ServingCluster.from_config`` of full-width-like instances:
    2048 blocks of 16 tokens, 16 sequences, prefix cache, 512-token
    chunks, FCFS; ``cfg`` overrides any of it and adds cluster kwargs
    (``clock``, ``tracer``, ``pipelined``, ``faults``) and the runners'
    ``backend``."""
    from repro_torch.core import HardwareProfile, Orchestrator
    from repro_torch.serving import (
        ServingCluster,
        ServingConfig,
        reset_request_ids,
    )
    kw = {k: cfg.pop(k) for k in ("clock", "tracer", "pipelined", "backend",
                                  "faults") if k in cfg}
    config = dict(n_instances=2, num_blocks=EL_BLOCKS, block_size=16,
                  max_batch=16, prefix_caching=True, prefill_chunk_tokens=512,
                  policy="fcfs")
    config.update(cfg)
    config = ServingConfig(**config)
    reset_request_ids()
    orch = Orchestrator(hardware=HardwareProfile(
        kv_capacity_tokens=config.kv_capacity_tokens))
    return ServingCluster.from_config(model, params, orch, config,
                                      device=DEVICE, **kw)


def cluster_run(cluster, reqs, on_step=None, max_steps: int = 20000):
    """Submit ``reqs`` at once and step until drained; ``on_step(cluster,
    step)`` runs after every step.  Returns (finished, steps, wall s)."""
    import torch
    t0 = time.perf_counter()
    for r in reqs:
        r.arrival_time = cluster.clock()
        cluster.submit(r)
    done, steps = [], 0
    while cluster.has_work:
        require(steps < max_steps, "cluster did not drain")
        done.extend(cluster.step())
        steps += 1
        if on_step is not None:
            on_step(cluster, steps)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    cluster.close()
    return done, steps, time.perf_counter() - t0


def all_requests(mod, seed: int, vocab: int):
    first, second = make_requests(mod, seed, vocab)
    return first + second


def streams_of(done):
    return {r.msg_id: [int(t) for t in r.output_tokens] for r in done}


def divergences(got, want) -> int:
    """Streams of ``got`` that differ from ``want`` anywhere."""
    require(set(got) == set(want), "different requests finished")
    return sum(got[m] != want[m] for m in want)




class Probe:
    """Wraps ``module.name`` so each call records its result, host
    seconds (the device synced at the end) and ``extra(result, args)``."""

    def __init__(self, module, name: str, extra=None):
        self.module, self.name, self.extra = module, name, extra
        self.orig = getattr(module, name)
        self.calls = []

        def probed(*a, **kw):
            import torch
            t = time.perf_counter()
            out = self.orig(*a, **kw)
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            rec = {"s": time.perf_counter() - t}
            if self.extra is not None:
                rec.update(self.extra(out, a))
            self.calls.append(rec)
            return out

        setattr(module, name, probed)

    def close(self):
        setattr(self.module, self.name, self.orig)


def tpot_median(done) -> float:
    return statistics.median((r.finish_time - r.first_token_time)
                             / max(1, r.output_len - 1) for r in done)


def el_legacy(model, params, seed: int, vocab: int) -> dict:
    """The legacy per-chunk engine drains the drain phase's requests."""
    from repro_torch import serving
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.kernels.ragged_attention import ragged_segment_attention
    runner = runner_for(model, params)
    eng = engine_for(runner, fused=False)
    p0 = paged_attention.launches
    r0 = ragged_segment_attention.launches
    done, iters, addrs, wall, _ = drain(eng, make_requests(serving, seed,
                                                           vocab))
    require(len(done) == 16, f"legacy: {len(done)} of 16 finished")
    require(all(len(r.output_tokens) == 32 for r in done),
            "legacy: short streams")
    require(len(addrs) == 1, "legacy: the in-place pool moved")
    paged = paged_attention.launches - p0
    require(paged > 0, "legacy: decode_batch never launched the kernel")
    require(ragged_segment_attention.launches == r0,
            "legacy: the per-chunk path launched the ragged kernel")
    return {"requests": len(done), "iterations": iters,
            "dispatches": runner.n_dispatches,
            "dispatches_per_iteration": runner.n_dispatches / iters,
            "wall_s": wall, "tpot_median_s": tpot_median(done),
            "ttft_median_s": statistics.median(
                r.first_token_time - r.arrival_time for r in done),
            "paged_launches_from_decode_batch": paged,
            "jit_cache_size": runner.jit_cache_size()}


def el_out_of_place(model, params, seed: int, vocab: int) -> dict:
    """``donate_pool=False`` at 512 blocks against the in-place pool on
    the same 8 requests: the address moves at every step, the copied
    bytes are counted, and the bf16 streams are equal bit for bit."""
    from repro_torch import serving
    runs = {}
    for donate in (True, False):
        runner = runner_for(model, params, num_blocks=EL_OOP_BLOCKS,
                            donate_pool=donate)
        eng = engine_for(runner)
        first, second = make_requests(serving, seed, vocab)
        seq = [runner.pool_address()]
        done, iters, _, wall, _ = drain(eng, (first, second[:4]),
                                        addr_seq=seq)
        require(len(done) == 8, f"out-of-place: {len(done)} of 8 finished")
        moved = sum(a != b for a, b in zip(seq, seq[1:]))
        snap = runner.metrics_snapshot()
        runs[donate] = {"iterations": iters, "wall_s": wall,
                        "steps_that_moved_the_pool": moved,
                        "pool_bytes": snap["pool_bytes"],
                        "pool_bytes_copied": snap.get("pool_bytes_copied",
                                                      0.0),
                        "n_preempted": eng.stats.n_preempted,
                        "streams": streams_of(done)}
        del runner, eng
        release_pools()
    inplace, copied = runs[True], runs[False]
    require(inplace["steps_that_moved_the_pool"] == 0,
            "the in-place pool moved")
    require(copied["steps_that_moved_the_pool"] == copied["iterations"],
            "the out-of-place pool stayed put at some step")
    require(copied["pool_bytes_copied"] >= copied["iterations"]
            * copied["pool_bytes"], "copied bytes under one pool a step")
    require(copied["streams"] == inplace["streams"],
            "out-of-place bf16 streams differ from the in-place run's")
    for r in runs.values():
        r.pop("streams")
    return {"num_blocks": EL_OOP_BLOCKS, "requests": 8,
            "bytes_copied_per_iteration": copied["pool_bytes_copied"]
            / copied["iterations"],
            "in_place": inplace, "out_of_place": copied,
            "bf16_streams_equal": True}


def el_migration(model, params, seed: int, vocab: int, tracer,
                 pipelined=True, backend=None):
    """A 2-instance cluster drains the 16 requests and retires instance 1
    once one of its requests has 4 tokens, checking the moved blocks
    read back bit-equal from the target's pool.  Returns (report,
    streams)."""
    from repro_torch import serving
    migration = importlib.import_module("repro_torch.serving.migration")
    cluster = el_cluster(model, params, tracer=tracer, pipelined=pipelined,
                         backend=backend)
    rec = {}

    def extra(out, args):
        source, target = args[:2]
        snaps, skipped = out
        return {"snaps": snaps, "target": target, "skipped": len(skipped),
                "source_pool": source.runner.pool_address(),
                "target_pool": target.runner.pool_address()}

    def on_step(c, step):
        if rec or len(c.engines) < 2:
            return
        e1 = c._by_id[1]
        if not any(r.output_len >= 4 for r in e1.sched.running):
            return
        rec["running"] = len(e1.sched.running)
        rec["waiting"] = len(e1.sched.waiting)
        rec["pools_before"] = {e.instance_id: e.runner.pool_address()
                               for e in c.engines}
        rec["target_dispatches_before"] = c._by_id[0].runner.n_dispatches
        probe = Probe(migration, "migrate_many", extra)
        try:
            t = time.perf_counter()
            c.scale_down(1)
            rec["scale_down_s"] = time.perf_counter() - t
        finally:
            probe.close()
        rec["calls"] = probe.calls
        rec["step"] = step
        rec["target_pool_after"] = c._by_id[0].runner.pool_address()
        # the moved blocks, read back from the target's pool before it
        # steps again, against the snapshots' bits
        rec["read_back_equal"] = all(
            np.array_equal(call["target"].runner.read_blocks(
                call["target"].bm.block_table(s.req.req_id)[
                    s.n_cached_blocks:call["target"].bm.blocks_needed(
                        s.n_resident_tokens)]),
                s.kv[:, :, s.n_cached_blocks:call["target"].bm.blocks_needed(
                    s.n_resident_tokens)])
            for call in probe.calls for s in call["snaps"])

    done, steps, wall = cluster_run(cluster,
                                    all_requests(serving, seed, vocab),
                                    on_step)
    require(len(done) == 16, f"migration: {len(done)} of 16 finished")
    require(rec, "instance 1 never had a request 4 tokens in")
    calls = rec.pop("calls")
    require(len(calls) == 1, f"{len(calls)} migrate_many calls for one target")
    call = calls[0]
    moved = len(call["snaps"])
    require(moved == rec["running"] and call["skipped"] == 0,
            f"moved {moved} of {rec['running']} running requests")
    require(rec["read_back_equal"],
            "migrated blocks read back unequal to the snapshot bits")
    require(call["source_pool"] == rec["pools_before"][1]
            and call["target_pool"] == rec["pools_before"][0]
            == rec["target_pool_after"], "a pool moved during migration")
    snap = cluster.metrics_snapshot()
    require(snap["migration_dispatches"] == 1,
            f"{snap['migration_dispatches']} write dispatches for one target")
    return ({"requests": len(done), "steps": steps, "wall_s": wall,
             "scaled_down_at_step": rec["step"],
             "migrated_requests": int(snap["n_migrations"]),
             "requeued_waiting": rec["waiting"],
             "migrated_bytes": int(snap["migrated_bytes"]),
             "migration_dispatches": int(snap["migration_dispatches"]),
             "transfer_s": call["s"], "scale_down_s": rec["scale_down_s"],
             "pool_addresses_stable": True,
             "blocks_read_back_bit_equal": True},
            streams_of(done))


def el_unmigrated(model, params, seed: int, vocab: int, pipelined=True,
                  margins=None, backend=None):
    """The 16 requests on a 2-instance general cluster, never resized: the
    migration run's and the disaggregated run's baseline.  With
    ``margins`` (a list), the serial loop records the runners' margins
    into it."""
    from repro_torch import serving
    cluster = el_cluster(model, params, pipelined=pipelined, backend=backend)
    if margins is not None:
        require(not pipelined, "margins need the serial loop")
        log, undo = record_margins(*(e.runner for e in cluster.engines))
        margins.append(log)
    try:
        done, _, wall = cluster_run(cluster,
                                    all_requests(serving, seed, vocab))
    finally:
        if margins is not None:
            undo()
    require(len(done) == 16, "unmigrated run incomplete")
    return streams_of(done), wall


def el_disagg(model, params, seed: int, vocab: int, pipelined=True):
    """Instance 0 prefills, instance 1 decodes every request; each sweep
    that hands requests over spends one ``write_blocks``."""
    from repro_torch import serving
    # the module (the package exports a function of the same name)
    handoff = importlib.import_module("repro_torch.serving.handoff")
    cluster = el_cluster(model, params, pipelined=pipelined,
                         roles=("prefill", "decode"))
    probe = Probe(handoff, "drive_handoffs", lambda out, a: dict(out))
    try:
        done, steps, wall = cluster_run(cluster,
                                        all_requests(serving, seed, vocab))
    finally:
        probe.close()
    require(len(done) == 16, f"disaggregation: {len(done)} of 16 finished")
    require(all(r.instance_id == 1 for r in done),
            "a request finished off the decode instance")
    snap = cluster.metrics_snapshot()
    require(snap["n_handoffs"] == 16 and snap["n_stranded"] == 0,
            f"{snap['n_handoffs']} handoffs, {snap['n_stranded']} stranded")
    require(snap["prefill0.n_admitted"] == 16
            and snap["decode1.n_finished"] == 16,
            "every request must be prefilled on 0 and decoded on 1")
    sweeps = [c for c in probe.calls if c["n_handoffs"]]
    require(all(c["handoff_dispatches"] == 1 for c in sweeps),
            "a (source, target) sweep spent more than one dispatch")
    return ({"requests": len(done), "steps": steps, "wall_s": wall,
             "handoffs": int(snap["n_handoffs"]),
             "handoff_bytes": int(snap["handoff_bytes"]),
             "handoff_dispatches": int(snap["handoff_dispatches"]),
             "sweeps_with_handoffs": len(sweeps),
             "dispatches_per_sweep": 1,
             "handoff_s": sum(c["s"] for c in sweeps),
             "handoff_s_max_sweep": max(c["s"] for c in sweeps),
             "tpot_median_s": tpot_median(done)},
            streams_of(done))


def el_autoscale(model, params, seed: int, vocab: int) -> dict:
    """A 1-instance cluster (4 sequences an instance) with an autoscaler
    bounded to 1-3 takes the 16 requests at once on a clock that
    advances 0.25 s a step: it grows, then shrinks back through
    migration once calm, and every request finishes."""
    from repro_torch import serving
    from repro_torch.serving import Autoscaler, AutoscalerConfig
    t = {"now": 0.0}
    cluster = el_cluster(model, params, n_instances=1, max_batch=4,
                         clock=lambda: t["now"])
    cluster.attach_autoscaler(Autoscaler(AutoscalerConfig(**EL_AUTOSCALE)))
    peak = [1]

    def on_step(c, step):
        t["now"] += 0.25
        peak[0] = max(peak[0], c.n_instances)

    reqs = all_requests(serving, seed, vocab)
    done, steps, wall = cluster_run(cluster, reqs, on_step)
    for _ in range(200):                  # the calm tail
        if cluster.n_instances == 1:
            break
        t["now"] += 0.25
        done.extend(cluster.step())
    cluster.close()
    hist = cluster.autoscaler.history
    snap = cluster.metrics_snapshot()
    require(sorted(r.msg_id for r in done) == sorted(r.msg_id for r in reqs),
            "the autoscaled cluster lost or duplicated a request")
    require(any(k == "up" for _, k, _, _ in hist), f"never scaled up: {hist}")
    require(any(k == "down" for _, k, _, _ in hist) and
            cluster.n_instances == 1, f"never shrank back: {hist}")
    require(snap["n_migrations"] >= 1, "scale-down migrated nothing")
    return {"requests": len(done), "steps": steps, "wall_s": wall,
            "config": EL_AUTOSCALE, "peak_instances": peak[0],
            "history": [[round(ts, 2), k, iid, n] for ts, k, iid, n in hist],
            "migrated_requests": int(snap["n_migrations"]),
            "migrated_bytes": int(snap["migrated_bytes"]),
            "migration_dispatches": int(snap["migration_dispatches"])}


def shed_requests(mod, seed: int, vocab: int):
    """The QA experts' calls of the workflow phase, 32 at once: a
    1024-token system prompt per expert, questions of 64-512 tokens, 64
    new tokens."""
    rng = np.random.default_rng(seed)
    system = {a: rng.integers(0, vocab, WF_SYSTEM[a]).astype(np.int32)
              for a in ("MathAgent", "HumanitiesAgent")}
    out = []
    for i in range(EL_SHED_TASKS):
        a = ("MathAgent", "HumanitiesAgent")[i % 2]
        q = rng.integers(0, vocab, int(rng.integers(*WF_QUESTION)))
        toks = np.concatenate([system[a], q]).astype(np.int32)
        out.append(mod.Request(agent_name=a, msg_id=f"s{i:02d}",
                               prompt_len=len(toks), prompt_tokens=toks,
                               max_new_tokens=WF_NEW[a],
                               shared_prefix_len=WF_SYSTEM[a]))
    return out


def el_shed(model, params, seed: int, vocab: int) -> dict:
    """One instance, ``slo_e2e_s`` of EL_SHED_SLO_S seconds, the 32-call
    burst: the valve opens, sheds, and every call not shed completes."""
    from repro_torch import serving
    cluster = el_cluster(model, params, n_instances=1,
                         slo_e2e_s=EL_SHED_SLO_S)
    reqs = shed_requests(serving, seed, vocab)
    done, steps, wall = cluster_run(cluster, reqs)
    require(sorted(r.msg_id for r in done) == sorted(r.msg_id for r in reqs),
            "the shedding cluster lost or duplicated a request")
    shed = [r for r in done if r.state is serving.RequestState.SHED]
    served_ok = [r for r in done if r.state is not serving.RequestState.SHED]
    require(shed, "the burst never opened the valve")
    require(all(r.output_len == r.max_new_tokens for r in served_ok),
            "a request that was not shed did not complete")
    in_slo = [r for r in served_ok
              if r.finish_time - r.arrival_time <= EL_SHED_SLO_S]
    return {"requests": len(reqs), "slo_e2e_s": EL_SHED_SLO_S,
            "steps": steps, "wall_s": wall, "shed": len(shed),
            "completed": len(served_ok), "completed_in_slo": len(in_slo),
            "goodput": len(in_slo) / len(reqs),
            "e2e_median_completed_s": statistics.median(
                r.finish_time - r.arrival_time for r in served_ok)
            if served_ok else None}


def el_export(tracer) -> dict:
    """The migration run's trace through the Chrome-trace export and the
    loss-free dict round trip."""
    from repro_torch.obs import (
        events_from_dicts,
        events_to_dicts,
        to_chrome_trace,
        validate_chrome_trace,
    )
    events = tracer.events()
    require(events, "the tracer recorded nothing")
    back = events_from_dicts(json.loads(json.dumps(events_to_dicts(events))))
    require([tuple(e) for e in back] == [tuple(e) for e in events],
            "the event round trip lost something")
    trace = to_chrome_trace(events, dropped=tracer.dropped())
    problems = validate_chrome_trace(trace)
    require(not problems, f"invalid Chrome trace: {problems[:3]}")
    kinds = {}
    for e in events:
        kinds[e.kind] = kinds.get(e.kind, 0) + 1
    return {"events": len(events), "dropped": tracer.dropped(),
            "trace_events": len(trace["traceEvents"]),
            "by_kind": dict(sorted(kinds.items()))}


def phase_elastic(state, seed: int):
    import torch
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.kernels.ragged_attention import ragged_segment_attention
    from repro_torch.obs import Tracer
    release_pools()
    cfg = full_config()
    model, params = served(cfg, seed)
    vocab = cfg.vocab_size
    torch.cuda.reset_peak_memory_stats()
    paged_attention.launches = 0
    ragged_segment_attention.launches = 0
    out = {"model": "qwen3-1.7b", "layers": cfg.num_layers,
           "dtype": cfg.dtype, "card": state["smi"]}
    tracer = Tracer()

    def counted(key, run):
        """Run one part; its report gains the kernel launches it made."""
        before = (paged_attention.launches,
                  ragged_segment_attention.launches)
        result = run()
        report = result[0] if isinstance(result, tuple) else result
        report["kernel_launches"] = {
            "paged_attention": paged_attention.launches - before[0],
            "ragged_segment_attention":
                ragged_segment_attention.launches - before[1]}
        out[key] = report
        release_pools()
        return result

    counted("legacy", lambda: el_legacy(model, params, seed, vocab))
    out["legacy"]["fused_dispatches_per_iteration"] = state[
        "fused_dispatches_per_iteration"]
    counted("out_of_place",
            lambda: el_out_of_place(model, params, seed, vocab))
    _, migrated = counted("migration", lambda: el_migration(
        model, params, seed, vocab, tracer))
    unmigrated, wall = el_unmigrated(model, params, seed, vocab)
    release_pools()
    out["migration"]["bf16_streams_diverged_from_unmigrated"] = divergences(
        migrated, unmigrated)
    out["migration"]["unmigrated_wall_s"] = wall
    # the same pair on the plain versions of both kernels: if its streams
    # also diverge, the kernels are not what makes migrated rows differ
    _, migrated = el_migration(model, params, seed, vocab, Tracer(),
                               backend="ref")
    release_pools()
    unmigrated, _ = el_unmigrated(model, params, seed, vocab, backend="ref")
    release_pools()
    out["migration"]["ref_bf16_streams_diverged_from_unmigrated"] = (
        divergences(migrated, unmigrated))
    counted("disaggregation",
            lambda: el_disagg(model, params, seed, vocab))
    counted("autoscaler", lambda: el_autoscale(model, params, seed, vocab))
    counted("shedder", lambda: el_shed(model, params, seed + 3, vocab))
    launches = {"paged_attention": paged_attention.launches,
                "ragged_segment_attention": ragged_segment_attention.launches}
    state["elastic_launches"] = launches
    require(min(launches.values()) > 0, f"a kernel never launched: {launches}")
    out["kernel_launches"] = launches
    out["export"] = el_export(tracer)
    out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del model, params, tracer
    release_pools()

    # float32 at 4 layers: legacy against fused, migrated against
    # unmigrated, disaggregated against colocated, under the margin rule
    cfg32 = dataclasses.replace(cfg, num_layers=4, dtype="float32")
    model32, params32 = served(cfg32, seed)
    from repro_torch import serving
    fused_runner = runner_for(model32, params32)
    log, undo = record_margins(fused_runner)
    try:
        fused = drain(engine_for(fused_runner),
                      make_requests(serving, seed, cfg32.vocab_size))[0]
    finally:
        undo()
    want, margins = streams_and_margins(fused, log, 32)
    legacy = drain(engine_for(runner_for(model32, params32), fused=False),
                   make_requests(serving, seed, cfg32.vocab_size))[0]
    check = {"layers": 4, "legacy_vs_fused": margin_rule(
        streams_of(legacy), want, margins, "legacy")}
    del fused_runner
    release_pools()
    logs = []
    want, _ = el_unmigrated(model32, params32, seed, cfg32.vocab_size,
                            pipelined=False, margins=logs)
    margins = streams_and_margins([], logs[0], 32)[1]
    _, got = el_migration(model32, params32, seed, cfg32.vocab_size,
                          Tracer(), pipelined=False)
    check["migrated_vs_unmigrated"] = margin_rule(got, want, margins,
                                                  "migrated")
    release_pools()
    logs = []
    want, _ = el_unmigrated(model32, params32, seed, cfg32.vocab_size,
                            pipelined=False, margins=logs)
    margins = streams_and_margins([], logs[0], 32)[1]
    _, got = el_disagg(model32, params32, seed, cfg32.vocab_size,
                       pipelined=False)
    check["disaggregated_vs_colocated"] = margin_rule(got, want, margins,
                                                      "disaggregated")
    out["float32_check"] = check
    return out


# =============================================================================
# phase 7: the MoE family at full width (qwen2-moe-a2.7b)
# =============================================================================

# the parameters the reference's init_moe / init_ffn layout gives the full
# config: 24 layers of 570,552,320, two 311,164,928-entry embedding
# tables, the final norm
MOE_PARAMS = 14_315_587_584


def moe_config():
    """qwen2-moe-a2.7b at its published widths and depth."""
    from repro_torch.configs import get_config
    cfg = get_config("qwen2-moe-a2.7b")
    m = cfg.moe
    require(cfg.num_layers == 24 and cfg.d_model == 2048
            and (cfg.num_heads, cfg.num_kv_heads) == (16, 16)
            and cfg.resolved_head_dim == 128 and cfg.vocab_size == 151_936
            and not cfg.tie_embeddings and cfg.dtype == "bfloat16"
            and (m.num_experts, m.top_k, m.d_expert, m.d_shared) == (
                60, 4, 1408, 5632) and m.capacity_factor == 1.25,
            "not the full-width qwen2-moe-a2.7b")
    return cfg


def count_params(tree) -> int:
    return sum(count_params(v) if isinstance(v, dict) else v.numel()
               for v in tree.values())


class MoeHook:
    """Wraps the MoE FFN (``models.model.moe_ffn``, which the runner's
    steps and the model's reach through ``ffn_block``) and, given a
    ``runner``, the runner's steps.  Each call adds the expert
    assignments of real rows that capacity dropped (``dropped``, a device
    count) and all of theirs (``assigned``).  With ``ties``, each fused
    step also records, per real segment, whether some row of it had a
    top-k routing gap below ROUTE_GAP in some layer (one dict a step, in
    step order, as ``record_margins`` logs).  Real rows: on the fused
    path those with a write slot in the pool; on the legacy path every
    prefill row and the live decode rows; outside a runner every row."""

    def __init__(self, runner=None, ties: bool = False):
        import torch
        from repro_torch.models import model as model_mod
        self.runner, self.rows, self.gap = runner, None, None
        self.dropped = torch.zeros((), dtype=torch.int64, device=DEVICE)
        self.assigned = torch.zeros((), dtype=torch.int64, device=DEVICE)
        self.ties = [] if ties else None
        self.saved = [(model_mod, "moe_ffn", model_mod.moe_ffn)]
        model_mod.moe_ffn = self.moe(model_mod.moe_ffn)
        if runner is not None:
            self.saved += [(runner, n, getattr(runner, n))
                           for n in ("run_iteration", "decode_batch")]
            runner.run_iteration = self.fused(runner.run_iteration)
            runner.decode_batch = self.legacy_decode(runner.decode_batch)

    def moe(self, orig):
        import torch
        from repro_torch.models import moe as moe_mod

        def hooked(p, x, cfg):
            xf = x.reshape(-1, x.shape[-1])
            n, k = xf.shape[0], cfg.moe.top_k
            probs, _, idx = moe_mod.route(p, xf, cfg)
            order, _, keep, _ = moe_mod.dispatch(idx, n, cfg)
            real = (self.rows if self.rows is not None
                    else torch.ones(n, dtype=torch.bool, device=x.device))
            self.dropped += (~keep & real[order // k]).sum()
            self.assigned += real.sum() * k
            if self.ties is not None:
                top = probs.topk(k + 1, dim=-1).values
                gap = top[:, k - 1] - top[:, k]
                self.gap = gap if self.gap is None else torch.minimum(
                    self.gap, gap)
            return orig(p, x, cfg)
        return hooked

    def fused(self, orig):
        import torch

        def run(batch):
            n_slots = self.runner.num_blocks * self.runner.block_size
            slots = np.asarray(batch.write_slots)
            self.rows = torch.as_tensor(slots < n_slots,
                                        device=self.runner.device)
            self.gap = None
            try:
                return orig(batch)
            finally:
                if self.ties is not None:
                    self.ties.append(self.segment_ties(batch))
                self.rows = None
        return run

    def segment_ties(self, batch) -> dict:
        """msg -> whether some real row of the segment had a near-tie."""
        near = (self.gap < ROUTE_GAP).cpu().numpy() & (self.rows.cpu().numpy())
        sp, lmax = np.shape(batch.tokens_p)
        prefill = [s for s in batch.segments if s.kind != "decode"]
        out = {}
        for j, seg in enumerate(prefill):
            out[seg.req.msg_id] = bool(near[j * lmax:(j + 1) * lmax].any())
        decode = [s for s in batch.segments if s.kind == "decode"]
        for i, seg in enumerate(decode):
            out[seg.req.msg_id] = bool(near[sp * lmax + i])
        return out

    def legacy_decode(self, orig):
        import torch

        def run(tokens, positions, block_tables, live):
            self.rows = torch.as_tensor(np.asarray(live, bool),
                                        device=self.runner.device)
            try:
                return orig(tokens, positions, block_tables, live)
            finally:
                self.rows = None
        return run

    def routing_flags(self, margin_log, max_new: int) -> dict:
        """msg -> per emitted token, whether a near-tie had been seen in
        that sequence by then (``margin_log`` from ``record_margins``)."""
        seen, flags = {}, {}
        for (segs, _, _), ties in zip(margin_log, self.ties):
            for msg, emits in segs:
                seen[msg] = seen.get(msg, False) or ties.get(msg, False)
                if emits:
                    flags.setdefault(msg, []).append(seen[msg])
        return {k: v[:max_new] for k, v in flags.items()}

    def close(self) -> int:
        for obj, name, f in self.saved:
            setattr(obj, name, f)
        return int(self.dropped)


def moe_profile(runner, seed: int, vocab: int, wall: float):
    """One profiled replay of the fused drain: the device's busy time, the
    MoE FFN's share of it (the kernels launched inside ``moe_ffn``:
    router, sort and scatter, expert products, combine, shared FFN)
    against the two attention kernels and the rest, and kernel launches
    an iteration."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch import serving
    from repro_torch.models import model as model_mod
    orig = model_mod.moe_ffn

    def annotated(p, x, cfg):
        with record_function("moe_ffn"):
            return orig(p, x, cfg)

    model_mod.moe_ffn = annotated
    try:
        eng = engine_for(runner.clone())
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            replay = drain(eng, make_requests(serving, seed, vocab))
    finally:
        model_mod.moe_ffn = orig
    events = prof.events()
    busy = device_busy(events, replay[3], ranges=("moe_ffn",))
    require(busy is not None, "the profiler saw no device activity")
    moe_us = sum(getattr(e, "device_time_total", None)
                 or getattr(e, "cuda_time_total", 0) for e in events
                 if e.name == "moe_ffn" and e.device_type == DeviceType.CPU)
    shares = busy["busy_share_by_kernel"]
    attn = (shares.get("paged_attention", 0.0)
            + shares.get("ragged_segment_attention", 0.0))
    moe = moe_us * 1e-6 / busy["device_busy_s"]
    busy["busy_share"] = {"moe_ffn": moe, "attention_kernels": attn,
                          "rest": 1.0 - moe - attn}
    busy["kernel_launches_per_iteration"] = sum(
        e.count for e in prof.key_averages()
        if e.key == "cudaLaunchKernel") / replay[1]
    busy["idle_share_of_unprofiled_wall"] = max(
        0.0, 1.0 - busy["device_busy_s"] / wall)
    return busy


def phase_moe(state, seed: int):
    import torch
    from repro_torch import serving
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.kernels.ragged_attention import ragged_segment_attention
    release_pools()
    cfg = moe_config()
    torch.cuda.reset_peak_memory_stats()
    model, params = served(cfg, seed)
    n_params = count_params(params)
    require(n_params == MOE_PARAMS, f"{n_params} parameters built")
    vocab = cfg.vocab_size
    parts, t_part = {}, [time.perf_counter()]

    def part(name):
        now = time.perf_counter()
        parts[name] = now - t_part[0]
        t_part[0] = now

    # warm-up: one request (cuBLAS handles, the allocator)
    drain(engine_for(runner_for(model, params)),
          (make_requests(serving, seed + 1, vocab)[0][:1], []))
    release_pools()
    part("init_and_warm_up")

    def launches():
        return {"paged_attention": paged_attention.launches,
                "ragged_segment_attention": ragged_segment_attention.launches}

    out = {"model": "qwen2-moe-a2.7b", "layers": cfg.num_layers,
           "dtype": cfg.dtype, "parameters_built": n_params,
           "param_count_of_config": cfg.param_count(), "card": state["smi"]}
    for path, fused in (("fused", True), ("legacy", False)):
        runner = runner_for(model, params)
        paged_attention.launches = 0
        ragged_segment_attention.launches = 0
        eng = engine_for(runner, fused=fused)
        done, iters, addrs, wall, _ = drain(eng, make_requests(serving, seed,
                                                               vocab))
        counts = launches()
        require(len(done) == 16, f"moe {path}: {len(done)} of 16 finished")
        for r in done:
            require(len(r.output_tokens) == 32 and all(
                0 <= int(t) < vocab for t in r.output_tokens),
                f"moe {path} {r.msg_id}: bad output")
        require(len(addrs) == 1, f"moe {path}: the pool moved")
        require(counts["paged_attention"] > 0,
                f"moe {path}: the paged kernel never launched")
        require((counts["ragged_segment_attention"] > 0) == fused,
                f"moe {path}: ragged launches {counts}")
        require(max(counts.values()) <= cfg.num_layers * iters,
                f"moe {path}: more than one launch per layer and iteration")
        if fused:
            require(runner.n_dispatches == iters,
                    f"{runner.n_dispatches} dispatches for {iters} "
                    "iterations")
            state["moe_launches"] = counts
        generated = sum(r.output_len for r in done)
        out[path] = {
            "requests": len(done), "iterations": iters,
            "dispatches_per_iteration": runner.n_dispatches / iters,
            "wall_s": wall, "generated_tokens": generated,
            "tokens_per_s": generated / wall,
            "ttft_median_s": statistics.median(
                r.first_token_time - r.arrival_time for r in done),
            "tpot_median_s": tpot_median(done),
            "prefill_tokens_saved": eng.stats.prefill_tokens_saved,
            "kernel_launches": counts,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
        part(path)
        # the same traffic again, counting the assignments capacity drops
        hook = MoeHook(runner)
        try:
            replay = drain(engine_for(runner, fused=fused),
                           make_requests(serving, seed, vocab))[0]
        finally:
            out[path]["assignments_dropped_real_rows"] = hook.close()
        out[path]["assignments_real_rows"] = int(hook.assigned)
        require(streams_of(replay) == streams_of(done),
                f"moe {path}: the counting replay changed the streams")
        part(f"{path}_counting_replay")
        if fused:
            out["pool_bytes"] = runner.metrics_snapshot()["pool_bytes"]
            out["profiled"] = moe_profile(runner, seed, vocab, wall)
            part("profiled_replay")
        del eng, done, replay, runner
        release_pools()
    del model, params
    release_pools()

    # float32 at 4 layers of full width: the CUDA kernels against the
    # plain versions, under the margin rule and its routing extension
    cfg32 = dataclasses.replace(cfg, num_layers=4, dtype="float32")
    model32, params32 = served(cfg32, seed)
    runs = {}
    for backend in ("cuda", "ref"):
        runner = runner_for(model32, params32, backend)
        log, undo = record_margins(runner)
        hook = MoeHook(runner, ties=backend == "ref")
        try:
            done = drain(engine_for(runner),
                         make_requests(serving, seed, cfg32.vocab_size))[0]
        finally:
            hook.close()
            undo()
        streams, margins = streams_and_margins(done, log, 32)
        runs[backend] = (streams, margins,
                         hook.routing_flags(log, 32) if hook.ties is not None
                         else None)
        del runner
        release_pools()
    out["float32_check"] = {"layers": cfg32.num_layers, **margin_rule(
        runs["cuda"][0], runs["ref"][0], runs["ref"][1], "moe cuda",
        routing=runs["ref"][2])}
    part("float32_check")
    out["seconds_by_part"] = parts
    return out


# =============================================================================
# phase 8: every other family of the registry on the card
# =============================================================================

FAM_BLOCKS = 1024
# arch, layers on the card (None: full depth), how it runs
FAMILIES = (
    ("llama3.2-3b", None, "served"),
    ("stablelm-3b", None, "served"),
    ("chameleon-34b", 4, "served"),
    ("gemma3-27b", 6, "model"),
    ("rwkv6-3b", 2, "model"),
    ("jamba-v0.1-52b", 8, "model"),
    ("seamless-m4t-large-v2", None, "model"),
)
# model-level prompts: (batch, prompt tokens, encoder frames); gemma3's
# passes its 1024-token window; jamba's 7 + 1 tokens keep every MoE call at
# 8 rows or fewer, where capacity (at least 8) can drop nothing, so decode
# and the one-longer prefill route alike; its 300-token prefill crosses two
# 128-token Mamba chunks
FAM_PROMPTS = {"gemma3-27b": (1, 1536, 0), "rwkv6-3b": (2, 100, 0),
               "jamba-v0.1-52b": (1, 7, 0),
               "seamless-m4t-large-v2": (2, 64, 128)}
JAMBA_LONG = 300


def cut(cfg, layers):
    """``cfg`` at ``layers`` layers (the layer pattern cut with it)."""
    if layers is None:
        return cfg
    pat = cfg.layer_pattern[:layers] if cfg.layer_pattern else None
    return dataclasses.replace(cfg, num_layers=layers, layer_pattern=pat)


def two_layers(cfg):
    """The float32 check's depth: 2 layers; a hybrid keeps one layer of
    each kind, as ``reduced()`` does."""
    if cfg.layer_pattern and len(set(cfg.layer_pattern)) > 1:
        return dataclasses.replace(cfg, num_layers=2,
                                   layer_pattern=("mamba", "attn"))
    return cut(cfg, 2)


def family_served(cfg, seed: int) -> dict:
    """bf16 drains of 8 requests, fused and legacy, then the float32
    identity of the CUDA kernels against the plain versions at 2 layers."""
    from repro_torch import serving
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.kernels.ragged_attention import ragged_segment_attention
    model, params = served(cfg, seed)
    out = {"parameters_built": count_params(params)}
    for path, fused in (("fused", True), ("legacy", False)):
        runner = runner_for(model, params, num_blocks=FAM_BLOCKS)
        before = (paged_attention.launches, ragged_segment_attention.launches)
        first, second = make_requests(serving, seed, cfg.vocab_size)
        done, iters, _, wall, _ = drain(engine_for(runner, fused=fused),
                                        (first, second[:4]))
        counts = (paged_attention.launches - before[0],
                  ragged_segment_attention.launches - before[1])
        require(len(done) == 8 and all(
            len(r.output_tokens) == 32
            and all(0 <= int(t) < cfg.vocab_size for t in r.output_tokens)
            for r in done), f"{cfg.name} {path}: bad drain")
        require(counts[0] > 0 and (counts[1] > 0) == fused,
                f"{cfg.name} {path}: launches {counts}")
        out[path] = {"iterations": iters, "wall_s": wall,
                     "dispatches_per_iteration": runner.n_dispatches / iters,
                     "tpot_median_s": tpot_median(done),
                     "kernel_launches": {"paged_attention": counts[0],
                                         "ragged_segment_attention":
                                             counts[1]}}
        del runner
        release_pools()
    del model, params
    release_pools()
    cfg32 = dataclasses.replace(two_layers(cfg), dtype="float32")
    model32, params32 = served(cfg32, seed)
    runs = {}
    for backend in ("cuda", "ref"):
        runner = runner_for(model32, params32, backend, num_blocks=FAM_BLOCKS)
        log, undo = record_margins(runner)
        try:
            first, second = make_requests(serving, seed, cfg.vocab_size)
            done = drain(engine_for(runner), (first, second[:4]))[0]
        finally:
            undo()
        runs[backend] = streams_and_margins(done, log, 32)
        del runner
        release_pools()
    out["float32_check"] = {"layers": 2, **margin_rule(
        runs["cuda"][0], runs["ref"][0], runs["ref"][1], cfg.name)}
    return out


def decode_vs_prefill(model, params, seed: int, batch: int, n: int,
                      n_frames: int, tol: float) -> dict:
    """Prefill n tokens, decode one more, and hold the decode logits to a
    prefill of all n + 1 (allclose at ``tol``, its absolute part scaled by
    the largest logit); every logit finite.  The longer prefill must drop
    no MoE assignment for capacity."""
    import torch
    cfg = model.cfg
    rng = np.random.default_rng(seed)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (batch, n + 1))
                           .astype(np.int32), device=DEVICE)
    extra = []
    if cfg.is_encdec:
        extra = [torch.as_tensor(rng.standard_normal(
            (batch, n_frames, cfg.d_model)).astype(np.float32),
            device=DEVICE)]
    logits, cache = model.prefill(params, toks[:, :n], *extra)
    if "kv" in cache:
        cache = dict(cache, kv=torch.nn.functional.pad(
            cache["kv"], (0, 0, 0, 0, 0, 1)))
    dec, new = model.decode_step(params, cache, toks[:, n:])
    hook = MoeHook()
    try:
        full, _ = model.prefill(params, toks, *extra)
    finally:
        hook.close()
    require(int(hook.dropped) == 0, f"{cfg.name}: the longer prefill "
            f"dropped {int(hook.dropped)} assignments")
    for t in (logits, dec, full):
        require(bool(torch.isfinite(t.float()).all()),
                f"{cfg.name}: non-finite logits")
    require(new["pos"] == n + 1, f"{cfg.name}: cache position")
    d, f = dec.float(), full.float()
    err = float((d - f).abs().max())
    scale = max(1.0, float(f.abs().max()))
    require(bool(((d - f).abs() <= tol * scale + tol * f.abs()).all()),
            f"{cfg.name}: decode vs prefill max abs err {err} (scale "
            f"{scale}) beyond {tol}")
    return {"batch": batch, "prompt": n, "frames": n_frames,
            "max_abs_err": err, "logit_scale": scale, "tol": tol}


def family_model(cfg, seed: int) -> dict:
    """bf16 at the phase's depth, then float32 at 2 layers: prefill,
    decode_step, and decode against the one-longer prefill."""
    import torch
    from repro_torch.models import build_model
    batch, n, frames = FAM_PROMPTS[cfg.name]
    out = {}
    for dtype, c, tol in (("bfloat16", cfg, 2e-2),
                          ("float32", two_layers(cfg), 1e-4)):
        c = dataclasses.replace(c, dtype=dtype)
        model = build_model(c)
        gen = torch.Generator(device=DEVICE).manual_seed(seed)
        params = model.init_params(gen, device=DEVICE)
        t0 = time.perf_counter()
        row = {"layers": c.num_layers,
               **decode_vs_prefill(model, params, seed, batch, n, frames,
                                   tol)}
        if dtype == "bfloat16":
            row["parameters_built"] = count_params(params)
            if cfg.name.startswith("jamba"):
                toks = torch.as_tensor(np.random.default_rng(seed).integers(
                    0, c.vocab_size, (1, JAMBA_LONG)).astype(np.int32),
                    device=DEVICE)
                logits, _ = model.prefill(params, toks)
                require(bool(torch.isfinite(logits.float()).all()),
                        "jamba: non-finite logits on the long prompt")
                row["long_prefill_tokens"] = JAMBA_LONG
        torch.cuda.synchronize()
        row["s"] = time.perf_counter() - t0
        out[dtype] = row
        del model, params
        release_pools()
    return out


def phase_families(state, seed: int):
    import torch
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.kernels.ragged_attention import ragged_segment_attention
    release_pools()
    paged_attention.launches = 0
    ragged_segment_attention.launches = 0
    out, cuts = {}, {}
    for arch, layers, kind in FAMILIES:
        full = get_config(arch)
        cfg = cut(full, layers)
        if layers is not None:
            cuts[arch] = f"{full.num_layers} -> {layers} layers"
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        row = (family_served if kind == "served" else family_model)(cfg, seed)
        row.update(kind=kind, layers=cfg.num_layers,
                   s=time.perf_counter() - t0,
                   peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
        out[arch] = row
    launches = {"paged_attention": paged_attention.launches,
                "ragged_segment_attention": ragged_segment_attention.launches}
    state["families_launches"] = launches
    require(min(launches.values()) > 0, f"a kernel never launched: {launches}")
    covered = {a for a, _, _ in FAMILIES} | {"qwen3-1.7b", "qwen2-moe-a2.7b"}
    off_card = sorted(set(ARCH_IDS) - covered)
    require(off_card == ["kimi-k2-1t-a32b"], f"not run: {off_card}")
    cuts["kimi-k2-1t-a32b"] = ("not run on the card: one MoE layer holds "
                               "16.9 B parameters; covered on the CPU by "
                               "tests/test_torch_families.py")
    return {"families": out, "cuts": cuts, "kernel_launches": launches,
            "card": state["smi"]}


# =============================================================================
# phase 9: training (no attention kernel: the model-level causal attention)
# =============================================================================

TRAIN_SEQ = 1024
TRAIN_BATCH = 4                   # qwen3-1.7b: 4096 tokens a step
TRAIN_STEPS = {"adam": 20, "adafactor": 10}
MOE_TRAIN_LAYERS = 4
MOE_TRAIN_BATCH = 2
MOE_TRAIN_STEPS = 5
TRAIN_TOL = 1e-4                  # card against CPU, float32, scaled
# rwkv6's float32 gradients round differently on the card and the CPU by
# 3.4e-4 of a leaf's scale here (every other arch: under 2e-6).  The
# rounding is the function's at these weights, not the card's: the CPU's
# float32 gradients lie 2.8e-4 from a float64 evaluation, ``jax.grad``'s
# 2.9e-4 (tests/test_torch_training.py, test_float32_gradients_as_far_
# from_float64_as_jax).  Held at 1e-3, and every arch's card gradients
# are held to the float64 ones no farther than FLOAT64_RATIO times the
# CPU's distance (or TRAIN_TOL).
TRAIN_TOL_BY_ARCH = {"rwkv6-3b": 1e-3}
FLOAT64_RATIO = 2.0
REDUCED_BATCH = (2, 32)
# the built tree, its 123,904 fp32 norm scales included
# (``ModelConfig.param_count()`` leaves them out: 1,720,451,072)
QWEN3_PARAMS = 1_720_574_976
BF16_PEAK = PEAK_OPS_PER_S["bfloat16"]


def model_flops(cfg, n_params: int, batch: int, seq: int) -> float:
    """Model FLOPs of one training step: 6 x parameters x tokens, plus
    causal attention's two products (forward 2 x B x S^2 x H x hd a
    layer with the mask's half, three times that with the backward)."""
    n_attn = len(cfg.attn_layer_indices)
    return (6.0 * n_params * batch * seq
            + 6.0 * batch * seq * seq * cfg.num_heads
            * cfg.resolved_head_dim * n_attn)


def active_params(params, cfg) -> int:
    """Parameters a token's step touches: every leaf, but of each routed
    expert stack only top_k of num_experts."""
    total = count_params(params)
    if cfg.moe is None:
        return total
    experts = sum(v.numel() for k, v in params["layers"]["moe"].items()
                  if k in ("w_gate", "w_up", "w_down"))
    m = cfg.moe
    return total - experts * (m.num_experts - m.top_k) // m.num_experts


def update_bytes(state) -> int:
    """The least bytes an optimizer update moves: each param and optimizer
    leaf read and written once, each gradient (the param's dtype) read
    once."""
    from repro_torch.training.optimizer import tree_leaves
    p = sum(t.numel() * t.element_size()
            for t in tree_leaves(state["params"]))
    o = sum(t.numel() * t.element_size() for t in tree_leaves(state["opt"]))
    return 3 * p + 2 * o


class StepClock:
    """CUDA events at the step's three parts: ``model.loss`` (forward),
    the backward, and the optimizer update (the module's ``*_update``
    function, which ``make_optimizer``'s update calls), each also a
    ``record_function`` range for the profiler.  ``split()`` gives each
    part's device-stream ms of every step since the last call."""

    PARTS = ("forward", "backward", "update")

    def __init__(self, model, kind: str):
        import torch
        from torch.profiler import record_function
        from repro_torch.training import optimizer
        self.model, self.mod = model, optimizer
        self.name = f"{kind}_update"
        self.orig_update = getattr(optimizer, self.name)
        self.marks = []
        ev = lambda: torch.cuda.Event(enable_timing=True)

        def loss(*a, **kw):
            e0 = ev()
            e0.record()
            with record_function("train.forward"):
                out = type(model).loss(model, *a, **kw)
            e1 = ev()
            e1.record()
            self.marks.append([e0, e1])
            return out

        def update(*a, **kw):
            e2 = ev()
            e2.record()
            with record_function("train.update"):
                out = self.orig_update(*a, **kw)
            e3 = ev()
            e3.record()
            self.marks[-1] += [e2, e3]
            return out

        model.loss = loss
        setattr(optimizer, self.name, update)

    def split(self) -> list:
        import torch
        torch.cuda.synchronize()
        out = [{p: a.elapsed_time(b) for p, (a, b) in zip(
            self.PARTS, ((m[0], m[1]), (m[1], m[2]), (m[2], m[3])))}
               for m in self.marks]
        self.marks = []
        return out

    def close(self):
        del self.model.loss
        setattr(self.mod, self.name, self.orig_update)


def profiled_step(train_step, state, batch):
    """One step under torch.profiler: the card's busy and idle shares of
    the step's wall, the busy ms of the kernels that start inside the
    forward and update ranges' device spans (the backward: the rest), and
    the kernels that take the most device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    ranges = ("train.forward", "train.update")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = train_step(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.events()
    busy = device_busy(events, wall, ranges=ranges)
    require(busy is not None, "the profiler saw no device activity")
    spans = {e.name: (e.time_range.start, e.time_range.end) for e in events
             if e.device_type == DeviceType.CUDA and e.name in ranges}
    parts = {"forward": 0.0, "backward": 0.0, "update": 0.0}
    by_kernel = {}
    for e in events:
        if e.device_type != DeviceType.CUDA or e.name in ranges:
            continue
        s = e.time_range.start
        by_kernel[e.name] = (by_kernel.get(e.name, 0.0)
                             + (e.time_range.end - s) * 1e-3)
        part = next((p for p, r in (("forward", "train.forward"),
                                    ("update", "train.update"))
                     if r in spans and spans[r][0] <= s <= spans[r][1]),
                    "backward")
        parts[part] += (e.time_range.end - s) * 1e-3
    busy["busy_ms_by_part"] = parts if len(spans) == 2 else None
    busy["top_kernels_ms"] = [[n[:80], ms] for n, ms in sorted(
        by_kernel.items(), key=lambda kv: -kv[1])[:10]]
    busy["kernel_launches"] = sum(e.count for e in prof.key_averages()
                                  if e.key == "cudaLaunchKernel")
    return state, busy


def train_run(model, kind: str, steps: int, seed: int, batch: int,
              seq: int) -> tuple:
    """``steps`` steps of ``make_train_step(model, kind)`` from seeded
    weights on PackedStream batches, then one profiled step.  Model FLOPs
    count the active parameters.  Returns (report, state)."""
    import torch
    from repro_torch.training.data import DataConfig, PackedStream
    from repro_torch.training.optimizer import make_train_step
    cfg = model.cfg
    release_pools()
    torch.cuda.reset_peak_memory_stats()
    init_state, train_step = make_train_step(model, kind)
    state = init_state(torch.Generator(device=DEVICE).manual_seed(seed),
                       DEVICE)
    n_params = count_params(state["params"])
    data = PackedStream(DataConfig(cfg.vocab_size, seq, batch, seed))
    clock = StepClock(model, kind)
    losses, auxes, secs = [], [], []
    try:
        for step in range(steps):
            b = {k: torch.from_numpy(v).to(DEVICE)
                 for k, v in data.batch(step).items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, met = train_step(state, b)
            loss = float(met["loss"])
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            require(np.isfinite(loss), f"{cfg.name} {kind}: loss {loss} at "
                    f"step {step}")
            losses.append(loss)
            auxes.append(float(met["aux"]))
        split = clock.split()
        peak = torch.cuda.max_memory_allocated() / 1e9
        b = {k: torch.from_numpy(v).to(DEVICE)
             for k, v in data.batch(steps).items()}
        state, prof = profiled_step(train_step, state, b)
        clock.split()
    finally:
        clock.close()
    med = statistics.median(secs[1:])
    active = active_params(state["params"], cfg)
    flops = model_flops(cfg, active, batch, seq)
    report = {
        "optimizer": kind, "steps": steps, "batch": batch, "seq": seq,
        "tokens_per_step": batch * seq, "parameters": n_params,
        "active_parameters": active,
        "loss_first_5": losses[:5], "loss_last_5": losses[-5:],
        "aux_first_last": [auxes[0], auxes[-1]],
        "first_step_s": secs[0], "step_s_median": med,
        "ms_median_by_part": {p: statistics.median(s[p] for s in split[1:])
                              for p in StepClock.PARTS},
        "tokens_per_s": batch * seq / med,
        "model_tflop_per_step": flops / 1e12,
        "mfu": flops / med / BF16_PEAK,
        "peak_gb": peak,
        "update_bound_ms": update_bytes(state) / HBM_BYTES_PER_S * 1e3,
        "profiled_step": prof}
    return report, state


def layer_index_cost(model, params, seed: int, batch: int, seq: int):
    """Forward + backward seconds and peak GB with the stacked params
    unbound once (``layer_list``, the training path) against indexed
    per layer (``layer_slice``), whose backward scatters each layer's
    gradient into a zero tensor of the whole stack; runs unbind, index,
    index, unbind."""
    import torch
    from repro_torch.models import model as model_mod
    from repro_torch.models.layers import layer_slice
    from repro_torch.training.data import DataConfig, PackedStream
    from repro_torch.training.optimizer import tree_leaves, tree_map
    data = PackedStream(DataConfig(model.cfg.vocab_size, seq, batch, seed))
    b = {k: torch.from_numpy(v).to(DEVICE)
         for k, v in data.batch(0).items()}
    orig = model_mod.layer_list
    indexed = lambda layers, n: [layer_slice(layers, i) for i in range(n)]
    out = {"unbind": [], "index": []}
    peaks = {}
    for name in ("unbind", "index", "index", "unbind"):
        model_mod.layer_list = indexed if name == "index" else orig
        try:
            release_pools()
            torch.cuda.reset_peak_memory_stats()
            tracked = tree_map(lambda p: p.detach().requires_grad_(), params)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, _ = model.loss(tracked, b)
            grads = torch.autograd.grad(loss, tree_leaves(tracked))
            torch.cuda.synchronize()
            out[name].append(time.perf_counter() - t0)
            peaks[name] = torch.cuda.max_memory_allocated() / 1e9
            del tracked, loss, grads
        finally:
            model_mod.layer_list = orig
    return {"fwd_bwd_s": out, "peak_gb": peaks,
            "index_minus_unbind_s": statistics.mean(out["index"])
            - statistics.mean(out["unbind"])}


def float64_loss_grads(model, params, batch) -> list:
    """[loss] + every gradient leaf of the port evaluated in float64 on
    the CPU: each float32 dtype argument and each ``Tensor.float()``
    becomes float64.  The layers keep their activations, since a
    checkpoint's recompute runs outside the mode."""
    import torch
    from torch.overrides import TorchFunctionMode
    from repro_torch.models import model as model_mod
    from repro_torch.training.optimizer import tree_leaves, tree_map

    class Float64(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            if func is torch.Tensor.float:
                return args[0].double()
            wide = lambda a: torch.float64 if a is torch.float32 else a
            return func(*map(wide, args),
                        **{k: wide(v) for k, v in (kwargs or {}).items()})

    orig = model_mod.checkpoint
    model_mod.checkpoint = lambda fn, *a, **kw: fn(*a)
    try:
        with Float64():
            tracked = tree_map(
                lambda p: p.detach().double().requires_grad_(), params)
            loss, _ = model.loss(tracked, batch)
            grads = torch.autograd.grad(loss, tree_leaves(tracked),
                                        allow_unused=True,
                                        materialize_grads=True)
    finally:
        model_mod.checkpoint = orig
    require(all(g.dtype == torch.float64 for g in grads),
            "the float64 evaluation left float64")
    return [loss.detach()] + list(grads)


def card_vs_cpu(arch: str, seed: int) -> dict:
    """A reduced arch in float32: loss and every gradient leaf on the card
    against the same port on the CPU from the same weights, and both
    against the port's float64 evaluation (the card no farther from it
    than ``FLOAT64_RATIO`` times the CPU, or ``TRAIN_TOL``); then one Adam
    and one Adafactor update on the card against the CPU's from the same
    params, gradients (the CPU's) and state, the new params and optimizer
    state held the same way.  The first Adam step moves a parameter by
    lr * g / (|g| + eps): a gradient element within rounding of zero
    (some 1e-9 of a few in every 10^5-element leaf) turns the two
    devices' rounding differences into up to lr of parameter, so the
    update is held on shared gradients, and ``train_step`` on each
    device's own gradients is reported (``step_param_err``), not held."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.training.optimizer import (
        make_optimizer,
        make_train_step,
        tree_leaves,
        tree_map,
    )
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    model = build_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(seed), "cpu")
    rng = np.random.default_rng(seed)
    nb = {k: rng.integers(0, cfg.vocab_size, REDUCED_BATCH).astype(np.int32)
          for k in ("tokens", "labels")}
    if cfg.is_encdec:
        nb["frames"] = rng.standard_normal(
            (*REDUCED_BATCH, cfg.d_model)).astype(np.float32)

    def on(device, tree=params):
        """Copies of ``tree`` and the batch on ``device``: the updates
        write into the tensors they are given."""
        return (tree_map(lambda p: p.detach().clone().to(device), tree),
                {k: torch.from_numpy(v).to(device) for k, v in nb.items()})

    def loss_grads(device):
        p, b = on(device)
        tracked = tree_map(lambda t: t.requires_grad_(), p)
        loss, _ = model.loss(tracked, b)
        grads = torch.autograd.grad(loss, tree_leaves(tracked),
                                    allow_unused=True, materialize_grads=True)
        return [loss.detach()] + list(grads)

    beyond = []

    def worst(got, want, what, hold=True, tol=TRAIN_TOL) -> float:
        """The largest error over a leaf's scale; with ``hold`` each leaf
        past ``tol`` is listed in ``row["beyond_tol"]``."""
        err = 0.0
        for i, (g, w) in enumerate(zip(got, want)):
            g, w = g.detach().double().cpu(), w.detach().double().cpu()
            scale = max(1.0, float(w.abs().max()))
            e = float((g - w).abs().max()) / scale
            if hold and not bool(((g - w).abs() <= tol * scale
                                  + tol * w.abs()).all()):
                beyond.append([what, i, e])
            err = max(err, e)
        return err

    cpu = loss_grads("cpu")
    row = {"leaves": len(tree_leaves(params)), "loss": float(cpu[0]),
           "beyond_tol": beyond,
           "grad_tol": TRAIN_TOL_BY_ARCH.get(arch, TRAIN_TOL)}
    card = loss_grads(DEVICE)
    row["grad_err"] = worst(card, cpu, "grad", tol=row["grad_tol"])
    f64 = float64_loss_grads(model, params, on("cpu")[1])
    row["cpu_float64_err"] = worst(cpu, f64, "cpu-float64", hold=False)
    row["card_float64_err"] = worst(card, f64, "card-float64", hold=False)
    limit = max(TRAIN_TOL, FLOAT64_RATIO * row["cpu_float64_err"])
    if row["card_float64_err"] > limit:
        beyond.append(["card-float64", None, row["card_float64_err"], limit])
    it = iter(cpu[1:])
    grads = tree_map(lambda _: next(it), params)
    for kind in ("adam", "adafactor"):
        _, init, update = make_optimizer(kind)
        new = {}
        for device in (DEVICE, "cpu"):
            p, _ = on(device)
            g, _ = on(device, grads)
            step = torch.zeros((), dtype=torch.int32, device=device)
            new_p, new_s = update(p, g, init(p), step)
            new[device] = tree_leaves({"params": new_p, "opt": new_s})
        row[f"{kind}_update_err"] = worst(new[DEVICE], new["cpu"], kind)
        _, train_step = make_train_step(model, kind)
        for device in (DEVICE, "cpu"):
            p, b = on(device)
            state = {"params": p, "opt": init(p),
                     "step": torch.zeros((), dtype=torch.int32,
                                         device=device)}
            state, met = train_step(state, b)
            require(bool(torch.isfinite(met["loss"])),
                    f"{arch} {kind}: non-finite loss on {device}")
            new[device] = tree_leaves(state["params"])
        row[f"{kind}_step_param_err"] = worst(new[DEVICE], new["cpu"],
                                              kind, hold=False)
    return row


def phase_train(state, seed: int):
    import torch
    from repro_torch.configs import ARCH_IDS
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.kernels.ragged_attention import ragged_segment_attention
    from repro_torch.models import LanguageModel
    release_pools()
    paged_attention.launches = 0
    ragged_segment_attention.launches = 0
    out = {"card": state["smi"]}

    # (a) full-width qwen3-1.7b, bf16: Adam, then Adafactor from fresh weights
    cfg = full_config()
    model = LanguageModel(cfg)
    qwen3 = {}
    for kind, steps in TRAIN_STEPS.items():
        report, st = train_run(model, kind, steps, seed, TRAIN_BATCH,
                               TRAIN_SEQ)
        require(report["parameters"] == QWEN3_PARAMS,
                f"{report['parameters']} parameters built")
        first = statistics.mean(report["loss_first_5"])
        last = statistics.mean(report["loss_last_5"])
        start = min(report["loss_first_5"][0], math.log(cfg.vocab_size))
        require(last < first and last < start,
                f"qwen3-1.7b {kind}: loss {first} (the first 5 steps' mean) "
                f"-> {last}; the last 5 must also lie below {start}, the "
                f"first step's loss or ln V")
        if kind == "adam":
            report["layer_index_cost"] = layer_index_cost(
                model, st["params"], seed, TRAIN_BATCH, TRAIN_SEQ)
        del st
        qwen3[kind] = report
    out["qwen3-1.7b"] = {"layers": cfg.num_layers, "dtype": cfg.dtype,
                         **qwen3}

    # (b) qwen2-moe-a2.7b at its published widths, 4 of 24 layers
    mcfg = cut(moe_config(), MOE_TRAIN_LAYERS)
    report, st = train_run(LanguageModel(mcfg), "adam", MOE_TRAIN_STEPS,
                           seed, MOE_TRAIN_BATCH, TRAIN_SEQ)
    del st
    require(all(a > 0 for a in report["aux_first_last"]),
            "the MoE aux loss is not in the loss")
    out["qwen2-moe-a2.7b"] = {"layers": mcfg.num_layers,
                              "cut": f"24 -> {MOE_TRAIN_LAYERS} layers",
                              "dtype": mcfg.dtype, **report}
    release_pools()

    # (c) every reduced arch in float32: the card against the CPU
    out["reduced_card_vs_cpu"] = rows = {arch: card_vs_cpu(arch, seed)
                                         for arch in ARCH_IDS}
    bad = {a: r["beyond_tol"] for a, r in rows.items() if r["beyond_tol"]}
    require(not bad, f"card and CPU differ beyond tolerance (what, leaf, "
            f"error over the leaf's scale): {bad}")
    launches = {"paged_attention": paged_attention.launches,
                "ragged_segment_attention": ragged_segment_attention.launches}
    require(not any(launches.values()),
            f"training launched an attention kernel: {launches}")
    state["train_launches"] = launches
    out["kernel_launches"] = launches
    return out


# =============================================================================
# phase 10: the dry-run, and its accounting held against the card
# =============================================================================

DRYRUN_SHAPES = ("train_4k", "decode_32k")
DRYRUN_TRAIN = (4, 1024)          # the train phase's batch x tokens
DRYRUN_DECODE = (16, 4096)        # 16 sequences against a 4096-token cache
PEAK_UNDER = 0.10                 # the estimate may lie this far below


def dryrun_host(out_path: str, multi_pod: bool) -> subprocess.Popen:
    """One production mesh's dry-runs, as a user runs them, in a
    subprocess on the host's CPU (no card)."""
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
           "--arch", "qwen3-1.7b", "--out", out_path]
    if multi_pod:
        cmd.append("--multi-pod")
    for shape in DRYRUN_SHAPES:
        cmd += ["--shape", shape]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    return subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def storage_bytes(args) -> int:
    """Bytes of the distinct storages behind the local tensors of
    ``args`` (DTensors' shards)."""
    from repro_torch.launch.dryrun import local_tensors
    seen = {}
    for t in local_tensors(list(args)):
        st = t.untyped_storage()
        seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())


def card_vs_dryrun(cfg, shape, seed: int, tmp: str) -> dict:
    """One step of ``shape`` on a one-rank mesh: the dry-run's accounting
    (fake one-rank mesh, on the host) against the card's real run.  The
    rank meets its group through a file store in the directory ``tmp``
    (no TCP port to pick and lose to another process)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch.launch.dryrun import build_step, dryrun_one
    from repro_torch.models.sharding import NamedMesh
    t0 = time.perf_counter()
    rec = dryrun_one(cfg.name, shape, False, cfg=cfg, mesh_shape=(1, 1))
    require(rec["status"] == "ok",
            f"dry-run of {shape.name}: {rec['status']} "
            f"{rec.get('traceback', '')}")
    dry_s = time.perf_counter() - t0
    mem = rec["memory"]
    store = os.path.join(tmp, f"store_{shape.name}")
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0,
                            world_size=1)
    try:
        mesh = NamedMesh(init_device_mesh("cuda", (1, 1),
                                          mesh_dim_names=("data", "model")))
        step_fn, args = build_step(cfg.name, shape, mesh, cfg,
                                   device=DEVICE, seed=seed)
        torch.cuda.synchronize()
        held = storage_bytes(args)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        allocated = torch.cuda.memory_allocated()
        comm = CommDebugMode()
        t0 = time.perf_counter()
        with comm:
            out = step_fn(*args)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        counts = {str(k): v for k, v in comm.get_comm_counts().items()}
        del out, args, step_fn
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    require(held == mem["argument_bytes"],
            f"{shape.name}: the dry-run's argument_bytes "
            f"{mem['argument_bytes']} against {held} held on the card")
    require(mem["peak_bytes"] >= (1 - PEAK_UNDER) * peak,
            f"{shape.name}: the dry-run's peak_bytes {mem['peak_bytes']} "
            f"lie more than {PEAK_UNDER:.0%} under the card's "
            f"max_memory_allocated {peak}")
    require(not any(rec["collectives"].values()) and not counts,
            f"{shape.name}: collectives on one rank: {rec['collectives']} "
            f"{counts}")
    return {"shape": dataclasses.asdict(shape),
            "argument_bytes": mem["argument_bytes"],
            "card_storage_bytes": held,
            "card_allocated_before_step": allocated,
            "peak_bytes_estimated": mem["peak_bytes"],
            "card_max_memory_allocated": peak,
            "peak_ratio": mem["peak_bytes"] / peak,
            "output_bytes": mem["output_bytes"],
            "flops": rec["cost"]["flops"],
            "collectives": rec["collectives"],
            "card_collective_counts": counts,
            "dryrun_s": dry_s, "card_step_s": step_s}


def phase_dryrun(state, seed: int):
    import tempfile
    from repro_torch.configs import ShapeConfig
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.kernels.ragged_attention import ragged_segment_attention
    release_pools()
    paged_attention.launches = 0
    ragged_segment_attention.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        # one subprocess a mesh, both started before the card's work
        paths = [os.path.join(tmp, f"dryrun_{m}.json") for m in (0, 1)]
        hosts = [dryrun_host(p, bool(m)) for m, p in enumerate(paths)]
        try:
            cfg = full_config()
            card = {
                "train": card_vs_dryrun(cfg, ShapeConfig(
                    "card_train", DRYRUN_TRAIN[1], DRYRUN_TRAIN[0], "train"),
                    seed, tmp),
                "decode": card_vs_dryrun(cfg, ShapeConfig(
                    "card_decode", DRYRUN_DECODE[1], DRYRUN_DECODE[0],
                    "decode"), seed, tmp)}
            t0 = time.perf_counter()
            outs = [h.communicate(timeout=600) for h in hosts]
            waited = time.perf_counter() - t0
        finally:
            for h in hosts:
                if h.poll() is None:
                    h.kill()
                    h.communicate()
        records = []
        for h, (stdout, stderr), path in zip(hosts, outs, paths):
            require(h.returncode == 0,
                    f"dry-run CLI exit {h.returncode}: {stdout[-1500:]} "
                    f"{stderr[-1500:]}")
            with open(path) as f:
                records += json.load(f)
    require(len(records) == 2 * len(DRYRUN_SHAPES)
            and all(r["status"] == "ok" for r in records),
            "dry-run records: " + str([(r["shape"], r["mesh"], r["status"])
                                       for r in records]))
    prod = [{k: r[k] for k in ("arch", "shape", "mesh", "n_devices",
                               "status", "elapsed_s", "memory", "cost",
                               "collectives", "layout_notes")}
            for r in records]
    # the model-level steps attend through causal / decode attention
    launches = {"paged_attention": paged_attention.launches,
                "ragged_segment_attention": ragged_segment_attention.launches}
    require(not any(launches.values()),
            f"the dry-run phase launched an attention kernel: {launches}")
    state["dryrun_launches"] = launches
    return {"card": state["smi"], "production_meshes": prod,
            "waited_for_host_s": waited, "one_rank_vs_card": card,
            "kernel_launches": launches}


# =============================================================================
# phase 11: tensor-parallel serving, driver and follower processes
# =============================================================================

TP_DEGREES = (2, 4)
TP_DEADLINE_S = 240          # per spawn, for all its processes together
TP_COLLECTIVE_TIMEOUT_S = 120
TP_FP32_LAYERS = 4


class ReduceClock:
    """Wraps a runner's all-reduce: CUDA events before and after each
    call, so their sum is the time the card's stream spends in the
    all-reduces (host staging included)."""

    def __init__(self, runner):
        self.runner, self.orig = runner, runner._reduce
        self.pairs = []
        runner._reduce = self

    def __call__(self, t):
        import torch
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = self.orig(t)
        b.record()
        self.pairs.append((a, b))
        return out

    def seconds(self) -> float:
        import torch
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.pairs) * 1e-3


def tp_serve(mesh, model, params, seed: int, bf16: bool) -> dict:
    """One tensor-parallel runner on ``mesh`` at the drain phase's
    settings: the driver drains the drain phase's 16 requests, a follower
    serves.  The kernels' launch counters are zeroed just before and read
    just after, on every rank."""
    import torch
    from repro_torch import serving
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.kernels.ragged_attention import ragged_segment_attention
    runner = serving.PagedModelRunner(model, params, num_blocks=4096,
                                      block_size=16, max_batch=16, mesh=mesh)
    require(runner.backend == "cuda" and runner.ragged_backend == "cuda",
            "the sharded runner must default to the CUDA kernels")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    clock = ReduceClock(runner)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    paged_attention.launches = 0
    ragged_segment_attention.launches = 0
    out = {"local_heads": {"KV": runner._lcfg.num_kv_heads,
                           "G": runner._lcfg.num_heads
                           // runner._lcfg.num_kv_heads,
                           "hd": runner._lcfg.resolved_head_dim}}
    if mesh.is_driver:
        waves = make_requests(serving, seed, model.cfg.vocab_size)
        eng = engine_for(runner)
        done, iters, addrs, wall, steps = drain(eng, waves)
        runner.shutdown()
        require(len(done) == 16, f"{len(done)} of 16 requests finished")
        out.update(streams=streams_of(done), iterations=iters, wall_s=wall,
                   pool_addresses=sorted(addrs),
                   pool_bytes=eng.metrics_snapshot()["pool_bytes"],
                   n_preempted=eng.stats.n_preempted)
        if bf16:
            tpot = [(r.finish_time - r.first_token_time) / (r.output_len - 1)
                    for r in done]
            ttft = [r.first_token_time - r.arrival_time for r in done]
            out.update(
                tpot_median_s=statistics.median(tpot),
                ttft_median_s=statistics.median(ttft),
                iteration_s_median_with_prefill=statistics.median(
                    t for p, t in steps if p),
                iteration_s_median_decode_only=statistics.median(
                    t for p, t in steps if not p))
    else:
        serving.serve_follower(runner)
    torch.cuda.synchronize()
    out.update(
        launches={"paged_attention": paged_attention.launches,
                  "ragged_segment_attention":
                      ragged_segment_attention.launches},
        all_reduces=len(clock.pairs), all_reduce_s=clock.seconds(),
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    del runner, clock
    release_pools()
    return out


def tp_worker(rank: int, world: int, tmp: str, seed: int) -> None:
    """One process of a ``world``-rank group on the card: a gloo group
    through a file store in ``tmp`` (NCCL refuses two ranks on one card),
    one tensor-parallel slice of every rank; rank 0 drives.  Each rank
    writes what it measured to ``tmp``."""
    from datetime import timedelta
    import torch
    import torch.distributed as dist
    from repro_torch.device import resolve_device
    from repro_torch.serving import make_serving_slices
    torch.cuda.set_device(resolve_device(None, rank))
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(tmp, 'store')}",
        rank=rank, world_size=world,
        timeout=timedelta(seconds=TP_COLLECTIVE_TIMEOUT_S))
    try:
        (mesh,) = make_serving_slices(1, world)
        cfg = full_config()
        out = {"bf16": tp_serve(mesh, *served(cfg, seed), seed, True)}
        cfg32 = dataclasses.replace(cfg, num_layers=TP_FP32_LAYERS,
                                    dtype="float32")
        out["fp32"] = tp_serve(mesh, *served(cfg32, seed), seed, False)
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def tp_spawn(world: int, seed: int) -> list:
    """Run ``tp_worker`` in ``world`` processes; each rank's results.  A
    process that fails or outlives the deadline fails the phase."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   OMP_NUM_THREADS="1")
        procs = [subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--seed",
             str(seed), "--tp-worker", str(r), str(world), tmp],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True) for r in range(world)]
        deadline = time.monotonic() + TP_DEADLINE_S
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(
                    timeout=max(1.0, deadline - time.monotonic())))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        for r, (p, (_, err)) in enumerate(zip(procs, outs)):
            require(p.returncode == 0,
                    f"tp {world}: rank {r} exit {p.returncode}: "
                    f"{err[-2500:]}")
        ranks = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    return ranks


def phase_tensor_parallel(state, seed: int):
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving import ServingCluster
    release_pools()
    # the reference refuses MoE at tp > 1 before anything is placed
    try:
        ServingCluster.on_mesh_slices(
            build_model(get_config("qwen2-moe-a2.7b")), None, None,
            n_instances=1, model_parallel=2, ranks=[0, 1])
        moe_error = None
    except ValueError as e:
        moe_error = str(e)
    require(moe_error is not None and "MoE" in moe_error,
            f"qwen2-moe-a2.7b at tp 2: {moe_error}")
    fp32_want, fp32_margins = state["fp32_tp1"]
    cfg = full_config()
    total = {"paged_attention": 0, "ragged_segment_attention": 0}
    out = {"card": state["smi"], "moe_tp2_error": moe_error,
           "backend": "gloo (NCCL refuses two ranks on one card): every "
                      "all-reduce of a CUDA tensor goes through host memory"}
    for world in TP_DEGREES:
        t0 = time.perf_counter()
        ranks = tp_spawn(world, seed)
        spawn_s = time.perf_counter() - t0
        bf, f32 = ranks[0]["bf16"], ranks[0]["fp32"]
        for part in ("bf16", "fp32"):
            for r, res in enumerate(ranks):
                launches = res[part]["launches"]
                require(min(launches.values()) > 0,
                        f"tp {world} {part} rank {r}: a kernel never "
                        f"launched: {launches}")
                require(res[part]["local_heads"] == {
                    "KV": cfg.num_kv_heads // world,
                    "G": cfg.num_heads // cfg.num_kv_heads,
                    "hd": cfg.resolved_head_dim},
                    f"tp {world} rank {r}: local heads "
                    f"{res[part]['local_heads']}")
                for k, v in launches.items():
                    total[k] += v
            addrs = ranks[0][part]["pool_addresses"]
            require(len(addrs) == 1 and len(addrs[0]) == world,
                    f"tp {world} {part}: the pool moved or lost a shard: "
                    f"{addrs}")
        agreement = margin_rule(f32["streams"], fp32_want, fp32_margins,
                                f"tp {world} float32")
        require(agreement["identical_streams"] + agreement[
            "near_tie_divergences"] == len(fp32_want), "stream count")
        out[f"tp{world}"] = {
            "processes": world, "spawn_s": spawn_s,
            "bf16_full_width": {
                **{k: bf[k] for k in (
                    "iterations", "wall_s", "tpot_median_s", "ttft_median_s",
                    "iteration_s_median_with_prefill",
                    "iteration_s_median_decode_only", "pool_bytes",
                    "n_preempted", "all_reduces", "all_reduce_s",
                    "local_heads")},
                "all_reduce_share_of_wall": bf["all_reduce_s"] / bf["wall_s"],
                "all_reduces_per_iteration":
                    bf["all_reduces"] / bf["iterations"],
                "pool_address_stable": True,
                "streams_diverged_from_tp1": divergences(
                    bf["streams"], state["drain_streams"]),
                "peak_memory_gb_by_rank": [
                    r["bf16"]["peak_memory_gb"] for r in ranks],
                "all_reduce_s_by_rank": [
                    r["bf16"]["all_reduce_s"] for r in ranks],
                "launches_by_rank": [r["bf16"]["launches"] for r in ranks]},
            "fp32_layers": TP_FP32_LAYERS,
            "fp32_vs_tp1": {**agreement,
                            "n_preempted": f32["n_preempted"],
                            "launches_by_rank": [
                                r["fp32"]["launches"] for r in ranks]}}
    state["tp_launches"] = total
    out["kernel_launches"] = total
    return out


# =============================================================================
# phase 12: excessive load and faults
# =============================================================================

OV_NEW = 192              # new tokens a request of the preempting drain
OV_MIN_PREEMPTED = 4
OV_WIDE_BLOCKS = 4096     # the drain phase's pool: nothing preempts there
OV_MIN_EOS_STOPS = 4      # requests the EOS token must stop early
OV_CHAOS = dict(n_instances=3, num_blocks=1024, block_size=16, max_batch=16,
                prefix_caching=True, prefill_chunk_tokens=512,
                policy="kairos")
OV_CHAOS_REQUESTS = 24
OV_CHAOS_PREFIX = 512
OV_CHAOS_TAIL = (64, 513)
OV_CHAOS_NEW = 32
OV_CRASH_SEED = 5                 # benchmarks/chaos_drain.py's crash storm
OV_MIXED_SEEDS = (0, 7, 123)      # tests/test_torch_faults.py's mixed plans
OV_DEADLINE_OVER_MAX = 2.0        # step deadline / slowest fault-free step
OV_STRAGGLE_OVER_DEADLINE = 4.0   # straggle delay / the step deadline
OV_FREE_SLACK = 16 * 2**20        # what a crash step may keep beside the pool
OV_WF_BLOCKS = 256
OV_WF_OOM_STEPS = (8, 9, 10)      # planned ooms on both instances: a storm
OV_WF_ITERATION_BUDGET = 20000    # engine iterations for the fenced burst


class ScheduleOnly:
    """A runner that computes nothing: each step returns token 0 for every
    row.  Through ``drain`` it drives the real scheduler (admission,
    prefix cache, growth, eviction, preemption) on the host.  Without EOS
    the schedule depends only on the prompts and their lengths, never on
    the tokens a model emits, so it is the card's schedule."""

    def __init__(self, num_blocks: int, block_size: int = 16,
                 max_batch: int = 16):
        from repro_torch.obs.metrics import MetricsRegistry
        self.num_blocks, self.block_size = num_blocks, block_size
        self.max_batch = max_batch
        self.metrics = MetricsRegistry()

    def run_iteration(self, batch):
        import torch
        return torch.zeros(len(batch.segments), dtype=torch.int64)

    def pool_address(self) -> int:
        return 0


def ov_replay(seed: int, vocab: int, num_blocks: int, max_new: int) -> dict:
    """The schedule of the drain's traffic on a pool of ``num_blocks``."""
    from repro_torch import serving
    eng = engine_for(ScheduleOnly(num_blocks))
    _, iters, _, _, _ = drain(eng, make_requests(serving, seed, vocab,
                                               max_new), max_iters=20000)
    return {"iterations": iters, "n_preempted": eng.stats.n_preempted,
            "n_evicted": eng.prefix_cache.stats.n_evicted,
            "prefill_tokens": eng.stats.prefill_tokens}


def ov_pool(seed: int, vocab: int):
    """The smallest power-of-two pool of at least twice the largest
    request's blocks whose schedule preempts OV_MIN_PREEMPTED times, with
    the schedules tried; and the drain's own 32 new tokens on every
    power-of-two pool up to OV_WIDE_BLOCKS."""
    from repro_torch import serving
    first, second = make_requests(serving, seed, vocab, OV_NEW)
    largest = max(-(-(r.prompt_len + r.max_new_tokens) // 16)
                  for r in first + second)
    nb = 1 << (2 * largest - 1).bit_length()
    tried, pool = {}, None
    while pool is None and nb <= OV_WIDE_BLOCKS:
        tried[nb] = ov_replay(seed, vocab, nb, OV_NEW)
        if tried[nb]["n_preempted"] >= OV_MIN_PREEMPTED:
            pool = nb
        nb *= 2
    require(pool is not None, f"no pool preempts {OV_MIN_PREEMPTED} times: "
            f"{tried}")
    short = {n: ov_replay(seed, vocab, n, 32)
             for n in (256, 512, 1024, 2048, OV_WIDE_BLOCKS)}
    return pool, {"largest_request_blocks": largest,
                  f"new_{OV_NEW}": tried, "new_32": short}


def ov_drain(model, params, waves, num_blocks: int, backend=None,
             force_sync: bool = True, eos: int = -1, tracer=None,
             margins=None):
    """One drain of ``waves`` through an engine on a pool of
    ``num_blocks``; with ``margins`` (a list) the run's margin log is
    appended to it.  Returns (report, finished, engine, per-step (has
    prefill, seconds), the sampled token on which each finished request's
    last step was decided)."""
    runner = runner_for(model, params, backend, num_blocks=num_blocks)
    eng = engine_for(runner, eos_token=eos,
                     **({} if tracer is None else {"tracer": tracer}))
    sampled = {}
    collect = eng.collect

    def probed(force_sync=False):
        batch, toks = eng._pending
        done = collect(force_sync=force_sync)
        rows = {s.req.req_id: j for j, s in enumerate(batch.segments)
                if s.kind != "prefill"}
        for r in done:
            sampled[r.msg_id] = int(toks.host()[rows[r.req_id]])
        return done

    eng.collect = probed
    addr = runner.pool_address()
    if margins is not None:
        log, undo = record_margins(runner)
        margins.append(log)
    try:
        done, iters, addrs, wall, steps = drain(
            eng, waves, max_iters=20000, force_sync=force_sync)
    finally:
        if margins is not None:
            undo()
    require(len(done) == 16, f"{len(done)} of 16 requests finished")
    require(addrs == {addr}, "the pool moved during the drain")
    require(runner.n_dispatches == iters,
            f"{runner.n_dispatches} dispatches for {iters} iterations")
    report = {"num_blocks": num_blocks, "iterations": iters,
              "n_preempted": eng.stats.n_preempted,
              "n_evicted": eng.prefix_cache.stats.n_evicted,
              "prefill_tokens": eng.stats.prefill_tokens,
              "prefill_tokens_saved": eng.stats.prefill_tokens_saved,
              "generated_tokens": sum(r.output_len for r in done),
              "wall_s": wall, "ttft_median_s": statistics.median(
                  r.first_token_time - r.arrival_time for r in done),
              "tpot_median_s": tpot_median(done),
              "iteration_s_median_decode_only": statistics.median(
                  [t for p, t in steps if not p] or [float("nan")]),
              "iteration_s_median_with_prefill": statistics.median(
                  [t for p, t in steps if p] or [float("nan")]),
              "dispatches_per_iteration": runner.n_dispatches / iters,
              "pool_address_stable": True}
    return report, done, eng, steps, sampled


def eos_cut(stream, eos: int):
    """The engine's stop rule applied to a stream decoded without EOS: a
    request finishes once the token it just sampled is ``eos``, before
    feeding it; the first token (the prompt's argmax) is never checked."""
    for i in range(1, len(stream)):
        if stream[i] == eos:
            return stream[:i]
    return stream


def pick_eos(streams, at_least: int) -> int:
    """Of the tokens that stop at least ``at_least`` streams early, the
    one that stops the fewest (ties: the smallest id), so the pool stays
    under pressure."""
    count = {}
    for s in streams.values():
        for t in set(s[1:]):
            count[t] = count.get(t, 0) + 1
    fit = [t for t, n in count.items() if n >= at_least]
    require(fit, f"no token stops {at_least} streams early")
    return min(fit, key=lambda t: (count[t], t))


def eos_checks(done, sampled, eos: int, max_new: int) -> int:
    """Every stream stops where its own run sampled ``eos``, or at
    ``max_new``, and holds no ``eos`` past its first token.  Returns how
    many stopped early."""
    early = 0
    for r in done:
        s = [int(t) for t in r.output_tokens]
        require(eos not in s[1:], f"{r.msg_id}: eos {eos} inside the stream")
        if len(s) < max_new:
            require(sampled[r.msg_id] == eos,
                    f"{r.msg_id}: stopped at {len(s)} tokens on "
                    f"{sampled[r.msg_id]}, not eos {eos}")
            early += 1
    return early


def eos_rule(got, want, margins, eos: int, what: str) -> dict:
    """``got`` (drained with ``eos``) against ``want`` (the same traffic
    without): each stream must be ``want``'s cut by the stop rule, except
    where the two runs part at a token whose top-2 margin in ``want``'s
    run was at or below MARGIN (the parting may be the stop itself)."""
    exact = near = 0
    for msg in sorted(want):
        g, cut, m = got[msg], eos_cut(want[msg], eos), margins[msg]
        if g == cut:
            exact += 1
            continue
        k = next((i for i in range(min(len(g), len(cut))) if g[i] != cut[i]),
                 min(len(g), len(cut)))
        require(k < len(m) and m[k] <= MARGIN,
                f"{what} {msg}: with eos {eos} the stream parts from the run "
                f"without at token {k}, margin {m[k] if k < len(m) else None}")
        near += 1
    return {"streams": len(want), "eos_cuts_exact": exact,
            "near_tie_partings": near}


def ov_preempting_drains(model, params, seed: int, vocab: int,
                         pool: int, replay: dict) -> dict:
    """Parts 1 and 3 in bf16 at full width, each drain collecting without
    a forced sync (the host plans the next iteration while the card
    computes this one): the tight pool against the wide one, then the
    tight pool with an eos_token no stream emits (collect then syncs
    every iteration, engine.collect; schedule and tokens stay, so the
    run differs from the first only by the sync) and with one that stops
    at least OV_MIN_EOS_STOPS streams early."""
    from repro_torch import serving
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.kernels.ragged_attention import ragged_segment_attention

    def run(blocks, eos=-1):
        out = ov_drain(model, params, make_requests(serving, seed, vocab,
                                                  OV_NEW), blocks,
                       force_sync=False, eos=eos)
        release_pools()
        return out

    launches0 = (paged_attention.launches, ragged_segment_attention.launches)
    tight, done, _, _, _ = run(pool)
    launched = {"paged_attention": paged_attention.launches - launches0[0],
                "ragged_segment_attention":
                    ragged_segment_attention.launches - launches0[1]}
    require(min(launched.values()) > 0,
            f"a kernel never launched in the tight drain: {launched}")
    require(max(launched.values()) <= model.cfg.num_layers
            * tight["iterations"], f"more than one launch per layer and "
            f"iteration: {launched}")
    tight["kernel_launches"] = launched
    require(all(r.output_len == OV_NEW for r in done),
            f"a request did not finish with {OV_NEW} tokens")
    require(tight["n_preempted"] >= OV_MIN_PREEMPTED
            and tight["n_evicted"] >= 1,
            f"tight pool: {tight['n_preempted']} preemptions, "
            f"{tight['n_evicted']} evictions")
    require((tight["iterations"], tight["n_preempted"], tight["n_evicted"])
            == (replay["iterations"], replay["n_preempted"],
                replay["n_evicted"]),
            f"the card's schedule {tight} is not the host replay's {replay}")
    streams = streams_of(done)
    wide, done, _, _, _ = run(OV_WIDE_BLOCKS)
    require(wide["n_preempted"] == 0, "the wide pool preempted")
    tight["prefill_tokens_beyond_wide_pool"] = (tight["prefill_tokens"]
                                               - wide["prefill_tokens"])
    tight["bf16_streams_diverged_from_wide_pool"] = divergences(
        streams, streams_of(done))

    unused = min(set(range(vocab)) - {t for v in streams.values()
                                      for t in v})
    synced, done, _, _, _ = run(pool, unused)
    require(streams_of(done) == streams,
            "an eos_token no stream emits changed the streams")
    eos = pick_eos(streams, OV_MIN_EOS_STOPS)
    with_eos, done, _, _, sampled = run(pool, eos)
    early = eos_checks(done, sampled, eos, OV_NEW)
    require(early >= OV_MIN_EOS_STOPS, f"eos {eos} stopped {early} early")
    got = streams_of(done)
    return {"max_new_tokens": OV_NEW, "collect": "deferred",
            "tight_pool": tight, "wide_pool": wide,
            "eos": {"eos_token": eos, "stopped_early": early,
                    "streams_equal_to_eos_cut": sum(
                        got[m] == eos_cut(streams[m], eos) for m in streams),
                    "with_eos": with_eos,
                    "eos_never_emitted": {"eos_token": unused, **synced},
                    "sync_cost_tpot_s": synced["tpot_median_s"]
                    - tight["tpot_median_s"]}}


def ov_identity(model, params, seed: int, vocab: int, pool: int,
                replay: dict, tracer) -> dict:
    """Part 2 in float32, and EOS under its margin rule: the tight pool on
    the CUDA kernels (traced: its preemptions and evictions are the
    export's) against the wide pool on the plain versions."""
    from repro_torch import serving
    runs = {}
    for key, blocks, backend, tr in (("cuda", pool, None, tracer),
                                     ("ref", OV_WIDE_BLOCKS, "ref", None)):
        logs = []
        report, done, _, _, _ = ov_drain(
            model, params, make_requests(serving, seed, vocab, OV_NEW), blocks,
            backend, tracer=tr, margins=logs)
        runs[key] = (report,) + streams_and_margins(done, logs[0], OV_NEW)
        release_pools()
    cuda, ref = runs["cuda"][0], runs["ref"][0]
    require((cuda["iterations"], cuda["n_preempted"])
            == (replay["iterations"], replay["n_preempted"]),
            f"float32 schedule {cuda} is not the host replay's {replay}")
    require(ref["n_preempted"] == 0, "the wide pool preempted")
    out = {"layers": model.cfg.num_layers, "dtype": model.cfg.dtype,
           "tight_cuda": cuda, "wide_ref": ref,
           "tight_cuda_vs_wide_ref": margin_rule(
               runs["cuda"][1], runs["ref"][1], runs["ref"][2],
               "float32 tight cuda")}
    want, margins = runs["cuda"][1:]
    eos = pick_eos(want, OV_MIN_EOS_STOPS)
    report, done, _, _, sampled = ov_drain(
        model, params, make_requests(serving, seed, vocab, OV_NEW), pool,
        eos=eos)
    release_pools()
    out["eos"] = {"eos_token": eos,
                  "stopped_early": eos_checks(done, sampled, eos, OV_NEW),
                  "n_preempted": report["n_preempted"],
                  **eos_rule(streams_of(done), want, margins, eos,
                             "float32 eos")}
    return out


def chaos_requests(mod, seed: int, vocab: int):
    """24 requests from 3 agents at once, the shape of
    ``benchmarks/chaos_drain.py``'s workload at serving lengths: a common
    512-token prefix, a tail of 64-512 tokens each, 32 new tokens."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, OV_CHAOS_PREFIX)
    out = []
    for i in range(OV_CHAOS_REQUESTS):
        toks = np.concatenate([prefix, rng.integers(
            0, vocab, int(rng.integers(*OV_CHAOS_TAIL)))]).astype(np.int32)
        out.append(mod.Request(agent_name=f"agent{i % 3}", msg_id=f"c{i:02d}",
                               prompt_len=len(toks), prompt_tokens=toks,
                               max_new_tokens=OV_CHAOS_NEW,
                               shared_prefix_len=OV_CHAOS_PREFIX))
    return out


class CrashWatch:
    """Runs after every cluster step.  Records the slowest engine's step
    wall time and, after a step that found a crash, whether the dead
    engines' pools are unreferenced and how far the card's allocated
    bytes fell over that step."""

    def __init__(self, cluster):
        import weakref
        import torch
        self.pools = {e.instance_id: (weakref.ref(e.runner._pool_buf),
                                      e.runner._pool_buf.nbytes)
                      for e in cluster.engines}
        self.crashes, self.crash_steps, self.step_walls = 0, [], []
        torch.cuda.synchronize()
        self.allocated = torch.cuda.memory_allocated()

    def __call__(self, cluster, step):
        import torch
        torch.cuda.synchronize()
        allocated = torch.cuda.memory_allocated()
        self.step_walls.append(max(e.last_step_wall
                                   for e in cluster.engines))
        if cluster.recovery.n_crashes > self.crashes:
            gone = {i for s in self.crash_steps for i in s["instances"]}
            dead = sorted(set(self.pools) - gone
                          - {e.instance_id for e in cluster.engines})
            self.crash_steps.append({
                "step": step, "instances": dead,
                "pool_bytes": sum(self.pools[i][1] for i in dead),
                "allocated_drop": self.allocated - allocated,
                "pools_unreferenced": all(self.pools[i][0]() is None
                                          for i in dead)})
            self.crashes = cluster.recovery.n_crashes
        self.allocated = allocated


def without_collector(run):
    """``run()`` with the cycle collector off: a pool that outlives its
    engine then stays, instead of going at a collection that happens to
    run."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        return run()
    finally:
        if enabled:
            gc.enable()


def chaos_run(model, params, seed: int, vocab: int, plan=None, tracer=None,
              pipelined=True, step_deadline_s=None, margins=None):
    """The 24 requests through a fresh OV_CHAOS cluster under ``plan``:
    none failed, lost or duplicated.  With ``margins`` (a list; needs
    ``pipelined=False``) the runners' margin log is appended to it.
    Returns (finished, metrics snapshot, CrashWatch, wall s, steps,
    submit time)."""
    from repro_torch import serving
    cluster = el_cluster(model, params, faults=plan, pipelined=pipelined,
                         step_deadline_s=step_deadline_s, **OV_CHAOS,
                         **({} if tracer is None else {"tracer": tracer}))
    watch = CrashWatch(cluster)
    if margins is not None:
        log, undo = record_margins(*(e.runner for e in cluster.engines))
        margins.append(log)
    reqs = chaos_requests(serving, seed, vocab)
    t0 = time.monotonic()
    try:
        done, steps, wall = without_collector(
            lambda: cluster_run(cluster, reqs, watch))
    finally:
        if margins is not None:
            undo()
    require(sorted(r.msg_id for r in done) == sorted(r.msg_id for r in reqs),
            "the chaos cluster lost or duplicated a request")
    failed = [r.msg_id for r in done
              if r.state is serving.RequestState.FAILED]
    require(not failed, f"requests failed: {failed}")
    return done, cluster.metrics_snapshot(), watch, wall, steps, t0


def e2e_summary(done) -> dict:
    from repro_torch.obs import percentile
    lat = [r.finish_time - r.arrival_time for r in done]
    return ({"requests": len(lat), "e2e_median_s": statistics.median(lat),
             "e2e_p90_s": percentile(lat, 90)} if lat
            else {"requests": 0})


def ov_mixed_plan(horizon: int, delay_s: float):
    """The first of OV_MIXED_SEEDS whose mixed plan (2 crashes, 1
    straggle, 1 oom) puts every straggle and oom on an instance before
    that instance's crash, so all of them fire and are seen."""
    from repro_torch.serving import FaultPlan
    for seed in OV_MIXED_SEEDS:
        plan = FaultPlan.generate(seed, [0, 1, 2], horizon=horizon,
                                  n_crashes=2, n_straggles=1, n_ooms=1,
                                  spare=(0,), straggle_delay_s=delay_s)
        crash_at = {s.instance_id: s.step for s in plan.crashes()}
        if all(s.step < crash_at.get(s.instance_id, horizon)
               for s in plan if s.kind != "crash"):
            return seed, plan
    raise PhaseFailed(f"no seed of {OV_MIXED_SEEDS} fires every fault "
                      f"within horizon {horizon}")


def chaos_checks(plan, snap, watch, events) -> dict:
    """What every faulted run must show: both crashes recovered onto the
    spare, every planned fault fired, each straggle fenced and nothing
    else fenced as a straggler, each dead pool unreferenced and off the
    card once the step that found the crash returned."""
    require(snap["n_crashes"] == 2 and snap["n_instances"] == 1,
            f"{snap['n_crashes']} crashes, {snap['n_instances']} instances "
            "left")
    require(snap["n_faults_fired"] == len(plan),
            f"{snap['n_faults_fired']} of {len(plan)} planned faults fired")
    require(snap["n_recovery_failed"] == 0, "a recovery failed")
    straggles = sorted(s.instance_id for s in plan if s.kind == "straggle")
    fenced = sorted(e.instance_id for e in events
                    if e.kind == "failure-detected"
                    and e.data.get("reason") == "straggler")
    require(fenced == straggles and snap["n_straggler_fences"]
            == len(straggles), f"straggler fences on {fenced}, straggles "
            f"planned on {straggles}")
    dead = sorted(i for s in watch.crash_steps for i in s["instances"])
    require(dead == sorted(s.instance_id for s in plan.crashes()),
            f"dead instances {dead}")
    for s in watch.crash_steps:
        require(s["pools_unreferenced"],
                f"a dead pool of {s['instances']} is still referenced")
        require(s["allocated_drop"] >= s["pool_bytes"] - OV_FREE_SLACK,
                f"allocated bytes fell by {s['allocated_drop']} over the "
                f"crash step of {s['instances']}, pools of "
                f"{s['pool_bytes']}")
    return {"crash_steps": watch.crash_steps,
            "straggler_fenced_instances": fenced,
            "oom_fences": sum(e.kind == "oom-fence" for e in events)}


def recovery_report(done, snap, events, base_tokens: int) -> dict:
    """Reconstructions, replayed tokens, the replay tax, the seconds from
    each crash to each reconstructed request's first token, and e2e
    latency of the requests that were and were not on a dead
    instance."""
    first = {}
    for e in events:
        if e.kind == "first-token":
            first.setdefault(e.req_id, []).append(e.ts)
    to_first, victims = [], set()
    for e in events:
        if e.kind == "recovery-replay":
            victims.add(e.req_id)
            after = [t for t in first.get(e.req_id, ()) if t >= e.ts]
            require(after, f"reconstructed request {e.req_id} never "
                    "produced a first token")
            to_first.append(min(after) - e.ts)
    return {"reconstructed": int(snap["n_reconstructed"]),
            "replayed_tokens": int(snap["n_replayed_tokens"]),
            "recovery_replay_overhead": snap["n_replayed_tokens"]
            / base_tokens,
            "crash_to_first_token_s": to_first,
            "on_dead_instances": e2e_summary(
                [r for r in done if r.req_id in victims]),
            "elsewhere": e2e_summary(
                [r for r in done if r.req_id not in victims])}


def ov_chaos(model, params, seed: int, vocab: int, tracer) -> tuple:
    """Part 4 in bf16: the fault-free run, the crash storm and the mixed
    plan, pipelined; the mixed run is traced into ``tracer``.  Returns
    (report, fault-free streams, the plan's settings for the float32
    replay)."""
    from repro_torch.obs import Tracer
    from repro_torch.serving import FaultPlan
    done, snap, watch, wall, steps, _ = chaos_run(model, params, seed, vocab)
    base = streams_of(done)
    base_tokens = sum(len(v) for v in base.values())
    iters = {i: int(snap[f"engine{i}.n_dispatches"]) for i in range(3)}
    horizon = max(2, min(iters.values()) // 2)
    slowest = max(watch.step_walls)
    deadline = OV_DEADLINE_OVER_MAX * slowest
    delay = OV_STRAGGLE_OVER_DEADLINE * deadline
    out = {"config": OV_CHAOS, "requests": OV_CHAOS_REQUESTS,
           "fault_free": {"wall_s": wall, "steps": steps,
                          "iterations_by_instance": iters,
                          "slowest_step_s": slowest, **e2e_summary(done)},
           "horizon": horizon, "step_deadline_s": deadline,
           "straggle_delay_s": delay}
    release_pools()
    # the same drain stepped by the serial loop: what the dispatch
    # threads of the pipelined one cost on one card
    done, _, _, wall, steps, _ = chaos_run(model, params, seed, vocab,
                                           pipelined=False)
    out["fault_free_serial_loop"] = {
        "wall_s": wall, "steps": steps, **e2e_summary(done),
        "bf16_streams_diverged_from_pipelined": divergences(
            streams_of(done), base)}
    release_pools()
    plans = {"crash_storm": (None, FaultPlan.generate(
        OV_CRASH_SEED, [0, 1, 2], horizon=horizon, n_crashes=2, spare=(0,)))}
    plans["mixed"] = ov_mixed_plan(horizon, delay)
    for key, (plan_seed, plan) in plans.items():
        tr = tracer if key == "mixed" else Tracer()
        done, snap, watch, wall, steps, t0 = chaos_run(
            model, params, seed, vocab, plan, tr, step_deadline_s=deadline)
        events = [e for e in tr.events() if e.ts >= t0]
        out[key] = {"seed": plan_seed,
                    "plan": [dataclasses.astuple(s) for s in plan],
                    "wall_s": wall, "steps": steps,
                    **chaos_checks(plan, snap, watch, events),
                    **recovery_report(done, snap, events, base_tokens),
                    "bf16_streams_diverged_from_fault_free": divergences(
                        streams_of(done), base)}
        release_pools()
    return out, base, (plans["mixed"][1], deadline)


def ov_chaos_float32(model, params, seed: int, vocab: int, plan,
                     deadline: float) -> dict:
    """Part 4's float32 replay, stepped serially (the margins' hook is
    shared): the mixed plan against the fault-free run under the margin
    rule."""
    logs = []
    done, _, _, _, _, _ = chaos_run(model, params, seed, vocab,
                                    pipelined=False, margins=logs)
    want, margins = streams_and_margins(done, logs[0], OV_CHAOS_NEW)
    release_pools()
    done, snap, _, _, _, _ = chaos_run(
        model, params, seed, vocab, plan, pipelined=False,
        step_deadline_s=deadline)
    require(snap["n_crashes"] == 2 and snap["n_faults_fired"] == len(plan)
            and snap["n_straggler_fences"] == sum(
                s.kind == "straggle" for s in plan),
            f"float32: {snap['n_crashes']} crashes, "
            f"{snap['n_faults_fired']} faults fired, "
            f"{snap['n_straggler_fences']} straggler fences")
    release_pools()
    return {"layers": model.cfg.num_layers, "stepping": "serial",
            "reconstructed": int(snap["n_reconstructed"]),
            **margin_rule(streams_of(done), want, margins,
                          "float32 chaos")}


def ov_transfer(model, params, seed: int, vocab: int, base) -> dict:
    """Part 5: mid-drain on the fault-free cluster, one ``migrate_many``
    from instance 1 to instance 0 under a planned transfer fault.  It
    must roll back: the target's free blocks as before the call, the
    source's blocks bit-equal, the requests still running there, and
    their streams the fault-free run's."""
    from repro_torch import serving
    from repro_torch.serving import (
        FaultInjector,
        FaultPlan,
        FaultSpec,
        TransferFault,
    )
    migration = importlib.import_module("repro_torch.serving.migration")
    cluster = el_cluster(model, params, **OV_CHAOS)
    rec = {}

    def on_step(c, step):
        if rec:
            return
        src, dst = c._by_id[1], c._by_id[0]
        batch = [r for r in src.sched.running if r.output_len >= 4]
        if len(batch) < 2:
            return

        def blocks(r):
            table = src.bm.block_table(r.req_id)
            return src.runner.read_blocks(table[:src.bm.blocks_needed(
                r.prefilled_len + r.output_len)])

        before = {r.msg_id: blocks(r) for r in batch}
        free, cached = dst.bm.free_blocks, dst.bm.cached_blocks
        writes = dst.runner.n_dispatches
        faults = FaultInjector(FaultPlan([FaultSpec("transfer", 1, 0)]))
        t = time.perf_counter()
        try:
            migration.migrate_many(src, dst, batch, c.clock(), faults=faults)
            err = None
        except migration.MigrationError as e:
            err = e
        rec["rollback_s"] = time.perf_counter() - t
        require(err is not None and isinstance(err.__cause__, TransferFault),
                f"the planned transfer fault did not roll back: {err!r}")
        require(all(r in src.sched.running for r in batch)
                and not any(r.req_id in dst.bm.owned_seqs() for r in batch),
                "a request did not return to its source")
        rec.update(
            step=step, requests=sorted(r.msg_id for r in batch),
            target_free_blocks={"before": free, "after": dst.bm.free_blocks},
            target_cached_blocks={"before": cached,
                                  "after": dst.bm.cached_blocks},
            target_dispatches=dst.runner.n_dispatches - writes,
            source_blocks_bit_equal=all(
                np.array_equal(before[r.msg_id], blocks(r)) for r in batch))
        require(dst.bm.free_blocks == free,
                f"the target's free blocks {free} -> {dst.bm.free_blocks}")
        require(rec["source_blocks_bit_equal"],
                "the source's blocks changed through the rollback")

    done, _, wall = cluster_run(cluster, chaos_requests(serving, seed, vocab),
                                on_step)
    require(rec, "instance 1 never ran two requests 4 tokens in")
    streams = streams_of(done)
    require(all(streams[m] == base[m] for m in rec["requests"]),
            "a rolled-back request's stream left the fault-free run's")
    rec["bf16_streams_diverged_from_fault_free"] = divergences(streams, base)
    rec["wall_s"] = wall
    release_pools()
    return rec


def fence_spans(events, t0: float, t1: float) -> dict:
    """Each instance's fenced time inside [t0, t1] as merged spans, from
    the dispatcher's oom-fence events."""
    raw = {}
    for e in events:
        if e.kind == "oom-fence":
            raw.setdefault(e.instance_id, []).append(
                (max(e.ts, t0), min(e.data["until"], t1)))
    out = {}
    for iid, spans in raw.items():
        merged = []
        for a, b in sorted(spans):
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            elif b > a:
                merged.append([a, b])
        out[iid] = merged
    return out


def ov_workflow(model, params, seed: int, vocab: int) -> dict:
    """Part 6: the workflow phase's QA burst on pools of OV_WF_BLOCKS,
    under an oom storm planned on both instances at once, with the
    dispatcher's OOM feedback and without."""
    from repro_torch.serving import FaultPlan, FaultSpec
    plan = FaultPlan([FaultSpec("oom", i, s) for i in (0, 1)
                      for s in OV_WF_OOM_STEPS])
    out = {"num_blocks": OV_WF_BLOCKS, "tasks": WF_TASKS,
           "plan": [dataclasses.astuple(s) for s in plan]}
    for key, feedback in (("oom_feedback", True), ("no_oom_feedback", False)):
        wf, ids, results, _, t0, wall, totals, _ = run_workflow(
            model, params, seed, WF_TASKS,
            config=dict(WF_CONFIG, num_blocks=OV_WF_BLOCKS),
            cluster_kwargs=dict(faults=plan, oom_feedback=feedback))
        rep = workflow_report(wf, ids, results, t0, wall, vocab, totals)
        iters = sum(i["iterations"] for i in rep["instances"].values())
        require(iters <= OV_WF_ITERATION_BUDGET,
                f"{iters} engine iterations for the burst")
        require(wf.cluster.faults.n_fired == len(plan),
                f"{wf.cluster.faults.n_fired} of {len(plan)} ooms fired")
        spans = fence_spans(wf.tracer.events(), t0, t0 + wall)
        both = 0.0
        for a0, a1 in spans.get(0, []):
            for b0, b1 in spans.get(1, []):
                both += max(0.0, min(a1, b1) - max(a0, b0))
        out[key] = {
            "wall_s": wall, "e2e_median_s": rep["e2e_median_s"],
            "e2e_p90_s": rep["e2e_p90_s"], "per_agent": rep["per_agent"],
            "engine_iterations": iters,
            "cluster_steps": rep["host_s_by_part"]["cluster_step"]["calls"],
            "instances": {
                label: {"n_preempted": inst["n_preempted"],
                        "iterations": inst["iterations"],
                        "oom_fences": len(spans.get(int(label[6:]), [])),
                        "fenced_s": sum(b - a for a, b in spans.get(
                            int(label[6:]), []))}
                for label, inst in rep["instances"].items()},
            "both_fenced_s": both}
        del wf
        release_pools()
    require(any(i["oom_fences"] for i in out["oom_feedback"][
        "instances"].values()), "the oom storm fenced nothing")
    require(not any(i["oom_fences"] for i in out["no_oom_feedback"][
        "instances"].values()), "a fence without OOM feedback")
    return out


def phase_overload(state, seed: int):
    from repro_torch import serving
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.kernels.ragged_attention import ragged_segment_attention
    from repro_torch.obs import Tracer
    release_pools()
    cfg = full_config()
    vocab = cfg.vocab_size
    t0 = time.perf_counter()
    pool, schedules = ov_pool(seed, vocab)
    replay_s = time.perf_counter() - t0
    replay = schedules[f"new_{OV_NEW}"][pool]
    model, params = served(cfg, seed)
    # warm-up: one request through an engine, and a small pipelined
    # cluster (each dispatch thread's cuBLAS handle, the allocator)
    drain(engine_for(runner_for(model, params, num_blocks=pool)),
          (make_requests(serving, seed + 1, vocab)[0][:1], []))
    cluster_run(el_cluster(model, params, **OV_CHAOS),
                chaos_requests(serving, seed + 1, vocab)[:3])
    release_pools()
    tracer = Tracer()
    out = {"model": "qwen3-1.7b", "layers": cfg.num_layers,
           "dtype": cfg.dtype, "card": state["smi"], "pool_blocks": pool,
           "host_schedule_replays": schedules,
           "host_schedule_replays_s": replay_s,
           "drain_phase_4096_blocks_32_new_tokens": state.get(
               "drain_summary")}
    paged_attention.launches = 0
    ragged_segment_attention.launches = 0
    out["preempting_drain"] = ov_preempting_drains(model, params, seed,
                                                   vocab, pool, replay)
    out["chaos"], base, (plan, deadline) = ov_chaos(model, params, seed,
                                                    vocab, tracer)
    out["failed_transfer"] = ov_transfer(model, params, seed, vocab, base)
    out["memory_aware_dispatch"] = ov_workflow(model, params, seed, vocab)
    launches = {"paged_attention": paged_attention.launches,
                "ragged_segment_attention": ragged_segment_attention.launches}
    state["overload_launches"] = launches
    require(min(launches.values()) > 0, f"a kernel never launched: {launches}")
    out["kernel_launches"] = launches
    del model, params
    release_pools()

    cfg32 = dataclasses.replace(cfg, num_layers=4, dtype="float32")
    model32, params32 = served(cfg32, seed)
    out["identity"] = ov_identity(model32, params32, seed, vocab, pool,
                                  replay, tracer)
    out["chaos"]["float32"] = ov_chaos_float32(model32, params32, seed,
                                               vocab, plan, deadline)
    export = el_export(tracer)
    missing = {"preempt", "evict", "failure-detected", "recovery-replay",
               "oom-fence", "fault-injected"} - set(export["by_kind"])
    require(not missing, f"the trace lacks {sorted(missing)}")
    out["export"] = export
    return out


def kernels_line(state):
    """One row per kernel.  ``launches`` counts the MoE drain's fused
    path (phase 7), and the times, bound and error are at its shape (KV
    16, G 1, hd 128; 16 decode sequences at contexts 256-4096, 4 chunks
    of 512), bf16.  ``launches_by_path`` holds every phase's count, the
    training and dry-run phases' 0 included (they run the model-level
    attention), the tensor-parallel phase's, summed over its ranks, and
    the overload phase's bf16 runs.  ``by_shape`` holds the qwen3-1.7b
    shape and the other served head shapes."""
    rows = []
    for name, src, replaces, bodies in (
            ("paged_attention", PAGED_SRC,
             "src/repro/kernels/paged_attention.py:80",
             {"bfloat16": "paged_attention_split_kernel (CUDA cores)",
              "float32": "paged_attention_split_kernel (CUDA cores)"}),
            ("ragged_segment_attention", RAGGED_SRC,
             "src/repro/kernels/ragged_attention.py:108",
             {"bfloat16": "ragged_attention_tc_kernel (wgmma tensor cores)",
              "float32": "ragged_attention_kernel (fp32 CUDA cores, "
                         "attend_rows of csrc/attention_tile.cuh)"})):
        t = state["shape_timing"]["qwen2-moe"][name]
        short = name.split("_")[0]
        by_shape = {"qwen3-1.7b": state["timing"][name],
                    **{k: v[name] for k, v in state["shape_timing"].items()}}
        rows.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": state["moe_launches"][name],
            "launches_by_path": {
                "drain": state["launches"][name],
                "workflow": state["workflow_launches"][name],
                "elastic": state["elastic_launches"][name],
                "moe": state["moe_launches"][name],
                "families": state["families_launches"][name],
                "train": state["train_launches"][name],
                "dryrun": state["dryrun_launches"][name],
                "tensor_parallel": state["tp_launches"][name],
                "overload": state["overload_launches"][name]},
            "max_abs_err":
                state["shape_errs"]["qwen2-moe"][f"{short}_bfloat16_full"],
            "ms": t["kernel_ms"], "plain_ms": t["ref_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "bound_share": t["bound_share"],
            "vs_library": t["vs_library"],
            "timing": "CUDA-graph replay of back-to-back calls",
            "eager_ms": t["kernel_eager_ms"],
            "plain_eager_ms": t["ref_eager_ms"],
            "library_eager_ms": t["library_eager_ms"],
            "dtype": "bfloat16", "body_by_dtype": bodies,
            "shape": t["shape"],
            "by_shape": {k: {f: v[f] for f in (
                "kernel_ms", "ref_ms", "library_ms", "bound_ms", "bound_by",
                "bound_share", "shape")} for k, v in by_shape.items()},
            "max_abs_err_by_dtype": {
                k: v for k, v in state["errs"][name].items()
                if not k.endswith("_full")},
            "max_abs_err_by_head_shape": {
                k: {d: v[f"{short}_{d}"] for d in ("float32", "bfloat16")}
                for k, v in state["shape_errs"].items()},
            "card": state["smi"]})
    return {"kernels": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    # one process of the tensor_parallel phase: RANK WORLD DIR
    ap.add_argument("--tp-worker", nargs=3, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the "
              "card only", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 2
    # float32 is held to the plain versions at float32 precision
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.tp_worker:
        rank, world, tmp = args.tp_worker
        tp_worker(int(rank), int(world), tmp, args.seed)
        return 0

    state = {}
    phases = (("build", lambda: phase_build(state)),
              ("kernels", lambda: phase_kernels(state, args.seed)),
              ("drain", lambda: phase_drain(state, args.seed)),
              ("identity", lambda: phase_identity(state, args.seed)),
              ("workflow", lambda: phase_workflow(state, args.seed)),
              ("elastic", lambda: phase_elastic(state, args.seed)),
              ("moe", lambda: phase_moe(state, args.seed)),
              ("families", lambda: phase_families(state, args.seed)),
              ("train", lambda: phase_train(state, args.seed)),
              ("dryrun", lambda: phase_dryrun(state, args.seed)),
              ("tensor_parallel",
               lambda: phase_tensor_parallel(state, args.seed)),
              ("overload", lambda: phase_overload(state, args.seed)))
    for name, run in phases:
        t0 = time.perf_counter()
        try:
            result = run()
            torch.cuda.synchronize()
        except Exception as e:
            traceback.print_exc()
            emit({"phase": name, "ok": False,
                  "error": f"{type(e).__name__}: {e}"})
            return 1
        emit({"phase": name, "ok": True,
              "seconds": time.perf_counter() - t0, **result})
    emit(kernels_line(state))
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
