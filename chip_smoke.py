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
             of tests/test_kernels.py, a head dim of 112 and the full-width
             qwen3-1.7b shapes, in float32 (tolerance 2e-5) and bfloat16
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

Then the per-kernel summary line, and last
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without CUDA, or without the rest of the repository beside it, the script
exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
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
    torch.cuda.synchronize()
    state["errs"] = errs
    return {"checks": checks, "max_abs_err": errs,
            "timing_bf16_full_width": state["timing"]}


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


def make_requests(mod, seed: int, vocab: int):
    """16 requests from 4 agents: each agent has a system prompt of
    256-1024 tokens, each request adds 64-512 tokens of its own and asks
    for 32 new tokens.  Returns (first wave: one request per agent, second
    wave: the other 12)."""
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
                                max_new_tokens=32,
                                shared_prefix_len=len(system[a])))
    return reqs[:4], reqs[4:]


def drain(engine, waves, max_iters: int = 2000):
    """Submit the first wave; submit the second once every first-wave
    request has its first token (so its system prompt is in the prefix
    cache); step until drained.  Returns (finished, iterations, the pool
    addresses seen, wall seconds, per-iteration (has prefill chunks,
    seconds))."""
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
        has_prefill = engine._pending[0].tokens_p.size > 0
        iters += 1
        done.extend(engine.collect(force_sync=True))
        steps.append((has_prefill, time.perf_counter() - t_step))
        addrs.add(engine.runner.pool_address())
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


def runner_for(model, params, backend=None):
    from repro_torch import serving
    return serving.PagedModelRunner(model, params, num_blocks=4096,
                                    block_size=16, max_batch=16,
                                    backend=backend, device=DEVICE)


def engine_for(runner):
    from repro_torch import serving
    serving.reset_request_ids()
    return serving.LLMEngine(runner, max_batch=16, enable_prefix_cache=True,
                             prefill_chunk_tokens=512)


def device_busy(profile_events, wall_s: float):
    """Busy and idle shares of the card over ``wall_s``, and each kernel
    family's share of the busy time, from a torch.profiler trace."""
    from torch.autograd import DeviceType
    spans, by_name, count = [], {}, {}
    for e in profile_events:
        if e.device_type != DeviceType.CUDA:
            continue
        s, t = e.time_range.start, e.time_range.end
        spans.append((s, t))
        name = e.name
        # paged_attention_split_kernel; ragged_attention_tc_kernel (bf16)
        # and ragged_attention_kernel (fp32)
        key = ("paged_attention" if "paged_attention" in name
               else "ragged_segment_attention"
               if "ragged_attention" in name
               else "gemm" if "gemm" in name.lower() or "cutlass" in name
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
    require(addrs == {addr}, "the pool moved during the drain")
    require(len(done) == 16, f"{len(done)} of 16 requests finished")
    for r in done:
        require(len(r.output_tokens) == 32 and all(
            0 <= int(t) < cfg.vocab_size for t in r.output_tokens),
            f"{r.msg_id}: bad output {r.output_tokens[:4]}...")
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


def record_margins(runner):
    """Hook the runner so every iteration records, per real segment row,
    the top-2 logit margin of its argmax and whether the logits were
    finite.  Returns (log, undo)."""
    import torch
    from repro_torch.serving import engine as engine_mod
    log, last = [], {}
    orig_logits, orig_run = engine_mod.lm_logits, runner.run_iteration

    def logits_hook(params, x, cfg):
        logits = orig_logits(params, x, cfg)
        top = logits.float().topk(2, dim=-1).values
        last["margin"] = top[:, 0] - top[:, 1]
        last["finite"] = torch.isfinite(logits).all()
        return logits

    def run_hook(batch):
        nxt = orig_run(batch)
        log.append(([(s.req.msg_id, s.kind == "decode" or s.emits_token)
                     for s in batch.segments], last["margin"],
                    last["finite"]))
        return nxt

    def undo():
        engine_mod.lm_logits = orig_logits
        runner.run_iteration = orig_run

    engine_mod.lm_logits = logits_hook
    runner.run_iteration = run_hook
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
    ref_streams, ref_margins, _ = runs["ref"]
    compared = identical = near_ties = 0
    min_margin = float("inf")
    for msg in sorted(ref_streams):
        c, r, m = cuda_streams[msg], ref_streams[msg], ref_margins[msg]
        require(len(c) == len(r) == len(m) == 32, f"{msg}: stream lengths")
        for i in range(32):
            if c[i] != r[i]:
                require(m[i] <= MARGIN, f"{msg} token {i}: cuda {c[i]} vs "
                        f"ref {r[i]} at margin {m[i]}")
                near_ties += 1
                break
            compared += 1
            min_margin = min(min_margin, m[i])
        else:
            identical += 1

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
    return {"layers": cfg.num_layers, "dtype": cfg.dtype,
            "streams": len(ref_streams), "identical_streams": identical,
            "tokens_compared": compared, "near_tie_divergences": near_ties,
            "min_margin_compared": min_margin,
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
                 pipelined: bool = True, profile: bool = False):
    """The QA app with ``n_tasks`` tasks submitted at once, on the
    cluster ``Workflow.add_engine`` would build, but at the given model's
    width.  Returns (workflow, msg ids, results, LLM calls, submit time,
    wall seconds, host seconds and calls by part, the torch.profiler
    events of the run's device activity when ``profile``)."""
    from repro_torch.agents import Workflow
    from repro_torch.obs import Tracer
    from repro_torch.serving import (
        ServingCluster,
        ServingConfig,
        reset_request_ids,
    )
    reset_request_ids()
    wf = Workflow(app_name="QA", config=ServingConfig(**WF_CONFIG),
                  tracer=Tracer(), device=device, pipelined=pipelined)
    # what add_engine does, on these weights
    wf.cluster = ServingCluster.from_config(
        model, params, wf.orch, wf.config, pipelined=wf.pipelined,
        tracer=wf.tracer, device=device)
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


def kernels_line(state):
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
        t = state["timing"][name]
        rows.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": state["workflow_launches"][name],
            "launches_by_path": {"drain": state["launches"][name],
                                 "workflow": state["workflow_launches"][name]},
            "max_abs_err": state["errs"][name]["bfloat16_full"],
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
            "max_abs_err_by_dtype": {
                k: v for k, v in state["errs"][name].items()
                if not k.endswith("_full")},
            "card": state["smi"]})
    return {"kernels": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
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

    state = {}
    phases = (("build", lambda: phase_build(state)),
              ("kernels", lambda: phase_kernels(state, args.seed)),
              ("drain", lambda: phase_drain(state, args.seed)),
              ("identity", lambda: phase_identity(state, args.seed)),
              ("workflow", lambda: phase_workflow(state, args.seed)))
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
