"""The port's CUDA kernels and engine on the card.

Every test here needs an NVIDIA card: each carries the ``cuda`` marker and
skips without one.  The file imports no JAX (the machine with the card
has none), so on that machine it runs as

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

``chip_smoke.py`` runs the same checks, and more, at full width.  The
input helpers below are shared with ``tests/test_torch_kernels.py``.
Tolerances: f32 2e-5, bf16 2e-2, as ``tests/test_kernels.py``.
"""
import dataclasses
import gc
import threading
import weakref

import numpy as np
import pytest
import torch

from repro_torch import serving
from repro_torch.configs import get_config
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.kernels.ragged_attention import ragged_segment_attention
from repro_torch.kernels.ref import (
    paged_attention_ref,
    ragged_segment_attention_ref,
)
from repro_torch.models import LanguageModel

# the sweeps of tests/test_kernels.py
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

TORCH_DTYPES = {"float32": (torch.float32, 2e-5),
                "bfloat16": (torch.bfloat16, 2e-2)}


def paged_case(seed, b, kv, g, hd, bs, nb, n_pool):
    """float32 numpy inputs: q, pools, unique block tables, context lens."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, kv, g, hd), np.float32)
    kp = rng.standard_normal((n_pool, bs, kv, hd), np.float32)
    vp = rng.standard_normal((n_pool, bs, kv, hd), np.float32)
    bt = rng.permutation(n_pool)[:b * nb].reshape(b, nb).astype(np.int32)
    cl = rng.integers(1, nb * bs + 1, b).astype(np.int32)
    return q, kp, vp, bt, cl


def ragged_case(seed, seg_specs, kv, g, hd, bs, nb, n_pool):
    """Segments of (length, n_cached) tiled to a dense (S, L) block with
    padding rows at position 0."""
    rng = np.random.default_rng(seed)
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


def to_torch(arrays, tdt, device="cpu"):
    return [torch.from_numpy(a).to(device=device, dtype=tdt)
            if a.dtype == np.float32 else torch.from_numpy(a).to(device)
            for a in arrays]


def assert_close(actual, expected, tol):
    np.testing.assert_allclose(np.asarray(actual, np.float32),
                               np.asarray(expected, np.float32),
                               rtol=tol, atol=tol)


def as_np(t: torch.Tensor) -> np.ndarray:
    return t.float().cpu().numpy()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py runs these there)")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(TORCH_DTYPES))
def test_cuda_paged_kernel_matches_ref(cuda, dtype):
    tdt, tol = TORCH_DTYPES[dtype]
    for shape in SHAPES:
        args = to_torch(paged_case(42, *shape), tdt, cuda)
        assert_close(as_np(paged_attention(*args)),
                     as_np(paged_attention_ref(*args)), tol)
    q, kp, vp, bt, _ = to_torch(paged_case(0, *SHAPES[0]), tdt, cuda)
    zero = paged_attention(q, kp, vp, bt,
                           torch.zeros(len(q), dtype=torch.int32,
                                       device=cuda))
    assert not zero.any(), "cl = 0 gives zero rows"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(TORCH_DTYPES))
def test_cuda_ragged_kernel_matches_ref(cuda, dtype):
    tdt, tol = TORCH_DTYPES[dtype]
    for case in RAGGED_SWEEP:
        args = to_torch(ragged_case(11, *case), tdt, cuda)
        out = as_np(ragged_segment_attention(*args))
        assert not np.isnan(out).any()
        assert_close(out, as_np(ragged_segment_attention_ref(*args)), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("g", [1, 2, 4, 8])
@pytest.mark.parametrize("dtype", list(TORCH_DTYPES))
def test_cuda_paged_kernel_split_edges(cuda, dtype, g):
    """Contexts at, one before and one past the kernel's split boundaries,
    shorter than one split, and a whole table, for G 1 / 2 / 4 / 8."""
    from repro_torch.kernels.paged_attention import SPLIT_TOKENS
    tdt, tol = TORCH_DTYPES[dtype]
    sp = SPLIT_TOKENS
    q, kp, vp, bt, _ = paged_case(5, 8, 2, g, 128, 16, 3 * sp // 16, 512)
    cl = np.array([1, 17, sp - 1, sp, sp + 1, 2 * sp, 2 * sp + 1, 3 * sp],
                  np.int32)
    args = to_torch((q, kp, vp, bt, cl), tdt, cuda)
    out = as_np(paged_attention(*args))
    assert_close(out, as_np(paged_attention_ref(*args)), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("g", [1, 2, 4, 8])
@pytest.mark.parametrize("dtype", list(TORCH_DTYPES))
def test_cuda_ragged_kernel_tile_edges(cuda, dtype, g):
    """Chunks whose length is not a multiple of the row tile and whose
    offsets are not a multiple of the 64-token key tile, for G 1 / 2 / 4
    / 8."""
    tdt, tol = TORCH_DTYPES[dtype]
    case = ([(100, 37), (65, 0), (1, 63), (130, 64)], 2, g, 64, 16, 13, 64)
    args = to_torch(ragged_case(6, *case), tdt, cuda)
    out = as_np(ragged_segment_attention(*args))
    assert not np.isnan(out).any()
    assert_close(out, as_np(ragged_segment_attention_ref(*args)), tol)


@pytest.mark.cuda
def test_cuda_kernels_never_read_past_the_bounds(cuda):
    """NaN past a sequence's context (decode) or past a segment's page
    bound (ragged) changes no bit of the kernels' output."""
    q, kp, vp, bt, _ = to_torch(paged_case(7, 1, 2, 2, 64, 8, 4, 32),
                                torch.float32, cuda)
    cl = torch.tensor([11], dtype=torch.int32, device=cuda)
    out = paged_attention(q, kp, vp, bt, cl)
    kp2, vp2 = kp.clone(), vp.clone()
    kp2[bt[0, 1], 3:] = float("nan")        # tokens 11.. of page 1
    vp2[bt[0, 2:].long()] = float("nan")
    assert torch.equal(out, paged_attention(q, kp2, vp2, bt, cl))

    q, kp, vp, bt, pos = to_torch(
        ragged_case(3, [(4, 6), (2, 0)], 2, 2, 64, 8, 4, 40), torch.float32,
        cuda)
    out = ragged_segment_attention(q, kp, vp, bt, pos)
    bt2 = bt.clone()
    bt2[0, 2:] = 39                 # bounds: page 1 and page 0
    bt2[1, 1:] = 39
    kp2, vp2 = kp.clone(), vp.clone()
    kp2[39] = 1e4
    vp2[39] = float("nan")
    assert torch.equal(out, ragged_segment_attention(q, kp2, vp2, bt2, pos))


@pytest.mark.cuda
def test_cuda_engine_matches_ref_drain(cuda):
    """The engine on the CUDA kernels drains token-identically to the
    plain versions on the card (reduced qwen3-1.7b, fp32, chunked prefill,
    prefix cache and preemption), launching both kernels."""
    cfg = dataclasses.replace(get_config("qwen3-1.7b").reduced(),
                              dtype="float32")
    model = LanguageModel(cfg)
    params = model.init_params(torch.Generator(cuda).manual_seed(0), cuda)
    outs = {}
    for backend in ("ref", "cuda"):
        serving.reset_request_ids()
        runner = serving.PagedModelRunner(model, params, num_blocks=18,
                                          block_size=8, max_batch=4,
                                          backend=backend, device=cuda)
        eng = serving.LLMEngine(runner, max_batch=4, enable_prefix_cache=True,
                                prefill_chunk_tokens=8)
        rng = np.random.default_rng(3)
        system = rng.integers(0, 500, 8)
        for i in range(5):
            toks = np.concatenate([system, rng.integers(0, 500, 19 + i)])
            eng.submit(serving.Request(
                agent_name="a", msg_id=f"m{i}", prompt_len=len(toks),
                prompt_tokens=toks.astype(np.int32), max_new_tokens=10,
                arrival_time=float(i)))
        before = (paged_attention.launches, ragged_segment_attention.launches)
        done = eng.run_until_drained(4000)
        launched = (paged_attention.launches - before[0],
                    ragged_segment_attention.launches - before[1])
        assert len(done) == 5
        assert (min(launched) > 0) == (backend == "cuda")
        outs[backend] = sorted((r.msg_id, tuple(int(t) for t in
                                                r.output_tokens))
                               for r in done)
    assert outs["cuda"] == outs["ref"]


# the head shapes the served families give the kernels at full width:
# (KV, G, hd) of qwen2-moe-a2.7b, stablelm-3b and llama3.2-3b
HEAD_SHAPES = {"qwen2-moe": (16, 1, 128), "stablelm": (32, 1, 80),
               "llama3.2": (8, 3, 128)}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(HEAD_SHAPES))
@pytest.mark.parametrize("dtype", list(TORCH_DTYPES))
def test_cuda_kernels_at_served_head_shapes(cuda, dtype, shape):
    """Both kernels against their plain versions at G = 1, hd 80 and
    G = 3, with contexts that cross the decode splits and chunks that
    cross the ragged kernel's row and key tiles."""
    tdt, tol = TORCH_DTYPES[dtype]
    kv, g, hd = HEAD_SHAPES[shape]
    args = to_torch(paged_case(5, 3, kv, g, hd, 16, 40, 128), tdt, cuda)
    assert_close(as_np(paged_attention(*args)),
                 as_np(paged_attention_ref(*args)), tol)
    args = to_torch(ragged_case(6, [(130, 37), (65, 0), (1, 300)], kv, g, hd,
                                16, 24, 96), tdt, cuda)
    assert_close(as_np(ragged_segment_attention(*args)),
                 as_np(ragged_segment_attention_ref(*args)), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("arch, shape", [
    ("qwen2-moe-a2.7b", dict(num_kv_heads=4)),
    ("llama3.2-3b", dict(num_heads=6, num_kv_heads=2)),
    ("stablelm-3b", dict(num_kv_heads=4, head_dim=80)),
], ids=["moe-G1", "G3", "hd80"])
def test_cuda_engine_serves_the_families_head_shapes(cuda, arch, shape):
    """The reduced MoE model and the G = 3 and hd-80 decoders drain on the
    CUDA kernels token-identically to the plain versions (fp32, chunked
    prefill, prefix cache), launching both kernels."""
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                              **shape)
    model = LanguageModel(cfg)
    params = model.init_params(torch.Generator(cuda).manual_seed(0), cuda)
    outs = {}
    for backend in ("ref", "cuda"):
        serving.reset_request_ids()
        runner = serving.PagedModelRunner(model, params, num_blocks=64,
                                          block_size=8, max_batch=4,
                                          backend=backend, device=cuda)
        eng = serving.LLMEngine(runner, max_batch=4, enable_prefix_cache=True,
                                prefill_chunk_tokens=16)
        rng = np.random.default_rng(3)
        system = rng.integers(0, 500, 16)
        for i in range(4):
            toks = np.concatenate([system, rng.integers(0, 500, 9 + 5 * i)])
            eng.submit(serving.Request(
                agent_name="a", msg_id=f"m{i}", prompt_len=len(toks),
                prompt_tokens=toks.astype(np.int32), max_new_tokens=8))
        before = (paged_attention.launches, ragged_segment_attention.launches)
        done = eng.run_until_drained(4000)
        launched = (paged_attention.launches - before[0],
                    ragged_segment_attention.launches - before[1])
        assert (min(launched) > 0) == (backend == "cuda")
        outs[backend] = sorted((r.msg_id, tuple(int(t) for t in
                                                r.output_tokens))
                               for r in done)
    assert outs["cuda"] == outs["ref"]


def _stream_engines(cuda):
    """Two engines on one card (reduced qwen3-1.7b, bf16, seeded weights),
    each with 4 requests whose contexts span 2-4 of the decode kernel's
    256-token splits, so every decode launch runs the split merge."""
    cfg = get_config("qwen3-1.7b").reduced()
    model = LanguageModel(cfg)
    params = model.init_params(torch.Generator(cuda).manual_seed(0), cuda)
    runner = serving.PagedModelRunner(model, params, num_blocks=512,
                                      block_size=16, max_batch=8, device=cuda)
    engines = [serving.LLMEngine(r, instance_id=i, max_batch=8)
               for i, r in enumerate((runner, runner.clone()))]
    for i, e in enumerate(engines):
        rng = np.random.default_rng(i)
        for j in range(4):
            toks = rng.integers(0, 500, int(rng.integers(300, 900)))
            e.submit(serving.Request(
                agent_name="a", msg_id=f"e{i}r{j}", prompt_len=len(toks),
                prompt_tokens=toks.astype(np.int32), max_new_tokens=24))
    return engines


def _drain_on(engine, stream, out):
    with torch.cuda.stream(stream):
        done = engine.run_until_drained(4000)
    out[engine.instance_id] = sorted(
        (r.msg_id, tuple(int(t) for t in r.output_tokens)) for r in done)


@pytest.mark.cuda
def test_cuda_two_engines_on_two_streams_match_serial(cuda):
    """Two engines stepped from two threads, each on its own stream, give
    the same tokens as the same engines drained one after the other on
    the default stream.  Their decode launches overlap on the card, so
    the split merge's arrival counters must be per stream (per-device
    counters let one stream's blocks count the other's arrivals)."""
    serving.reset_request_ids()
    serial = {}
    for e in _stream_engines(cuda):
        _drain_on(e, torch.cuda.current_stream(cuda), serial)
    serving.reset_request_ids()
    engines = _stream_engines(cuda)
    before = paged_attention.launches
    concurrent = {}
    threads = [threading.Thread(target=_drain_on,
                                args=(e, torch.cuda.Stream(cuda), concurrent))
               for e in engines]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    torch.cuda.synchronize(cuda)
    assert paged_attention.launches > before
    assert concurrent == serial and len(serial) == 2


@pytest.mark.cuda
def test_cuda_pipelined_cluster_steps_from_the_calling_thread(cuda):
    """Two engines on one card in a pipelined cluster: the steps start no
    worker thread, the streams equal the serial loop's, and engine 0's
    sync waits for its own step only.  With a 0.2 s device spin launched
    ahead of engine 1's step on the same stream, engine 0's tokens are on
    the host while engine 1's step is still running, in every step in
    which both engines run an iteration."""
    from repro_torch.core import HardwareProfile, Orchestrator
    spin_cycles = int(0.2 * 2e9)

    def drain(pipelined, hold=False):
        serving.reset_request_ids()
        engines = _stream_engines(cuda)
        cluster = serving.ServingCluster(
            engines, Orchestrator(hardware=HardwareProfile(
                decode_tok_per_s=20.0, kv_capacity_tokens=512 * 16)),
            pipelined=pipelined)
        ahead = []
        if hold:
            e0, e1 = engines
            dispatch1, sync0 = e1.dispatch_iteration, e0.sync

            def held_dispatch():
                torch.cuda._sleep(spin_cycles)
                return dispatch1()

            def own_sync():
                sync0()
                if e0._pending is not None and e1._pending is not None:
                    ahead.append(not e1._pending[1]._copied.query())

            e1.dispatch_iteration, e0.sync = held_dispatch, own_sync
        before = set(threading.enumerate())
        done = cluster.drain()
        started = set(threading.enumerate()) - before
        cluster.close()
        torch.cuda.synchronize(cuda)
        streams = sorted((r.msg_id, tuple(int(t) for t in r.output_tokens))
                         for r in done)
        return streams, cluster, started, ahead

    serial, _, _, _ = drain(False)
    streams, cluster, started, _ = drain(True)
    held, _, _, ahead = drain(True, hold=True)
    assert len(serial) == 8 and streams == serial and held == serial
    assert not [t for t in started if t.name.startswith("cluster-dispatch")]
    assert cluster._pool is None and cluster.n_pooled_dispatches == 0
    assert cluster.n_inline_dispatches > 0
    assert len(ahead) > 3 and all(ahead), ahead


@pytest.mark.cuda
def test_cuda_crash_storm_recovers_and_frees_dead_pools(cuda):
    """A 3-instance cluster on the card survives the crash storm of
    tests/test_faults_recovery.py with the fault-free streams, and the
    two dead instances' KV pools (67 MB each) leave device memory: no
    reference to them survives, and the allocated bytes fall by at least
    their size less 16 MiB (what a drain may keep, such as a new cuBLAS
    workspace)."""
    cfg = get_config("qwen3-1.7b").reduced()
    model = LanguageModel(cfg)
    params = model.init_params(torch.Generator(cuda).manual_seed(0), cuda)
    config = serving.ServingConfig(num_blocks=4096, block_size=16,
                                   max_batch=4, n_instances=3, policy="fcfs",
                                   prefix_caching=True)

    def drain(plan):
        from repro_torch.core import HardwareProfile, Orchestrator
        serving.reset_request_ids()
        orch = Orchestrator(hardware=HardwareProfile(
            decode_tok_per_s=20.0, kv_capacity_tokens=4096 * 16))
        cluster = serving.ServingCluster.from_config(
            model, params, orch, config, faults=plan, device=cuda)
        pool_bytes = cluster.engines[0].runner.metrics_snapshot()["pool_bytes"]
        pools = [weakref.ref(e.runner._pool_buf) for e in cluster.engines]
        rng = np.random.default_rng(7)
        prefix = rng.integers(0, 500, 32)
        for i in range(8):
            toks = np.concatenate([prefix, rng.integers(0, 500, 9 + i)])
            cluster.submit(serving.Request(
                agent_name=f"a{i % 3}", msg_id=f"m{i}", prompt_len=len(toks),
                prompt_tokens=toks.astype(np.int32), max_new_tokens=10,
                arrival_time=float(i)))
        torch.cuda.synchronize(cuda)
        before = torch.cuda.memory_allocated(cuda)
        done = cluster.drain()
        cluster.close()
        streams = {r.msg_id: [int(t) for t in r.output_tokens] for r in done}
        snap = cluster.metrics_snapshot()
        gc.collect()
        torch.cuda.synchronize(cuda)
        freed = before - torch.cuda.memory_allocated(cuda)
        dead = sum(ref() is None for ref in pools)
        return streams, snap, (freed, dead), pool_bytes

    base, _, _, _ = drain(None)
    plan = serving.FaultPlan.generate(5, [0, 1, 2], horizon=10, n_crashes=2,
                                      spare=(0,))
    streams, snap, (freed, dead), pool_bytes = drain(plan)
    assert len(base) == 8 and streams == base
    assert snap["n_crashes"] == 2 and snap["n_instances"] == 1
    assert dead == 2
    assert freed >= 2 * pool_bytes - 16 * 2**20, (freed, pool_bytes)


@pytest.mark.cuda
def test_cuda_quickstart_runs_on_the_card(cuda, capsys):
    from repro_torch import quickstart
    assert quickstart.main([]) == 0
    assert "QUICKSTART OK" in capsys.readouterr().out


# =============================================================================
# the elastic slice's callers of the kernels
# =============================================================================


@pytest.mark.cuda
def test_cuda_read_write_blocks_bf16_bit_round_trip(cuda):
    """``write_blocks`` puts raw bfloat16 bits into the pool on the card
    in place and ``read_blocks`` hands back the same bits as ``uint16``;
    blocks not written keep theirs and the pool does not move."""
    cfg = get_config("qwen3-1.7b").reduced()
    model = LanguageModel(cfg)
    params = model.init_params(torch.Generator(cuda).manual_seed(0), cuda)
    runner = serving.PagedModelRunner(model, params, num_blocks=32,
                                      block_size=8, max_batch=2, device=cuda)
    rng = np.random.default_rng(0)
    shape = tuple(runner.pool.shape[:2]) + (6,) + tuple(runner.pool.shape[3:])
    bits = rng.integers(0, 2 ** 16, shape, dtype=np.uint16)
    bits[(bits & 0x7F80) == 0x7F80] = 0       # no NaN/inf patterns
    ids = [31, 0, 4, 17, 9, 22]
    addr = runner.pool_address()
    before = runner.read_blocks([1, 2, 3])
    runner.write_blocks(bits, ids)
    assert runner.pool_address() == addr
    got = runner.read_blocks(ids)
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, bits)
    np.testing.assert_array_equal(runner.read_blocks([4, 9]),
                                  bits[:, :, [2, 4]])
    np.testing.assert_array_equal(runner.read_blocks([1, 2, 3]), before)
    assert runner.pool_address() == addr


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(TORCH_DTYPES))
def test_cuda_paged_kernel_on_dead_row_batches(cuda, dtype):
    """The legacy decode step's batch: live rows padded with dead rows of
    context 1 and all-zero tables.  The kernel matches its plain version
    on every row."""
    tdt, tol = TORCH_DTYPES[dtype]
    q, kp, vp, bt, cl = to_torch(paged_case(5, 8, 2, 4, 64, 8, 6, 64), tdt,
                                 cuda)
    bt[3:] = 0
    cl[3:] = 1
    assert_close(as_np(paged_attention(q, kp, vp, bt, cl)),
                 as_np(paged_attention_ref(q, kp, vp, bt, cl)), tol)


@pytest.mark.cuda
def test_cuda_decode_batch_dead_rows_match_plain(cuda):
    """``decode_batch`` on the CUDA paged kernel and on the plain version,
    on the card, from the same pool: the live rows' logits agree (fp32),
    the kernel launched once per layer, and the dead rows wrote only the
    spare block."""
    cfg = dataclasses.replace(get_config("qwen3-1.7b").reduced(),
                              dtype="float32")
    model = LanguageModel(cfg)
    params = model.init_params(torch.Generator(cuda).manual_seed(0), cuda)
    runners = {b: serving.PagedModelRunner(model, params, num_blocks=16,
                                           block_size=8, max_batch=4,
                                           backend=b, device=cuda)
               for b in ("cuda", "ref")}
    rng = np.random.default_rng(1)
    p1 = torch.as_tensor(rng.integers(0, 500, 11), dtype=torch.int32)
    p2 = torch.as_tensor(rng.integers(0, 500, 5), dtype=torch.int32)
    for r in runners.values():
        r.prefill(p1, [2, 6])
        r.prefill(p2, [9])
    tok = np.array([17, 23, 0, 0], np.int32)
    pos = np.array([11, 5, 0, 0], np.int32)
    tab = np.array([[2, 6, 0], [9, 0, 0], [0, 0, 0], [0, 0, 0]], np.int32)
    live = np.array([True, True, False, False])
    pool0 = runners["cuda"]._pool_buf.clone()
    before = paged_attention.launches
    got = runners["cuda"].decode_batch(tok, pos, tab, live)
    assert paged_attention.launches - before == cfg.num_layers
    want = runners["ref"].decode_batch(tok, pos, tab, live)
    assert_close(as_np(got[:2]), as_np(want[:2]), 1e-4)
    changed = (runners["cuda"]._pool_buf != pool0).flatten(4).any(-1)
    slots = {tuple(x) for x in
             torch.nonzero(changed.any(0).any(0)).cpu().tolist()}
    assert slots <= {(6, 3), (9, 5), (16, 0)} and (16, 0) in slots
    assert_close(as_np(runners["cuda"].pool), as_np(runners["ref"].pool),
                 1e-5)


@pytest.mark.cuda
def test_cuda_migrate_many_between_two_engines(cuda):
    """Mid-decode requests move between two engines on the card in one
    gathered ``write_blocks``: the target's blocks read back bit-equal to
    the snapshots, neither pool moves, and the continued fp32 streams
    equal an unmigrated drain's."""
    cfg = dataclasses.replace(get_config("qwen3-1.7b").reduced(),
                              dtype="float32")
    model = LanguageModel(cfg)
    params = model.init_params(torch.Generator(cuda).manual_seed(0), cuda)

    def engine(iid):
        r = serving.PagedModelRunner(model, params, num_blocks=64,
                                     block_size=8, max_batch=4, device=cuda)
        return serving.LLMEngine(r, instance_id=iid, max_batch=4,
                                 enable_prefix_cache=True)

    def reqs():
        rng = np.random.default_rng(5)
        system = rng.integers(0, 500, 16)
        return [serving.Request(
            agent_name="a", msg_id=f"m{i}", prompt_len=25 + i,
            prompt_tokens=np.concatenate(
                [system, rng.integers(0, 500, 9 + i)]).astype(np.int32),
            max_new_tokens=12) for i in range(4)]

    def drain(*engines):
        done = []
        for _ in range(4000):
            for e in engines:
                done.extend(e.step())
            if not any(e.sched.has_work for e in engines):
                return {r.msg_id: [int(t) for t in r.output_tokens]
                        for r in done}
        raise AssertionError("drain did not converge")

    serving.reset_request_ids()
    base_engine = engine(0)
    for q in reqs():
        base_engine.submit(q)
    base = drain(base_engine)
    serving.reset_request_ids()
    e0, e1 = engine(0), engine(1)
    for q in reqs():
        e0.submit(q)
    done = []
    for _ in range(3):
        done.extend(e0.step())
    a0, a1 = e0.runner.pool_address(), e1.runner.pool_address()
    d1 = e1.runner.n_dispatches
    snaps, skipped = serving.migrate_many(e0, e1, list(e0.sched.running))
    assert snaps and not skipped
    assert e1.runner.n_dispatches - d1 == 1
    for s in snaps:
        table = e1.bm.block_table(s.req.req_id)
        n = e1.bm.blocks_needed(s.n_resident_tokens)
        c = s.n_cached_blocks
        np.testing.assert_array_equal(e1.runner.read_blocks(table[c:n]),
                                      s.kv[:, :, c:n])
    assert (e0.runner.pool_address(), e1.runner.pool_address()) == (a0, a1)
    out = {r.msg_id: [int(t) for t in r.output_tokens] for r in done}
    out.update(drain(e0, e1))
    assert out == base


# =============================================================================
# excessive load and faults
# =============================================================================


def _overload_reqs(max_new):
    rng = np.random.default_rng(7)
    prefix = rng.integers(0, 500, 16)
    return [serving.Request(
        agent_name="a", msg_id=f"m{i}", prompt_len=21 + i,
        prompt_tokens=np.concatenate(
            [prefix, rng.integers(0, 500, 5 + i)]).astype(np.int32),
        max_new_tokens=max_new) for i in range(6)]


@pytest.mark.cuda
def test_cuda_tight_pool_eos_drain_matches_ref(cuda):
    """A pool tight enough to preempt, with ``eos_token`` set: the CUDA
    kernels drain token-identically to the plain versions on the card
    (reduced qwen3-1.7b, fp32), and every stream is the run without EOS
    cut before its first ``eos_token`` past the first token."""
    cfg = dataclasses.replace(get_config("qwen3-1.7b").reduced(),
                              dtype="float32")
    model = LanguageModel(cfg)
    params = model.init_params(torch.Generator(cuda).manual_seed(0), cuda)

    def run(backend, eos):
        serving.reset_request_ids()
        runner = serving.PagedModelRunner(model, params, num_blocks=12,
                                          block_size=8, max_batch=4,
                                          backend=backend, device=cuda)
        eng = serving.LLMEngine(runner, max_batch=4, enable_prefix_cache=True,
                                prefill_chunk_tokens=8, eos_token=eos)
        for q in _overload_reqs(16):
            eng.submit(q)
        done = eng.run_until_drained(4000)
        assert len(done) == 6
        return eng, {r.msg_id: [int(t) for t in r.output_tokens]
                     for r in done}

    eng, plain = run("cuda", -1)
    assert eng.stats.n_preempted > 0, "the pool must preempt"
    stops = {}
    for s in plain.values():
        for t in set(s[1:]):
            stops[t] = stops.get(t, 0) + 1
    eos = min(stops, key=lambda t: (-stops[t], t))
    assert stops[eos] >= 2, "no token stops two streams early"

    def cut(s):
        return next((s[:i] for i in range(1, len(s)) if s[i] == eos), s)

    _, got = run("cuda", eos)
    _, want = run("ref", eos)
    assert got == want
    assert got == {m: cut(s) for m, s in plain.items()}


@pytest.mark.cuda
def test_cuda_failed_transfer_rolls_back_bit_equal(cuda):
    """A planned transfer fault inside ``migrate_many`` on the card (bf16
    pools): the requests run on their source again, the target's free
    blocks are as before the call, the source's blocks read back with the
    same bits, and the streams equal a drain with no migration."""
    cfg = get_config("qwen3-1.7b").reduced()
    model = LanguageModel(cfg)
    params = model.init_params(torch.Generator(cuda).manual_seed(0), cuda)

    def engine(iid):
        r = serving.PagedModelRunner(model, params, num_blocks=64,
                                     block_size=8, max_batch=4, device=cuda)
        return serving.LLMEngine(r, instance_id=iid, max_batch=4,
                                 enable_prefix_cache=True)

    def streams(done):
        return {r.msg_id: [int(t) for t in r.output_tokens] for r in done}

    serving.reset_request_ids()
    base_engine = engine(0)
    for q in _overload_reqs(12):
        base_engine.submit(q)
    base = streams(base_engine.run_until_drained(4000))
    serving.reset_request_ids()
    e0, e1 = engine(0), engine(1)
    for q in _overload_reqs(12):
        e0.submit(q)
    done = []
    for _ in range(4):
        done.extend(e0.step())
    batch = list(e0.sched.running)

    def blocks(r):
        table = e0.bm.block_table(r.req_id)
        return e0.runner.read_blocks(table[:e0.bm.blocks_needed(
            r.prefilled_len + r.output_len)])

    before = [blocks(r) for r in batch]
    free = e1.bm.free_blocks
    faults = serving.FaultInjector(serving.FaultPlan(
        [serving.FaultSpec("transfer", 0, 0)]))
    with pytest.raises(serving.MigrationError) as err:
        serving.migrate_many(e0, e1, batch, faults=faults)
    assert isinstance(err.value.__cause__, serving.TransferFault)
    assert e1.bm.free_blocks == free and not e1.sched.running
    assert all(r in e0.sched.running for r in batch)
    for r, kv in zip(batch, before):
        assert kv.dtype == np.uint16
        np.testing.assert_array_equal(blocks(r), kv)
    done.extend(e0.run_until_drained(4000))
    assert streams(done) == base


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "qwen2-moe-a2.7b"])
def test_cuda_loss_and_grads_match_cpu(cuda, arch):
    """A reduced model's float32 loss and the gradient of every leaf on
    the card against the same port on the CPU from the same weights, at
    1e-4 with the absolute part scaled by the leaf's largest magnitude
    (the MoE combine's backward accumulates atomically on the card)."""
    from repro_torch.models import build_model
    from repro_torch.training.optimizer import tree_leaves, tree_map
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    model = build_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(1)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 32))
                                 .astype(np.int32))
             for k in ("tokens", "labels")}

    def loss_and_grads(device):
        tracked = tree_map(
            lambda p: p.detach().clone().to(device).requires_grad_(), params)
        loss, _ = model.loss(tracked, {k: v.to(device)
                                       for k, v in batch.items()})
        grads = torch.autograd.grad(loss, tree_leaves(tracked),
                                    allow_unused=True, materialize_grads=True)
        return [loss.detach()] + list(grads)

    for got, want in zip(loss_and_grads(cuda), loss_and_grads("cpu")):
        want = as_np(want)
        tol = 1e-4 * max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(as_np(got), want, rtol=1e-4, atol=tol)


@pytest.mark.cuda
def test_cuda_spans_share_the_profilers_clock(cuda):
    """The program's spans and ``torch.profiler`` read one clock: under the
    profiler, traced single-engine steps' CUDA runtime launch calls fall
    inside the steps' ``runner.upload`` / ``runner.launch`` spans, taken
    at their ``time.time_ns()`` ends (99 % at least), and every
    ``runner.launch`` holds at least one of them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs import Tracer
    cfg = dataclasses.replace(get_config("qwen3-1.7b").reduced(),
                              dtype="float32")
    model = LanguageModel(cfg)
    params = model.init_params(torch.Generator(cuda).manual_seed(0), cuda)
    tracer = Tracer()
    runner = serving.PagedModelRunner(model, params, num_blocks=64,
                                      block_size=8, max_batch=4, device=cuda)
    eng = serving.LLMEngine(runner, max_batch=4, enable_prefix_cache=True,
                            prefill_chunk_tokens=8, tracer=tracer)
    rng = np.random.default_rng(3)
    for i in range(4):
        toks = rng.integers(0, 500, 20 + i).astype(np.int32)
        eng.submit(serving.Request(
            agent_name="a", msg_id=f"m{i}", prompt_len=len(toks),
            prompt_tokens=toks, max_new_tokens=12))
    eng.step()                      # builds and warms the kernels
    torch.cuda.synchronize()
    tracer.clear()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(4):
            eng.step()
        torch.cuda.synchronize()
    launches = sorted(
        (e.start_ns(), e.start_ns() + e.duration_ns())
        for e in prof.profiler.kineto_results.events()
        if e.device_type() != DeviceType.CUDA and "LaunchKernel" in e.name())
    spans = [s for s in tracer.events() if s.kind == "span"
             and s.name in ("runner.upload", "runner.launch")]
    assert launches and len([s for s in spans
                             if s.name == "runner.launch"]) == 4

    def held(s, a, b):
        return s.start_ns <= a and b <= s.end_ns

    outside = [(a, b) for a, b in launches
               if not any(held(s, a, b) for s in spans)]
    assert len(outside) <= 0.01 * len(launches), (
        len(outside), len(launches), outside[:5],
        [(s.name, s.start_ns, s.end_ns) for s in spans])
    for s in spans:
        if s.name == "runner.launch":
            assert any(held(s, a, b) for a, b in launches), s
