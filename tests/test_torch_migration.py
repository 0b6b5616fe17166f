"""The port's live request migration against the JAX package's.

The cases of ``tests/test_migration.py`` on the port, on the reduced
qwen3-1.7b in fp32 with the JAX weights carried across: a request
migrated mid-decode, mid-prefill, mid-block, with COW-shared blocks or
onto a warm target cache continues its token stream exactly as the JAX
package's unmigrated run of the same requests does.  Around that: stable
pool addresses on both sides, lossless refusal, snapshot contents, the
round-trip sweep, and transfer-fault rollback without leaks.

The transport itself is held bit for bit: the same bfloat16 bits written
into the JAX runner's and the port's pools read back equal, and a real
bfloat16 snapshot's layer-0 KV bits equal the JAX snapshot's (deeper
layers differ by rounding between the two frameworks' fused products,
so they are held to the bf16 tolerance).
"""
import dataclasses

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import serving as jserving
from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro_torch import serving as tserving
from repro_torch.configs import get_config
from repro_torch.models import LanguageModel, params_from_jax
from repro_torch.serving import (
    FaultInjector,
    FaultPlan,
    FaultSpec,
    LLMEngine,
    MigrationError,
    PagedModelRunner,
    Request,
    migrate,
    migrate_many,
    reset_request_ids,
    restore_request,
    snapshot_request,
)


def _models(dtype):
    jcfg = dataclasses.replace(jax_get_config("qwen3-1.7b").reduced(),
                               dtype=dtype)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    cfg = dataclasses.replace(get_config("qwen3-1.7b").reduced(),
                              dtype=dtype)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                             cfg, device="cpu")
    return jmodel, jparams, LanguageModel(cfg), params


@pytest.fixture(scope="module")
def models():
    """(JAX runner, port model, port params) in fp32; the JAX runner's
    clones share its compiled step functions."""
    jmodel, jparams, model, params = _models("float32")
    jrunner = jserving.PagedModelRunner(jmodel, jparams, num_blocks=64,
                                        block_size=8, max_batch=4)
    return jrunner, model, params


def _engine(models, iid, *, cache=True, chunk=None, num_blocks=64):
    _, model, params = models
    r = PagedModelRunner(model, params, num_blocks=num_blocks, block_size=8,
                         max_batch=4, device="cpu")
    return LLMEngine(r, instance_id=iid, max_batch=4,
                     enable_prefix_cache=cache, prefill_chunk_tokens=chunk)


def _reqs(mod, n=4, max_new=12, sys_len=16, uniq=9, seed=5):
    rng = np.random.default_rng(seed)
    sys_toks = rng.integers(0, 500, sys_len).astype(np.int32)
    out = []
    for i in range(n):
        toks = np.concatenate(
            [sys_toks, rng.integers(0, 500, uniq + i).astype(np.int32)])
        out.append(mod.Request(agent_name="a", msg_id=f"m{i}",
                               prompt_len=len(toks), prompt_tokens=toks,
                               max_new_tokens=max_new))
    return out


def _drain(*engines, max_steps=4000):
    done = []
    for _ in range(max_steps):
        for e in engines:
            done.extend(e.step())
        if not any(e.sched.has_work for e in engines):
            return done
    raise AssertionError("drain did not converge")


def _tokens(done):
    return {q.msg_id: [int(t) for t in q.output_tokens] for q in done}


_BASELINES = {}


def _jax_baseline(models, req_kw=None, *, cache=True, chunk=None):
    """The JAX package's unmigrated drain of the same requests."""
    key = (tuple(sorted((req_kw or {}).items())), cache, chunk)
    if key not in _BASELINES:
        jserving.reset_request_ids()
        e = jserving.LLMEngine(models[0].clone(), instance_id=0, max_batch=4,
                               enable_prefix_cache=cache,
                               prefill_chunk_tokens=chunk)
        for q in _reqs(jserving, **(req_kw or {})):
            e.submit(q)
        _BASELINES[key] = _tokens(_drain(e))
    return _BASELINES[key]


# ---------------------------------------------------------------------------
# deterministic round-trips
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("steps_before", [1, 2, 4, 7])
def test_mid_decode_migration_token_identical(models, steps_before):
    base = _jax_baseline(models)
    reset_request_ids()
    e0, e1 = _engine(models, 0), _engine(models, 1)
    for q in _reqs(tserving):
        e0.submit(q)
    done = []
    for _ in range(steps_before):
        done.extend(e0.step())
    moved = list(e0.sched.running)
    assert moved, "workload must still be running at the migration point"
    for q in moved:
        migrate(e0, e1, q)
        assert q.instance_id == 1
    done.extend(_drain(e0, e1))
    assert _tokens(done) == base


def test_mid_prefill_and_mid_block_migration(models):
    """Chunk budget 6 on block size 8: the cut lands inside a block and
    the pending-token slot is empty mid-prefill."""
    req_kw = dict(n=3, uniq=21, max_new=8)   # prompts 37..39 tokens
    base = _jax_baseline(models, req_kw, chunk=6)
    reset_request_ids()
    e0, e1 = _engine(models, 0, chunk=6), _engine(models, 1, chunk=6)
    for q in _reqs(tserving, **req_kw):
        e0.submit(q)
    done = list(e0.step())
    mid = [q for q in e0.sched.running if q.prefilled_len < q.prompt_len]
    assert mid, "chunked prefill should leave requests mid-prompt"
    assert any(q.prefilled_len % 8 for q in mid), "want a mid-block cut"
    assert all(e0.pending_token(q.req_id) is None for q in mid)
    for q in list(e0.sched.running):
        migrate(e0, e1, q)
    done.extend(_drain(e0, e1))
    assert _tokens(done) == base


def test_cow_shared_blocks_migrate(models):
    """Two requests sharing a cached prefix (COW-shared blocks) both
    migrate; streams stay identical and the source fully drains."""
    base = _jax_baseline(models)
    reset_request_ids()
    e0, e1 = _engine(models, 0), _engine(models, 1)
    for q in _reqs(tserving):
        e0.submit(q)
    done = list(e0.step())
    done.extend(e0.step())
    shared = [b for b in range(e0.bm.num_blocks) if e0.bm.is_shared(b)]
    assert shared, "shared-prefix workload should COW-share blocks"
    for q in list(e0.sched.running):
        migrate(e0, e1, q)
    assert not e0.bm.owned_seqs(), "source must not leak sequences"
    done.extend(_drain(e0, e1))
    assert _tokens(done) == base


def test_warm_target_prefix_cache_adopts_blocks(models):
    """A target that already caches the prompt's prefix serves those
    blocks from its own cache, and the continued stream still matches."""
    base = _jax_baseline(models)
    reset_request_ids()
    e0, e1 = _engine(models, 0), _engine(models, 1)
    reqs = _reqs(tserving)
    warm = Request(agent_name="w", msg_id="warm",
                   prompt_len=reqs[0].prompt_len,
                   prompt_tokens=np.array(reqs[0].prompt_tokens),
                   max_new_tokens=2)
    e1.submit(warm)
    _drain(e1)
    for q in reqs:
        e0.submit(q)
    done = []
    for _ in range(3):
        done.extend(e0.step())
    snap = snapshot_request(e0, e0.sched.running[0])
    assert restore_request(e1, snap) > 0, \
        "warm target should adopt cached prefix blocks"
    assert snap.n_cached_blocks > 0
    done.extend(_drain(e0, e1))
    assert _tokens(done) == base


def test_pool_addresses_stable_across_migration(models):
    reset_request_ids()
    e0, e1 = _engine(models, 0), _engine(models, 1)
    for q in _reqs(tserving):
        e0.submit(q)
    e0.step()
    a0, a1 = e0.runner.pool_address(), e1.runner.pool_address()
    d0, d1 = e0.runner.n_dispatches, e1.runner.n_dispatches
    moved = list(e0.sched.running)
    for q in moved:
        migrate(e0, e1, q)
    assert e0.runner.pool_address() == a0
    assert e1.runner.pool_address() == a1
    # one read_blocks per snapshot, one write_blocks per restore
    assert e0.runner.n_dispatches - d0 == len(moved)
    assert e1.runner.n_dispatches - d1 == len(moved)


def test_refused_migration_is_lossless(models):
    """A target without capacity raises BEFORE any source state is
    released; the request finishes on the source untouched."""
    base = _jax_baseline(models)
    reset_request_ids()
    e0 = _engine(models, 0)
    e1 = _engine(models, 1, num_blocks=2)    # too small to adopt anything
    for q in _reqs(tserving):
        e0.submit(q)
    e0.step()
    victim = e0.sched.running[0]
    with pytest.raises(MigrationError):
        migrate(e0, e1, victim)
    assert victim in e0.sched.running, "refusal must leave the request"
    with pytest.raises(MigrationError):
        migrate(e0, e0, victim)              # self-migration is refused too
    assert _tokens(_drain(e0)) == base


def test_snapshot_carries_progress_and_pending_token(models):
    """The port's snapshot of a mid-decode request carries what the JAX
    package's snapshot of the same request carries: progress, pending
    token, resident tokens, hash chain, block count and bytes."""
    snaps = {}
    for mod in (jserving, tserving):
        mod.reset_request_ids()
        if mod is jserving:
            e0 = jserving.LLMEngine(models[0].clone(), instance_id=0,
                                    max_batch=4, enable_prefix_cache=True)
        else:
            e0 = _engine(models, 0)
        for q in _reqs(mod, n=2):
            e0.submit(q)
        e0.step()
        e0.step()
        victim = next(q for q in e0.sched.running if q.output_len > 0)
        out_before = [int(t) for t in victim.output_tokens]
        pend = e0.pending_token(victim.req_id)
        snap = snapshot_request(e0, victim)
        assert snap.pending_token == pend is not None
        assert snap.n_resident_tokens == \
            victim.prefilled_len + victim.output_len
        assert snap.n_blocks == snap.kv.shape[2] > 0
        assert [int(t) for t in victim.output_tokens] == out_before
        assert victim not in e0.sched.running
        snaps[mod] = snap
    j, t = snaps[jserving], snaps[tserving]
    assert (t.req.msg_id, t.pending_token, t.n_resident_tokens, t.hashes,
            t.n_blocks, t.n_bytes, t.kv.shape, t.kv.dtype) == \
        (j.req.msg_id, j.pending_token, j.n_resident_tokens, j.hashes,
         j.n_blocks, j.n_bytes, j.kv.shape, j.kv.dtype)
    np.testing.assert_allclose(t.kv, j.kv, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the transport, bit for bit
# ---------------------------------------------------------------------------


def test_bf16_write_and_read_blocks_bits_equal_jax():
    """Random bfloat16 bits written into both pools at the same block ids
    read back bit-equal from both, through the pool's spare-block view;
    the port hands them back as ``uint16`` raw bits."""
    jmodel, jparams, model, params = _models("bfloat16")
    jr = jserving.PagedModelRunner(jmodel, jparams, num_blocks=16,
                                   block_size=8, max_batch=2)
    tr = PagedModelRunner(model, params, num_blocks=16, block_size=8,
                          max_batch=2, device="cpu")
    rng = np.random.default_rng(0)
    shape = tuple(tr.pool.shape[:2]) + (5,) + tuple(tr.pool.shape[3:])
    bits = rng.integers(0, 2 ** 16, shape, dtype=np.uint16)
    bits[(bits & 0x7F80) == 0x7F80] = 0       # no NaN/inf patterns
    ids = [15, 0, 7, 3, 9]
    addr = tr.pool_address()
    jr.write_blocks(bits.view(ml_dtypes.bfloat16), ids)
    tr.write_blocks(bits, ids)
    assert tr.pool_address() == addr and tr.n_dispatches == 1
    assert tr.pool.shape[2] == 16 and tr._pool_buf.shape[2] == 17
    for sub in ([7, 15], ids, [0]):
        got_t = tr.read_blocks(sub)
        got_j = jr.read_blocks(sub).view(np.uint16)
        assert got_t.dtype == np.uint16 and got_t.shape == got_j.shape
        np.testing.assert_array_equal(got_t, got_j)
    np.testing.assert_array_equal(tr.read_blocks(ids), bits)
    assert tr.pool_address() == addr and tr.n_dispatches == 5
    # blocks never written stay zero in both
    np.testing.assert_array_equal(tr.read_blocks([1, 2]),
                                  jr.read_blocks([1, 2]).view(np.uint16))
    assert not tr.read_blocks([1, 2]).any()


def test_bf16_snapshot_kv_bits_against_jax():
    """A real bfloat16 snapshot, mid-decode: the layer-0 KV bits equal the
    JAX snapshot's exactly; the rest agree to the bf16 tolerance; the
    byte count and block count are the same."""
    jmodel, jparams, model, params = _models("bfloat16")
    snaps = {}
    for mod in (jserving, tserving):
        mod.reset_request_ids()
        if mod is jserving:
            r = jserving.PagedModelRunner(jmodel, jparams, num_blocks=64,
                                          block_size=8, max_batch=4)
        else:
            r = PagedModelRunner(model, params, num_blocks=64, block_size=8,
                                 max_batch=4, device="cpu")
        e = mod.LLMEngine(r, instance_id=0, max_batch=4,
                          enable_prefix_cache=True)
        for q in _reqs(mod):
            e.submit(q)
        for _ in range(3):
            e.step()
        snaps[mod] = mod.snapshot_request(e, e.sched.running[0])
    j, t = snaps[jserving], snaps[tserving]
    jbits = j.kv.view(np.uint16)
    assert t.kv.dtype == np.uint16 and t.kv.shape == jbits.shape
    assert t.n_bytes == j.n_bytes and t.n_blocks == j.n_blocks
    assert t.pending_token == j.pending_token
    np.testing.assert_array_equal(t.kv[0], jbits[0])
    as_f32 = lambda b: b.view(ml_dtypes.bfloat16).astype(np.float32)
    np.testing.assert_allclose(as_f32(t.kv), as_f32(jbits), rtol=2e-2,
                               atol=2e-2)


# ---------------------------------------------------------------------------
# round-trip sweep: seeded workloads through repeated forced migrations
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,migrate_every,chunk",
                         [(3, 1, None), (11, 2, 8), (27, 3, None),
                          (40, 2, 8)])
def test_migration_roundtrip_property(models, seed, migrate_every, chunk):
    req_kw = dict(n=3, max_new=8, uniq=5 + seed % 13, seed=seed)
    base = _jax_baseline(models, req_kw, chunk=chunk)
    reset_request_ids()
    engines = [_engine(models, 0, chunk=chunk),
               _engine(models, 1, chunk=chunk)]
    pending = _reqs(tserving, **req_kw)
    done, it, moves = [], 0, 0
    for _ in range(4000):
        if pending:
            engines[it % 2].submit(pending.pop(0))
        for e in engines:
            done.extend(e.step())
        it += 1
        if it % migrate_every == 0:
            src = max(engines, key=lambda e: len(e.sched.running))
            dst = engines[1 - engines.index(src)]
            for q in list(src.sched.running):
                if dst.sched.can_adopt(q):
                    migrate(src, dst, q)
                    moves += 1
        if not pending and not any(e.sched.has_work for e in engines):
            break
    assert moves > 0
    assert _tokens(done) == base


# ---------------------------------------------------------------------------
# partial-failure hardening: transfer faults roll back losslessly
# ---------------------------------------------------------------------------


def _accounting(bm):
    return (bm.free_blocks, bm.cached_blocks, bm.hard_used_blocks,
            sorted(bm.owned_seqs()))


def test_migrate_many_transfer_fault_rolls_back_without_leaks(models):
    base = _jax_baseline(models)
    reset_request_ids()
    e0, e1 = _engine(models, 0), _engine(models, 1)
    for q in _reqs(tserving):
        e0.submit(q)
    done = []
    for _ in range(3):
        done.extend(e0.step())
    moved = list(e0.sched.running)
    assert moved, "need live work to make the rollback real"
    progress = {q.req_id: (q.prefilled_len, [int(t) for t in q.output_tokens])
                for q in moved}
    acc0, acc1 = _accounting(e0.bm), _accounting(e1.bm)
    inj = FaultInjector(FaultPlan(
        (FaultSpec(kind="transfer", instance_id=0, step=0),)))
    with pytest.raises(MigrationError):
        migrate_many(e0, e1, moved, now=0.0, faults=inj)
    assert inj.n_fired == 1
    assert _accounting(e0.bm) == acc0, "source accounting must round-trip"
    assert _accounting(e1.bm) == acc1, "target leaked blocks on rollback"
    assert not e1.sched.running and not e1.has_pending
    for q in moved:
        assert q.instance_id == 0 and q in e0.sched.running
        assert (q.prefilled_len, [int(t) for t in q.output_tokens]) == \
            progress[q.req_id], "rollback must not lose progress"
    snaps, skipped = migrate_many(e0, e1, moved, now=1.0, faults=inj)
    assert len(snaps) == len(moved) and not skipped
    done.extend(_drain(e0, e1))
    assert _tokens(done) == base


def test_migrate_transfer_fault_single_request_rolls_back(models):
    base = _jax_baseline(models, dict(n=2, max_new=10))
    reset_request_ids()
    e0, e1 = _engine(models, 0), _engine(models, 1)
    for q in _reqs(tserving, n=2, max_new=10):
        e0.submit(q)
    done = list(e0.step())
    victim = e0.sched.running[0]
    acc1 = _accounting(e1.bm)
    inj = FaultInjector(FaultPlan(
        (FaultSpec(kind="transfer", instance_id=0, step=0),)))
    with pytest.raises(MigrationError):
        migrate(e0, e1, victim, now=0.0, faults=inj)
    assert victim in e0.sched.running and victim.instance_id == 0
    assert _accounting(e1.bm) == acc1
    migrate(e0, e1, victim, now=1.0, faults=inj)   # plan exhausted: clean
    assert victim.instance_id == 1
    done.extend(_drain(e0, e1))
    assert _tokens(done) == base


def test_migration_onto_a_legacy_engine_continues_identically(models):
    """A fused engine's mid-decode requests migrate onto a legacy
    (per-chunk) engine and finish there as the JAX baseline does: the
    pending token crosses as a plain int, the KV through
    ``write_blocks``, and ``decode_batch`` continues the stream."""
    base = _jax_baseline(models)
    reset_request_ids()
    e0 = _engine(models, 0)
    _, model, params = models
    e1 = LLMEngine(PagedModelRunner(model, params, num_blocks=64,
                                    block_size=8, max_batch=4, device="cpu"),
                   instance_id=1, max_batch=4, enable_prefix_cache=True,
                   fused_iteration=False)
    for q in _reqs(tserving):
        e0.submit(q)
    done = []
    for _ in range(3):
        done.extend(e0.step())
    moved = list(e0.sched.running)
    snaps, skipped = migrate_many(e0, e1, moved)
    assert len(snaps) == len(moved) and not skipped
    done.extend(_drain(e0, e1))
    assert _tokens(done) == base
    assert torch.is_tensor(e1.runner.pool)
