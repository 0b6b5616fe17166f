"""The port's fused serving engine against the JAX package's.

The same requests drain through ``repro.serving.LLMEngine`` and
``repro_torch.serving.LLMEngine`` on the same weights (the JAX pytree
carried across), both on the ``"ref"`` attention backend in fp32, under
the mixes of ``tests/test_fused_iteration.py``: prefix cache on and off,
chunk budgets that split blocks mid-way, staggered arrivals that mix
chunks with decodes, and preemption pressure in a tight pool.  Token
streams must be identical.  The fp32 argmax margins of the reduced model
are far wider than the two frameworks' rounding differences.

The legacy per-chunk path (``fused_iteration=False``) drains every mix
to the JAX package's fused streams, and counts the JAX legacy path's
dispatches; the out-of-place pool (``donate_pool=False``) gives the same
tokens while its address moves at every pool-writing step;
``jit_cache_size`` stays flat across shape buckets it has seen.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import serving as jserving
from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro_torch import serving as tserving
from repro_torch.configs import get_config
from repro_torch.models import LanguageModel, params_from_jax


@pytest.fixture(scope="module")
def jax_runners():
    """JAX fp32 runners per pool size; drains use clones, which share the
    compiled step functions."""
    cfg = dataclasses.replace(jax_get_config("qwen3-1.7b").reduced(),
                              dtype="float32")
    model = jax_build_model(cfg)
    params = model.init_params(jax.random.PRNGKey(0))
    runners = {n: jserving.PagedModelRunner(model, params, num_blocks=n,
                                            block_size=8, max_batch=4)
               for n in (18, 24, 64)}
    return params, runners


@pytest.fixture(scope="module")
def port_model(jax_runners):
    cfg = dataclasses.replace(get_config("qwen3-1.7b").reduced(),
                              dtype="float32")
    params = params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                    jax_runners[0]),
                             device="cpu")
    return LanguageModel(cfg), params


def mixed_reqs(mod, seed=11, sys_len=16, n=4, uniq=6, max_new=4):
    """Shared-prefix requests (full-block cached prefix when caching on)."""
    rng = np.random.default_rng(seed)
    sys_toks = rng.integers(0, 500, sys_len).astype(np.int32)
    reqs = []
    for i in range(n):
        toks = np.concatenate(
            [sys_toks, rng.integers(0, 500, uniq + i).astype(np.int32)])
        reqs.append(mod.Request(agent_name="a", msg_id=f"m{i}",
                                prompt_len=len(toks), prompt_tokens=toks,
                                max_new_tokens=max_new, arrival_time=float(i)))
    return reqs


def drain(mod, runner, *, chunk, cache, reqs, staggered=False,
          on_step=None, fused=True):
    mod.reset_request_ids()
    eng = mod.LLMEngine(runner, max_batch=4, enable_prefix_cache=cache,
                        prefill_chunk_tokens=chunk, fused_iteration=fused)
    pending, done = list(reqs), []
    if not staggered:
        for r in pending:
            eng.submit(r)
        pending = []
    for _ in range(4000):
        if pending:              # trickle arrivals: chunks mix with decodes
            eng.submit(pending.pop(0))
        done.extend(eng.step())
        if on_step is not None:
            on_step(eng)
        if not pending and not eng.running and not eng.waiting:
            break
    assert len(done) == len(reqs)
    assert eng.bm.free_blocks + eng.bm.cached_blocks == eng.bm.num_blocks
    return eng, sorted((d.msg_id, tuple(int(t) for t in d.output_tokens))
                       for d in done)


def port_runner(port_model, num_blocks, **kw):
    model, params = port_model
    return tserving.PagedModelRunner(model, params, num_blocks=num_blocks,
                                     block_size=8, max_batch=4, device="cpu",
                                     **kw)


MIXES = {
    # name: (chunk, cache, request kwargs, staggered, num_blocks)
    "chunk5-nocache": (5, False, {}, False, 64),
    "chunk5-cache": (5, True, {}, False, 64),
    "chunk16-nocache": (16, False, {}, False, 64),
    "chunk16-cache": (16, True, {}, False, 64),
    "staggered": (16, True, dict(seed=7, sys_len=24, n=6, uniq=11,
                                 max_new=6), True, 64),
    # the mix of tests/test_fused_iteration.py: a tight pool, no preemption
    "tight-pool": (8, False, dict(seed=3, sys_len=8, n=5, uniq=19,
                                  max_new=10), False, 24),
    # six fewer blocks: the same requests now preempt and recompute
    "preemption": (8, False, dict(seed=3, sys_len=8, n=5, uniq=19,
                                  max_new=10), False, 18),
}


@pytest.mark.parametrize("mix", list(MIXES))
def test_port_engine_token_identical_to_jax(jax_runners, port_model, mix):
    chunk, cache, kw, staggered, nblocks = MIXES[mix]
    _, jax_out = drain(jserving, jax_runners[1][nblocks].clone(), chunk=chunk,
                       cache=cache, reqs=mixed_reqs(jserving, **kw),
                       staggered=staggered)
    eng, port_out = drain(tserving, port_runner(port_model, nblocks),
                          chunk=chunk, cache=cache,
                          reqs=mixed_reqs(tserving, **kw),
                          staggered=staggered)
    assert port_out == jax_out
    if mix == "preemption":
        assert eng.stats.n_preempted > 0, "the mix must preempt"


def test_one_step_per_iteration_and_stable_pool(port_model):
    """Exactly one ``run_iteration`` per iteration, and the pool is
    updated in place: its address never moves through a drain with
    chunked prefill and preemption."""
    runner = port_runner(port_model, 18)
    addr = runner.pool_address()
    calls = []
    orig = runner.run_iteration
    runner.run_iteration = lambda batch: calls.append(1) or orig(batch)
    steps = []

    def on_step(eng):
        steps.append(runner.pool_address())

    eng, _ = drain(tserving, runner, chunk=8, cache=False,
                   reqs=mixed_reqs(tserving, seed=3, sys_len=8, n=5, uniq=19,
                                   max_new=10), on_step=on_step)
    assert len(calls) == runner.n_dispatches == len(steps)
    assert set(steps) == {addr}
    assert eng.stats.n_preempted > 0


def test_flat_ref_lowering_token_identical(port_model):
    kw = dict(seed=9, sys_len=16, n=5, uniq=13, max_new=6)
    _, native = drain(tserving, port_runner(port_model, 24), chunk=8,
                      cache=True, reqs=mixed_reqs(tserving, **kw))
    _, flat = drain(tserving, port_runner(port_model, 24,
                                          ragged_backend="flat_ref"),
                    chunk=8, cache=True, reqs=mixed_reqs(tserving, **kw))
    assert native == flat


def test_clone_shares_params_and_owns_a_fresh_pool(port_model):
    r0 = port_runner(port_model, 16)
    r0.pool[0, 0, 3] = 1.0
    r1 = r0.clone()
    assert r1.params is r0.params
    assert r1.pool_address() != r0.pool_address()
    assert not r1.pool.any() and r1.pool.shape == r0.pool.shape


def test_runner_defaults_to_cuda_and_raises_without_it(port_model,
                                                       monkeypatch):
    """No silent CPU fallback: without ``device`` the runner wants the
    card."""
    model, params = port_model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tserving.PagedModelRunner(model, params, num_blocks=16, block_size=8)


# =============================================================================
# the legacy per-chunk path and the out-of-place pool
# =============================================================================


@pytest.mark.parametrize("mix", list(MIXES))
def test_port_legacy_engine_token_identical_to_jax(jax_runners, port_model,
                                                   mix):
    """Fused equals legacy: the port's per-chunk path drains every mix to
    the JAX package's fused streams."""
    chunk, cache, kw, staggered, nblocks = MIXES[mix]
    _, jax_out = drain(jserving, jax_runners[1][nblocks].clone(), chunk=chunk,
                       cache=cache, reqs=mixed_reqs(jserving, **kw),
                       staggered=staggered)
    eng, port_out = drain(tserving, port_runner(port_model, nblocks),
                          chunk=chunk, cache=cache,
                          reqs=mixed_reqs(tserving, **kw),
                          staggered=staggered, fused=False)
    assert port_out == jax_out
    if mix == "preemption":
        assert eng.stats.n_preempted > 0, "the mix must preempt"


def test_legacy_dispatch_counts_equal_jax(jax_runners, port_model):
    """The legacy path's dispatches, iteration by iteration, are the JAX
    package's: K+1 steps plus an argmax per completed prompt, where the
    fused path issues exactly one."""
    counts = {}
    for mod, runner in ((jserving, jax_runners[1][64].clone()),
                        (tserving, port_runner(port_model, 64))):
        for fused in (True, False):
            mod.reset_request_ids()
            runner.n_dispatches = 0
            eng = mod.LLMEngine(runner, max_batch=4, prefill_chunk_tokens=8,
                                fused_iteration=fused)
            for r in mixed_reqs(mod, seed=5, sys_len=16, n=3, uniq=7,
                                max_new=3):
                eng.submit(r)
            per_iter = []
            for _ in range(4000):
                before = runner.n_dispatches
                eng.step()
                if runner.n_dispatches == before:
                    break
                per_iter.append(runner.n_dispatches - before)
            counts[(mod, fused)] = per_iter
    assert counts[(tserving, True)] == counts[(jserving, True)]
    assert set(counts[(tserving, True)]) == {1}
    assert counts[(tserving, False)] == counts[(jserving, False)]
    assert sum(counts[(tserving, False)]) > len(counts[(tserving, False)])


@pytest.mark.parametrize("fused", [True, False])
def test_pool_address_stable_in_place(port_model, fused):
    """Every step of a drain under preemption pressure — fused, or the
    legacy prefill / suffix / copy / decode steps — writes the one pool
    in place."""
    runner = port_runner(port_model, 24)
    addr = runner.pool_address()
    seen = []
    _, out = drain(tserving, runner, chunk=8, cache=True,
                   reqs=mixed_reqs(tserving, seed=3, sys_len=8, n=5, uniq=19,
                                   max_new=6),
                   on_step=lambda e: seen.append(runner.pool_address()),
                   fused=fused)
    assert set(seen) == {addr}
    assert "pool_bytes_copied" not in runner.metrics_snapshot()


@pytest.mark.parametrize("fused", [True, False])
def test_out_of_place_pool_moves_and_keeps_tokens(port_model, fused):
    """``donate_pool=False``: every pool-writing step writes a fresh copy
    of the pool (the address probe sees it move at each one), the copied
    bytes are counted, and the tokens equal the in-place run's."""
    reqs = lambda: mixed_reqs(tserving, seed=3, sys_len=8, n=5, uniq=19,
                              max_new=6)
    _, in_place = drain(tserving, port_runner(port_model, 24), chunk=8,
                        cache=True, reqs=reqs(), fused=fused)
    runner = port_runner(port_model, 24, donate_pool=False)
    moves = []
    orig = runner._writable_pool

    def writable():
        before = runner.pool_address()
        buf = orig()
        moves.append(runner.pool_address() != before)
        return buf

    runner._writable_pool = writable
    _, copied = drain(tserving, runner, chunk=8, cache=True, reqs=reqs(),
                      fused=fused)
    assert copied == in_place
    assert moves and all(moves), "every pool-writing step moves the pool"
    snap = runner.metrics_snapshot()
    assert snap["pool_bytes_copied"] == len(moves) * snap["pool_bytes"]
    if fused:
        assert len(moves) == runner.n_dispatches


def test_prefill_and_copy_block_steps(port_model):
    """``prefill`` is two counted steps (model + page scatter),
    ``copy_block`` one, neither moves the pool, and ``copy_block`` keeps
    one shape signature across block ids."""
    runner = port_runner(port_model, 16)
    a0 = runner.pool_address()
    rng = np.random.default_rng(0)
    d0 = runner.n_dispatches
    logits = runner.prefill(torch.as_tensor(rng.integers(0, 500, 12),
                                            dtype=torch.int32), [3, 4])
    assert logits.shape == (runner.cfg.vocab_size,)
    assert runner.n_dispatches - d0 == 2
    assert runner.pool[:, :, 3].any() and runner.pool[:, :, 4, :4].any()
    assert not runner.pool[:, :, 4, 4:].any(), "the padding stays zero"
    d0 = runner.n_dispatches
    runner.copy_block(3, 7)
    assert runner.n_dispatches - d0 == 1
    assert torch.equal(runner.pool[:, :, 7], runner.pool[:, :, 3])
    assert runner.pool_address() == a0
    d0, cache0 = runner.n_dispatches, runner.jit_cache_size()
    runner.copy_block(4, 8)
    runner.copy_block(7, 9)
    assert runner.n_dispatches - d0 == 2
    assert runner.jit_cache_size() == cache0


def test_prefill_suffix_chunks_equal_one_prefill(port_model, jax_runners):
    """A prompt prefilled in mid-block chunks through ``prefill_suffix``
    leaves the KV and the last logits of one ``prefill``, and the JAX
    package's suffix steps give the same logits."""
    toks = np.random.default_rng(2).integers(0, 500, 21).astype(np.int32)
    table = [5, 2, 9]
    whole = port_runner(port_model, 16)
    ref_logits = whole.prefill(torch.as_tensor(toks), table)
    chunked = port_runner(port_model, 16)
    jr = jax_runners[1][18].clone()
    for start, end in ((0, 5), (5, 13), (13, 21)):
        logits = chunked.prefill_suffix(torch.as_tensor(toks[start:end]),
                                        table, start)
        jlogits = jr.prefill_suffix(toks[start:end], table, start)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(logits.numpy(), ref_logits.numpy(),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(chunked.pool.numpy(), whole.pool.numpy(),
                               rtol=1e-5, atol=1e-5)


def test_decode_batch_dead_rows_write_the_spare_block(port_model):
    """A padded decode batch: the live rows' logits equal an unpadded
    call's, the dead rows (context 1, all-zero tables) write only into
    the spare block, and the blocks the tables name change only at the
    live rows' slots."""
    runner = port_runner(port_model, 16)
    rng = np.random.default_rng(1)
    runner.prefill(torch.as_tensor(rng.integers(0, 500, 11),
                                   dtype=torch.int32), [2, 6])
    runner.prefill(torch.as_tensor(rng.integers(0, 500, 5),
                                   dtype=torch.int32), [9])
    live_tokens = np.array([17, 23], np.int32)
    positions = np.array([11, 5], np.int32)
    tables = np.array([[2, 6, 0], [9, 0, 0]], np.int32)
    exact = port_runner(port_model, 16)
    exact._set_pool(runner._pool_buf.clone())
    want = exact.decode_batch(live_tokens, positions, tables,
                              np.ones(2, bool))
    before = runner._pool_buf.clone()
    b = runner.max_batch
    tok = np.zeros(b, np.int32)
    pos = np.zeros(b, np.int32)
    tab = np.zeros((b, 3), np.int32)
    live = np.zeros(b, bool)
    tok[:2], pos[:2], tab[:2], live[:2] = live_tokens, positions, tables, True
    got = runner.decode_batch(tok, pos, tab, live)
    assert got.shape == (b, runner.cfg.vocab_size)
    torch.testing.assert_close(got[:2], want, rtol=0, atol=0)
    assert torch.isfinite(got).all()
    changed = (runner._pool_buf != before).flatten(4).any(-1)  # (L, 2, N+1, bs)
    blocks = {(int(n), int(s)) for n, s in
              torch.nonzero(changed.any(0).any(0)).tolist()}
    assert blocks <= {(6, 3), (9, 5), (16, 0)}
    assert (16, 0) in blocks, "dead rows write the spare block"


def test_jit_cache_size_flat_across_seen_buckets(port_model):
    """A second drain over the same shapes adds no signature: the count
    reads as the reference's recompile counter does, bounded by the
    distinct bucket shapes run."""
    runner = port_runner(port_model, 64)
    shape_keys = set()
    orig = runner.run_iteration

    def run(batch):
        shape_keys.add(batch.shape_key)
        return orig(batch)

    runner.run_iteration = run
    kw = dict(seed=9, sys_len=16, n=5, uniq=13, max_new=6)
    drain(tserving, runner, chunk=8, cache=True,
          reqs=mixed_reqs(tserving, **kw))
    first = runner.jit_cache_size()
    assert 0 < first <= len(shape_keys)
    drain(tserving, runner.clone(), chunk=8, cache=True,
          reqs=mixed_reqs(tserving, **kw))
    assert runner.jit_cache_size() == first
    assert runner.metrics_snapshot()["jit_cache_size"] == first
