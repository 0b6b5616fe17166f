"""The port's fused serving engine against the JAX package's.

The same requests drain through ``repro.serving.LLMEngine`` and
``repro_torch.serving.LLMEngine`` on the same weights (the JAX pytree
carried across), both on the ``"ref"`` attention backend in fp32, under
the mixes of ``tests/test_fused_iteration.py``: prefix cache on and off,
chunk budgets that split blocks mid-way, staggered arrivals that mix
chunks with decodes, and preemption pressure in a tight pool.  Token
streams must be identical.  The fp32 argmax margins of the reduced model
are far wider than the two frameworks' rounding differences.
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
                                                    jax_runners[0]), cfg,
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
          on_step=None):
    mod.reset_request_ids()
    eng = mod.LLMEngine(runner, max_batch=4, enable_prefix_cache=cache,
                        prefill_chunk_tokens=chunk)
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
