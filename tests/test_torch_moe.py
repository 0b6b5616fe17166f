"""The port's MoE FFN and its served paths against the JAX package's.

``moe_ffn`` is held to the JAX function in fp32 (1e-4) at a capacity
that drops assignments and at one that drops none, with the reference's
own invariants (token permutation, aux loss) and its tie-break.  Then
the reduced qwen2-moe drains through both packages' engines on shared
weights, in fp32 on the ``"ref"`` attention backend, under every mix of
``tests/test_fused_iteration.py`` plus one whose padding rows take
capacity slots from real tokens: the port's fused streams must equal the
JAX fused streams (``tests/test_torch_moe_legacy.py`` holds the legacy
streams to the JAX legacy streams: with MoE the two paths batch
differently, so their streams may differ from each other).  Last, the served head shapes the kernels take at full
width: G = 1 (qwen2-moe's 16 over 16), G = 3 (llama3.2-3b's 24 over 8,
reduced to 6 over 2) and hd 80 (stablelm-3b), fused and legacy.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import serving as jserving
from repro.configs import get_config as jax_get_config
from repro.configs.base import ModelConfig as JaxModelConfig
from repro.configs.base import MoEConfig as JaxMoEConfig
from repro.models import build_model as jax_build_model
from repro.models import moe as jmoe
from repro_torch import serving as tserving
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.models import LanguageModel, params_from_jax
from repro_torch.models import moe as tmoe
from test_torch_engine import MIXES as ENGINE_MIXES
from test_torch_engine import drain, mixed_reqs
from repro_torch.models import model as model_mod


def _mini(**moe_kw):
    """The reference's unit-test config (d 64), both packages."""
    base = dict(name="t", family="moe", num_layers=2, d_model=64,
                num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=97)
    kw = dict(num_experts=4, top_k=2, d_expert=32)
    kw.update(moe_kw)
    return (JaxModelConfig(**base, moe=JaxMoEConfig(**kw)),
            ModelConfig(**base, moe=MoEConfig(**kw)))


def _moe_pair(seed=0, **moe_kw):
    jcfg, tcfg = _mini(**moe_kw)
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                         device="cpu")
    return jcfg, jp, tcfg, tp


def _dropped(tp, x, cfg) -> int:
    """Assignments ``moe_ffn`` drops for capacity on input ``x``."""
    xf = x.reshape(-1, x.shape[-1])
    _, _, idx = tmoe.route(tp, xf, cfg)
    return int((~tmoe.dispatch(idx, xf.shape[0], cfg)[2]).sum())


@pytest.mark.parametrize("capacity_factor, drops", [(4.0, False),
                                                    (0.5, True)])
def test_moe_ffn_matches_jax(capacity_factor, drops):
    jcfg, jp, tcfg, tp = _moe_pair(num_shared_experts=1, d_shared=48,
                                   capacity_factor=capacity_factor)
    x = np.random.default_rng(1).standard_normal((2, 16, 64)).astype(np.float32)
    jout, jaux = jmoe.moe_ffn(jp, jnp.asarray(x), jcfg)
    tout, taux = tmoe.moe_ffn(tp, torch.from_numpy(x), tcfg)
    assert tout.shape == jout.shape and tout.dtype == torch.float32
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    assert (_dropped(tp, torch.from_numpy(x), tcfg) > 0) == drops
    _, jidx = jax.lax.top_k(jax.nn.softmax(
        jnp.asarray(x).reshape(32, 64) @ jp["router"]), 2)
    _, _, tidx = tmoe.route(tp, torch.from_numpy(x).reshape(32, 64), tcfg)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))


def test_moe_capacity_and_combine_weights():
    """``tests/test_model_components.py``'s invariants on the port: the
    output keeps the input's shape, the aux loss is finite and
    non-negative, and permuting tokens permutes the output."""
    _, _, cfg, p = _moe_pair()
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 16, 64)).astype(np.float32))
    out, aux = tmoe.moe_ffn(p, x, cfg)
    assert out.shape == x.shape
    assert np.isfinite(float(aux)) and float(aux) >= 0
    perm = torch.from_numpy(np.random.default_rng(2).permutation(16))
    out_p, _ = tmoe.moe_ffn(p, x[:, perm], cfg)
    np.testing.assert_allclose(out[:, perm].numpy(), out_p.numpy(),
                               rtol=5e-3, atol=5e-3)


def test_moe_aux_loss_penalizes_imbalance():
    _, _, cfg, p = _moe_pair(top_k=1)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1, 64, 64)).astype(np.float32))
    router = torch.zeros_like(p["router"])
    router[:, 0] = 10.0                     # every token to expert 0
    _, aux_bal = tmoe.moe_ffn(p, x, cfg)
    _, aux_bad = tmoe.moe_ffn(dict(p, router=router), x, cfg)
    assert float(aux_bad) > float(aux_bal)


def test_moe_tie_break_picks_the_lower_expert():
    """Experts 1 and 2 share a router column, so every token's
    probabilities for them are equal: like ``lax.top_k``, the port ranks
    expert 1 first wherever the pair straddles the top-k boundary."""
    jcfg, jp, tcfg, tp = _moe_pair(top_k=2)
    router = np.asarray(jp["router"]).copy()
    router[:, 2] = router[:, 1]
    jp = dict(jp, router=jnp.asarray(router))
    tp = dict(tp, router=torch.from_numpy(router))
    x = np.random.default_rng(4).standard_normal((64, 64)).astype(np.float32)
    probs, _, tidx = tmoe.route(tp, torch.from_numpy(x), tcfg)
    _, jidx = jax.lax.top_k(jax.nn.softmax(jnp.asarray(x) @ jp["router"]), 2)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    straddles = (tidx == 1).any(1) ^ (tidx == 2).any(1)
    assert straddles.any() and not (tidx[straddles] == 2).any()
    jout, _ = jmoe.moe_ffn(jp, jnp.asarray(x)[None], jcfg)
    tout, _ = tmoe.moe_ffn(tp, torch.from_numpy(x)[None], tcfg)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-4,
                               atol=1e-4)


# =============================================================================
# the served paths: reduced configs through both packages' engines
# =============================================================================


def _pad_rows_requests(mod):
    """Prompts of 37, 5, 21 and 2 tokens with no shared prefix: in one
    64-token budget their chunks tile to (4, 64), and the routed padding
    of the first chunk's row takes slots of an expert ahead of the later
    chunks' real tokens."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 500, n).astype(np.int32)
               for n in (37, 5, 21, 2)]
    return [mod.Request(agent_name="a", msg_id=f"m{i}", prompt_len=len(t),
                        prompt_tokens=t, max_new_tokens=4,
                        arrival_time=float(i)) for i, t in enumerate(prompts)]


# name: (chunk, cache, requests of a serving module, staggered,
# num_blocks): the mixes of tests/test_torch_engine.py, and pad-rows
MIXES = {name: (chunk, cache, lambda mod, kw=kw: mixed_reqs(mod, **kw),
                staggered, nblocks)
         for name, (chunk, cache, kw, staggered, nblocks)
         in ENGINE_MIXES.items()}
MIXES["pad-rows"] = (64, False, _pad_rows_requests, False, 64)


def _served(arch, **shape):
    """Reduced fp32 ``arch`` (with ``shape`` overrides on both sides):
    the JAX model and params, and the port's model and params."""
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(),
                               dtype="float32", **shape)
    tcfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                               **shape)
    jm = jax_build_model(jcfg)
    jp = jm.init_params(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                         device="cpu")
    return jm, jp, LanguageModel(tcfg), tp


@pytest.fixture(scope="module")
def moe_models():
    jm, jp, tm, tp = _served("qwen2-moe-a2.7b")
    # clones share the JAX runner's compiled step functions
    runners = {n: jserving.PagedModelRunner(jm, jp, num_blocks=n,
                                            block_size=8, max_batch=4)
               for n in (18, 24, 64)}
    return runners, tm, tp


def _port_runner(tm, tp, num_blocks):
    return tserving.PagedModelRunner(tm, tp, num_blocks=num_blocks,
                                     block_size=8, max_batch=4, device="cpu")


def check_mix(moe_models, mix, fused):
    """One mix through both engines on one path; streams must agree."""
    runners, tm, tp = moe_models
    chunk, cache, reqs, staggered, nblocks = MIXES[mix]
    _, jax_out = drain(jserving, runners[nblocks].clone(), chunk=chunk,
                       cache=cache, reqs=reqs(jserving),
                       staggered=staggered, fused=fused)
    eng, port_out = drain(tserving, _port_runner(tm, tp, nblocks),
                          chunk=chunk, cache=cache, reqs=reqs(tserving),
                          staggered=staggered, fused=fused)
    assert port_out == jax_out
    if mix == "preemption":
        assert eng.stats.n_preempted > 0, "the mix must preempt"


@pytest.mark.parametrize("mix", list(MIXES))
def test_moe_engine_token_identical_to_jax(moe_models, mix):
    """The fused path; ``tests/test_torch_moe_legacy.py`` holds the
    legacy path to the JAX legacy streams."""
    check_mix(moe_models, mix, fused=True)


def test_pad_rows_take_capacity_slots(moe_models, monkeypatch):
    """In the ``pad-rows`` mix's fused steps some expert keeps a padding
    row's assignment and drops a real token's: the mix really tests that
    the port routes and ranks the padding rows as the reference does."""
    _, tm, tp = moe_models
    chunk, cache, reqs, _, nblocks = MIXES["pad-rows"]
    runner = _port_runner(tm, tp, nblocks)
    real, seen = {}, []
    run = runner.run_iteration

    def run_iteration(batch):
        real["rows"] = torch.from_numpy(
            np.asarray(batch.write_slots) < nblocks * runner.block_size)
        return run(batch)

    def moe_ffn(p, x, cfg):
        xf = x.reshape(-1, x.shape[-1])
        _, _, idx = tmoe.route(p, xf, cfg)
        order, _, keep, _ = tmoe.dispatch(idx, xf.shape[0], cfg)
        is_real = real["rows"][order // cfg.moe.top_k]
        expert = idx.reshape(-1)[order]
        seen.extend(bool((keep & ~is_real & (expert == e)).any()
                         and (~keep & is_real & (expert == e)).any())
                    for e in range(cfg.moe.num_experts))
        return tmoe.moe_ffn(p, x, cfg)

    runner.run_iteration = run_iteration
    monkeypatch.setattr(model_mod, "moe_ffn", moe_ffn)
    drain(tserving, runner, chunk=chunk, cache=cache, reqs=reqs(tserving))
    assert any(seen)


# the served head shapes of the full configs, on the reduced widths
HEAD_SHAPES = {
    "qwen2-moe-G1": ("qwen2-moe-a2.7b", dict(num_kv_heads=4)),
    "llama3.2-G3": ("llama3.2-3b", dict(num_heads=6, num_kv_heads=2)),
    "stablelm-hd80": ("stablelm-3b", dict(num_kv_heads=4, head_dim=80)),
}


@pytest.fixture(scope="module")
def head_shape_streams():
    """Per head shape: the JAX engine's streams on the ``chunk16-cache``
    mix (prompt chunks beside decodes) and the port's models.  A dense
    model's legacy streams equal its fused ones in the reference
    (``tests/test_fused_iteration.py``), so only the MoE model runs the
    JAX legacy path."""
    out = {}
    chunk, cache, reqs, _, nblocks = MIXES["chunk16-cache"]
    for name, (arch, shape) in HEAD_SHAPES.items():
        jm, jp, tm, tp = _served(arch, **shape)
        jrunner = jserving.PagedModelRunner(jm, jp, num_blocks=nblocks,
                                            block_size=8, max_batch=4)
        streams = {}
        for fused in (True, False):
            if fused or tm.cfg.moe is not None:
                streams[fused] = drain(
                    jserving, jrunner.clone(), chunk=chunk, cache=cache,
                    reqs=reqs(jserving), fused=fused)[1]
        out[name] = (streams, tm, tp)
    return out


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "legacy"])
@pytest.mark.parametrize("shape", list(HEAD_SHAPES))
def test_served_head_shapes_token_identical_to_jax(head_shape_streams,
                                                   shape, fused):
    streams, tm, tp = head_shape_streams[shape]
    cfg = tm.cfg
    g = cfg.num_heads // cfg.num_kv_heads
    assert (g, cfg.resolved_head_dim) == {"qwen2-moe-G1": (1, 64),
                                          "llama3.2-G3": (3, 64),
                                          "stablelm-hd80": (1, 80)}[shape]
    chunk, cache, reqs, _, nblocks = MIXES["chunk16-cache"]
    _, port_out = drain(tserving, _port_runner(tm, tp, nblocks),
                        chunk=chunk, cache=cache, reqs=reqs(tserving),
                        fused=fused)
    assert port_out == streams.get(fused, streams[True])
