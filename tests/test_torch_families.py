"""Every model family of the port against the JAX package's, at the
reduced configs (2 layers, d 256; the MoE archs 4 experts, top 2).

Both sides run the same weights: the JAX param pytree is carried across
through numpy by ``params_from_jax``.  Inputs are made by numpy from a
seed (the encoder-decoder's frames too).  ``prefill`` and one
``decode_step`` are held to fp32 1e-4 and bf16 2e-2, logits and every
cache entry; in bf16 the absolute part is measured against the output's
largest magnitude, since XLA keeps some intermediates of a compiled layer
body wider than bf16 where eager torch rounds each op, and the
difference compounds over layers; the RWKV and Mamba mixers' chunked forms to their stepwise
forms and to the JAX functions; gemma3's sliding window to the JAX
mask, in prefill and in decode.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.models import attention as jattn
from repro.models import build_model as jax_build_model
from repro.models import ssm as jssm
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import EncDecModel, LanguageModel, build_model
from repro_torch.models import attention as tattn
from repro_torch.models import params_from_jax
from repro_torch.models import ssm as tssm
from repro_torch.models.layers import layer_slice

B, S = 2, 24
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _configs(arch, dtype):
    return (dataclasses.replace(jax_get_config(arch).reduced(), dtype=dtype),
            dataclasses.replace(get_config(arch).reduced(), dtype=dtype))


def _pair(arch, dtype, seed=0):
    """(jax model, jax params, port model, port params) on shared
    weights."""
    jcfg, tcfg = _configs(arch, dtype)
    jm = jax_build_model(jcfg)
    jp = jm.init_params(jax.random.PRNGKey(seed))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                         device="cpu")
    return jm, jp, build_model(tcfg), tp


def close(actual, expected, tol, scaled=False):
    """allclose at ``tol``; ``scaled`` measures the absolute part against
    the expected output's largest magnitude."""
    if isinstance(actual, torch.Tensor):
        actual = actual.float().numpy()
    expected = np.asarray(expected, np.float32)
    atol = tol * max(1.0, float(np.abs(expected).max())) if scaled else tol
    np.testing.assert_allclose(np.asarray(actual, np.float32), expected,
                               rtol=tol, atol=atol)


def _grow(cache, pad, torch_side):
    """The cache's KV grown along the sequence axis by ``pad`` slots."""
    if "kv" not in cache:
        return cache
    if torch_side:
        return dict(cache, kv=torch.nn.functional.pad(
            cache["kv"], (0, 0, 0, 0, 0, pad)))
    return dict(cache, kv=jnp.pad(cache["kv"], [(0, 0)] * 3 + [(0, pad)]
                                  + [(0, 0)] * 2))


def test_registry_matches_the_jax_package():
    assert ARCH_IDS == JAX_ARCH_IDS
    for arch in ARCH_IDS:
        assert (dataclasses.asdict(get_config(arch))
                == dataclasses.asdict(jax_get_config(arch)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_and_decode_match_jax(arch, dtype):
    jm, jp, tm, tp = _pair(arch, dtype)
    cfg = tm.cfg
    tol, scaled = TOL[dtype], dtype == "bfloat16"
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    jargs, targs = [jnp.asarray(tokens[:, :S])], [torch.from_numpy(tokens[:, :S])]
    if cfg.is_encdec:
        frames = rng.standard_normal((B, 16, cfg.d_model), np.float32)
        jargs.append(jnp.asarray(frames))
        targs.append(torch.from_numpy(frames))
    jlogits, jcache = jm.prefill(jp, *jargs)
    tlogits, tcache = tm.prefill(tp, *targs)
    assert tuple(tlogits.shape) == jlogits.shape == (B, cfg.vocab_size)
    close(tlogits, jlogits, tol, scaled)
    assert set(tcache) == set(jcache)
    assert tcache["pos"] == int(jcache["pos"]) == S
    sizes = (B, S, 16) if cfg.is_encdec else (B, S)
    jzero = jm.init_cache(*sizes)
    tzero = tm.init_cache(*sizes, device="cpu")
    assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
            for k, v in tzero.items() if k != "pos"} == {
        k: (v.shape, str(v.dtype)) for k, v in jzero.items() if k != "pos"}
    for key in jcache:
        if key != "pos":
            assert tcache[key].dtype == getattr(torch, str(jcache[key].dtype))
            close(tcache[key], jcache[key], tol, scaled)

    jcache, tcache = _grow(jcache, 4, False), _grow(tcache, 4, True)
    before = {k: v.clone() for k, v in tcache.items() if k != "pos"}
    step = tokens[:, S:]
    jlog, jnew = jm.decode_step(jp, jcache, jnp.asarray(step))
    tlog, tnew = tm.decode_step(tp, tcache, torch.from_numpy(step))
    assert torch.isfinite(tlog.float()).all()
    close(tlog, jlog, tol, scaled)
    assert tnew["pos"] == int(jnew["pos"]) == S + 1
    for key in jnew:
        if key != "pos":
            close(tnew[key], jnew[key], tol, scaled)
    for key, v in before.items():
        assert torch.equal(tcache[key], v), f"decode_step changed {key}"


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_matches_longer_prefill(arch):
    """``tests/test_models_smoke.py``'s decode case on every family, in
    fp32: one decoded token's logits equal a prefill one token longer.
    7 + 1 tokens keep each MoE call at 8 rows or fewer, where capacity
    (at least 8) drops nothing, so both route alike."""
    cfg = _configs(arch, "float32")[1]
    tm = build_model(cfg)
    tp = tm.init_params(torch.Generator().manual_seed(9), device="cpu")
    rng = np.random.default_rng(9)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 8))
                            .astype(np.int32))
    extra = ([torch.from_numpy(rng.standard_normal((1, 12, cfg.d_model))
                               .astype(np.float32))]
             if cfg.is_encdec else [])
    _, cache = tm.prefill(tp, toks[:, :7], *extra)
    dec, _ = tm.decode_step(tp, _grow(cache, 1, True), toks[:, 7:])
    full, _ = tm.prefill(tp, toks, *extra)
    close(dec, full, 1e-4)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_init_params_mirrors_the_jax_layout(arch):
    """The port's seeded initialiser builds the same tree, shapes and
    dtypes as the JAX package's, for every family."""
    jcfg, tcfg = _configs(arch, "bfloat16")
    jp = jax_build_model(jcfg).init_params(jax.random.PRNGKey(0))
    tp = build_model(tcfg).init_params(torch.Generator().manual_seed(0),
                                       device="cpu")
    jshapes = jax.tree_util.tree_map(lambda x: (x.shape, str(x.dtype)), jp)
    tshapes = jax.tree_util.tree_map(
        lambda x: (tuple(x.shape), str(x.dtype).removeprefix("torch.")), tp)
    assert jshapes == tshapes


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_params_from_jax_round_trips_every_leaf(arch):
    """Every leaf of the reduced bf16 tree arrives bit for bit, in the
    dtype the JAX tree holds it in (bf16 weights; fp32 norms, routers,
    SSM decays and mixes)."""
    jm, jp, tm, tp = _pair(arch, "bfloat16")
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, leaf in jflat:
        t = tp
        for k in path:
            t = t[k.key]
        assert tuple(t.shape) == leaf.shape, path
        assert str(t.dtype).removeprefix("torch.") == str(leaf.dtype), path
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(leaf, np.float32))
    assert len(jflat) == len(jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(lambda x: 0, tp)))
    assert isinstance(tm, EncDecModel if tm.cfg.is_encdec else LanguageModel)


def _mini(family, **kw):
    from repro.configs.base import ModelConfig as JCfg
    from repro_torch.configs.base import ModelConfig as TCfg
    base = dict(name="t", family=family, num_layers=2, d_model=64,
                num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=97)
    base.update(kw)
    return JCfg(**base), TCfg(**base)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_rwkv_chunked_matches_stepwise_and_jax():
    jcfg, tcfg = _mini("ssm", num_heads=0, num_kv_heads=0, rwkv_head_dim=16)
    jp = jssm.init_rwkv_time_mix(jax.random.PRNGKey(0), jcfg, jnp.float32)
    tp = params_from_jax(_np_tree(jp), device="cpu")
    b, s, d = 1, 10, 64
    x = np.random.default_rng(1).standard_normal((b, s, d)).astype(np.float32) * 0.5
    st = np.zeros((b, d // 16, 16, 16), np.float32)
    sh = np.zeros((b, d), np.float32)
    jout, jst, _ = jssm.rwkv_time_mix(jp, jnp.asarray(x), jnp.asarray(st),
                                      jnp.asarray(sh), jcfg, chunk=4)
    tx = torch.from_numpy(x)
    tout, tst, _ = tssm.rwkv_time_mix(tp, tx, torch.from_numpy(st),
                                      torch.from_numpy(sh), tcfg, chunk=4)
    close(tout, jout, 1e-4)
    close(tst, jst, 1e-4)
    outs, st_s, sh_s = [], torch.from_numpy(st), torch.from_numpy(sh)
    for t in range(s):
        o, st_s, sh_s = tssm.rwkv_time_mix_step(tp, tx[:, t:t + 1], st_s,
                                                sh_s, tcfg)
        outs.append(o)
    # the reference's own tolerance for chunked against stepwise
    close(torch.cat(outs, dim=1), tout.numpy(), 1e-3)
    close(st_s, tst.numpy(), 1e-3)
    jcm = jssm.init_rwkv_channel_mix(jax.random.PRNGKey(2), jcfg, jnp.float32)
    tcm = params_from_jax(_np_tree(jcm), device="cpu")
    jo, jsh = jssm.rwkv_channel_mix(jcm, jnp.asarray(x), jnp.asarray(sh))
    to, tsh = tssm.rwkv_channel_mix(tcm, tx, torch.from_numpy(sh))
    close(to, jo, 1e-4)
    close(tsh, jsh, 1e-4)


@pytest.mark.parametrize("s", [9, 300])
def test_mamba_chunked_matches_stepwise_and_jax(s):
    """s = 300 crosses two of the 128-token chunk boundaries."""
    jcfg, tcfg = _mini("hybrid", ssm_state_dim=8, ssm_expand=2,
                       ssm_conv_dim=4)
    jp = jssm.init_mamba(jax.random.PRNGKey(0), jcfg, jnp.float32)
    tp = params_from_jax(_np_tree(jp), device="cpu")
    b, d = 1, 64
    di = 2 * d
    x = np.random.default_rng(1).standard_normal((b, s, d)).astype(np.float32) * 0.5
    h0 = np.zeros((b, di, 8), np.float32)
    c0 = np.zeros((b, 3, di), np.float32)
    chunk = 4 if s < 128 else tssm.MAMBA_CHUNK
    jout, jh, jc = jssm.mamba_forward(jp, jnp.asarray(x), jnp.asarray(h0),
                                      jnp.asarray(c0), jcfg, chunk=chunk)
    tx = torch.from_numpy(x)
    tout, th, tc = tssm.mamba_forward(tp, tx, torch.from_numpy(h0),
                                      torch.from_numpy(c0), tcfg, chunk=chunk)
    close(tout, jout, 1e-4)
    close(th, jh, 1e-4)
    close(tc, jc, 1e-4)
    outs, h_s, c_s = [], torch.from_numpy(h0), torch.from_numpy(c0)
    for t in range(s):
        o, h_s, c_s = tssm.mamba_step(tp, tx[:, t:t + 1], h_s, c_s, tcfg)
        outs.append(o)
    # the reference's own tolerance for chunked against stepwise
    close(torch.cat(outs, dim=1), tout.numpy(), 1e-3)
    close(h_s, th.numpy(), 1e-3)
    close(c_s, tc.numpy(), 1e-3)


def test_mamba_step_matches_jax():
    jcfg, tcfg = _mini("hybrid", ssm_state_dim=8, ssm_expand=2,
                       ssm_conv_dim=4)
    jp = jssm.init_mamba(jax.random.PRNGKey(3), jcfg, jnp.float32)
    tp = params_from_jax(_np_tree(jp), device="cpu")
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 1, 64)).astype(np.float32)
    h = rng.standard_normal((2, 128, 8)).astype(np.float32)
    c = rng.standard_normal((2, 3, 128)).astype(np.float32)
    jo, jh, jc = jssm.mamba_step(jp, jnp.asarray(x), jnp.asarray(h),
                                 jnp.asarray(c), jcfg)
    to, th, tc = tssm.mamba_step(tp, torch.from_numpy(x), torch.from_numpy(h),
                                 torch.from_numpy(c), tcfg)
    close(to, jo, 1e-4)
    close(th, jh, 1e-4)
    close(tc, jc, 1e-4)


@pytest.mark.parametrize("window", [None, 8, 64])
def test_mask_bias_matches_jax(window):
    rng = np.random.default_rng(window or 0)
    q = np.sort(rng.integers(0, 100, 12)).astype(np.int32)
    k = np.arange(100, dtype=np.int32)
    jb = jattn._mask_bias(jnp.asarray(q), jnp.asarray(k), window)
    tb = tattn._mask_bias(torch.from_numpy(q), torch.from_numpy(k), window)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


@pytest.mark.parametrize("is_global", [False, True])
def test_gemma_window_matches_jax(is_global):
    """A local layer (window 64, 10k RoPE) and a global one (full causal,
    the config's RoPE) of the reduced gemma3, at 80 tokens, in prefill
    (as one pass and in query chunks) and in decode past the window."""
    jm, jp, tm, tp = _pair("gemma3-27b", "float32")
    cfg = tm.cfg
    assert cfg.sliding_window == 64 and tm._is_global_flags() == [False, True]
    jl = jax.tree_util.tree_map(lambda t: t[1 if is_global else 0],
                                jp["layers"])["attn"]
    tl = layer_slice(tp["layers"], 1 if is_global else 0)["attn"]
    x = np.random.default_rng(7).standard_normal((1, 80, cfg.d_model))
    x = x.astype(np.float32)
    jo = jattn.causal_attention(jl, jnp.asarray(x), jm.cfg,
                                is_global=jnp.asarray(is_global))
    for q_chunk in (1024, 16):
        to = tattn.causal_attention(tl, torch.from_numpy(x), cfg,
                                    is_global=is_global, q_chunk=q_chunk)
        close(to, jo, 1e-4)
    cache = np.random.default_rng(8).standard_normal(
        (2, 1, 96, cfg.num_kv_heads, cfg.resolved_head_dim)).astype(np.float32)
    jd, jc = jattn.decode_attention(jl, jnp.asarray(x[:, :1]),
                                    jnp.asarray(cache), jnp.asarray(90),
                                    jm.cfg, is_global=jnp.asarray(is_global))
    td, tc = tattn.decode_attention(tl, torch.from_numpy(x[:, :1]),
                                    torch.from_numpy(cache), 90, cfg,
                                    is_global=is_global)
    close(td, jd, 1e-4)
    close(tc, jc, 1e-4)
