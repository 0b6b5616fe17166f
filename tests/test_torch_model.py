"""The port's model numerics against the JAX package's, at the reduced
qwen3-1.7b (2 layers, d 256, 4 heads over 2 KV heads, hd 64).

Both sides run the same weights: the JAX param pytree is carried across
through numpy by ``params_from_jax``.  Inputs are made by numpy from a
seed.  Layer functions are held to fp32 1e-6 relative to the output's
largest magnitude (the two frameworks sum matrix products in different
orders); whole-model prefill logits to fp32 1e-4 and bf16 2e-2 (bf16
rounds at different points in the two frameworks, and the error compounds
over layers).
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro_torch.configs import get_config
from repro_torch.configs.base import MoEConfig
from repro_torch.models import LanguageModel, params_from_jax
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models.layers import layer_slice


def _configs(dtype):
    jcfg = dataclasses.replace(jax_get_config("qwen3-1.7b").reduced(),
                               dtype=dtype)
    tcfg = dataclasses.replace(get_config("qwen3-1.7b").reduced(),
                               dtype=dtype)
    return jcfg, tcfg


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def models(request):
    """(jax model, jax params, port model, port params) on shared weights."""
    jcfg, tcfg = _configs(request.param)
    jm = jax_build_model(jcfg)
    jp = jm.init_params(jax.random.PRNGKey(0))
    np_tree = jax.tree_util.tree_map(np.asarray, jp)
    return jm, jp, LanguageModel(tcfg), params_from_jax(np_tree, tcfg,
                                                        device="cpu")


def close(actual, expected, tol, scaled=False):
    """allclose at ``tol``; ``scaled`` measures the absolute part against
    the expected output's largest magnitude."""
    if isinstance(actual, torch.Tensor):
        actual = actual.float().numpy()
    expected = np.asarray(expected, np.float32)
    atol = tol * max(1.0, float(np.abs(expected).max())) if scaled else tol
    np.testing.assert_allclose(np.asarray(actual, np.float32), expected,
                               rtol=tol, atol=atol)


def test_params_from_jax_round_trips_every_leaf(models):
    jm, jp, tm, tp = models
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    seen = 0
    for path, leaf in jflat:
        t = tp
        for k in path:
            t = t[k.key]
        assert tuple(t.shape) == leaf.shape, path
        assert str(t.dtype).removeprefix("torch.") == str(leaf.dtype), path
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(leaf, np.float32))
        seen += 1
    n_port = sum(1 for _ in jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(lambda x: 0, tp)))
    assert seen == n_port


def test_init_params_mirrors_the_jax_layout():
    """The port's seeded initialiser builds the same tree, shapes and
    dtypes as the JAX package's."""
    jcfg, tcfg = _configs("bfloat16")
    jp = jax_build_model(jcfg).init_params(jax.random.PRNGKey(0))
    tp = LanguageModel(tcfg).init_params(torch.Generator().manual_seed(0),
                                         device="cpu")
    jshapes = jax.tree_util.tree_map(lambda x: (x.shape, str(x.dtype)), jp)
    tshapes = jax.tree_util.tree_map(
        lambda x: (tuple(x.shape), str(x.dtype).removeprefix("torch.")), tp)
    assert jshapes == tshapes


def test_layer_functions_match_jax_fp32():
    jcfg, tcfg = _configs("float32")
    jp = jax_build_model(jcfg).init_params(jax.random.PRNGKey(1))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                         device="cpu")
    jl = jax.tree_util.tree_map(lambda x: x[0], jp["layers"])
    tl = layer_slice(tp["layers"], 0)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, tcfg.d_model), np.float32)
    scale = rng.standard_normal(tcfg.d_model, np.float32) * 0.1
    close(tlayers.rms_norm(torch.from_numpy(x), torch.from_numpy(scale)),
          jlayers.rms_norm(jnp.asarray(x), jnp.asarray(scale)), 1e-6, True)
    close(tlayers.swiglu(torch.from_numpy(x), **tl["ffn"]),
          jlayers.swiglu(jnp.asarray(x), **jl["ffn"]), 1e-6, True)
    pos = rng.integers(0, 4096, 9).astype(np.int32)
    ts, tc = tlayers.rope_at(torch.from_numpy(pos), 64, tcfg.rope_theta)
    js, jc = jlayers.rope_at(jnp.asarray(pos), 64, jcfg.rope_theta)
    close(ts, js, 1e-6, True)
    close(tc, jc, 1e-6, True)
    heads = rng.standard_normal((2, 9, 4, 64), np.float32)
    close(tlayers.apply_rope(torch.from_numpy(heads), ts, tc),
          jlayers.apply_rope(jnp.asarray(heads), js, jc), 1e-6, True)
    # qk-norm sits inside the projection: give the norms non-zero scales
    tl["attn"] = dict(tl["attn"], q_norm=torch.full((64,), 0.3),
                      k_norm=torch.full((64,), -0.2))
    jl["attn"] = dict(jl["attn"], q_norm=jnp.full((64,), 0.3),
                      k_norm=jnp.full((64,), -0.2))
    for a, b in zip(tattn._project_qkv(tl["attn"], torch.from_numpy(x),
                                       torch.from_numpy(x), tcfg),
                    jattn._project_qkv(jl["attn"], jnp.asarray(x),
                                       jnp.asarray(x), jcfg)):
        close(a, b, 1e-6, True)


def test_prefill_logits_match_jax(models):
    jm, jp, tm, tp = models
    tol = 1e-4 if tm.cfg.dtype == "float32" else 2e-2
    tokens = np.random.default_rng(3).integers(0, 500, (2, 21)).astype(np.int32)
    jlogits, jcache = jm.prefill(jp, jnp.asarray(tokens))
    tlogits, tcache = tm.prefill(tp, torch.from_numpy(tokens))
    assert tlogits.shape == jlogits.shape
    close(tlogits, jlogits, tol)
    if tm.cfg.dtype == "float32":
        close(tcache["kv"], jcache["kv"], tol)
    assert tcache["pos"] == int(jcache["pos"])


def test_decode_step_matches_jax(models):
    """``tests/test_models_smoke.py``'s decode cases on qwen3: one token
    over the prefill's cache (grown to hold it) gives the JAX package's
    logits and cache, and agrees with the longer prefill."""
    jm, jp, tm, tp = models
    tol = 1e-4 if tm.cfg.dtype == "float32" else 2e-2
    tokens = np.random.default_rng(4).integers(0, 500, (2, 10)).astype(np.int32)
    _, jcache = jm.prefill(jp, jnp.asarray(tokens[:, :9]))
    _, tcache = tm.prefill(tp, torch.from_numpy(tokens[:, :9]))
    jcache = dict(jcache, kv=jnp.pad(jcache["kv"], [(0, 0)] * 3
                                     + [(0, 4), (0, 0), (0, 0)]))
    tcache = dict(tcache, kv=torch.nn.functional.pad(
        tcache["kv"], (0, 0, 0, 0, 0, 4)))
    kv_before = tcache["kv"].clone()
    jlog, jnew = jm.decode_step(jp, jcache, jnp.asarray(tokens[:, 9:10]))
    tlog, tnew = tm.decode_step(tp, tcache, torch.from_numpy(tokens[:, 9:10]))
    assert tlog.shape == jlog.shape == (2, tm.cfg.vocab_size)
    assert torch.isfinite(tlog.float()).all()
    close(tlog, jlog, tol)
    close(tnew["kv"], jnew["kv"], tol)
    assert tnew["pos"] == int(jnew["pos"]) == 10
    assert torch.equal(tcache["kv"], kv_before), "the input cache is kept"
    full, _ = tm.prefill(tp, torch.from_numpy(tokens))
    close(tlog, full.float().numpy(),
          1e-4 if tm.cfg.dtype == "float32" else 5e-2)


def test_unported_families_raise():
    cfg = get_config("qwen3-1.7b").reduced()
    for bad in (dataclasses.replace(cfg, moe=MoEConfig(4, 2, 128)),
                dataclasses.replace(cfg, sliding_window=64),
                dataclasses.replace(cfg, family="ssm",
                                    layer_pattern=("rwkv", "rwkv"))):
        with pytest.raises(NotImplementedError):
            LanguageModel(bad)


def test_port_imports_no_jax():
    """Importing the whole port leaves jax out of sys.modules."""
    code = ("import sys\n"
            "import repro_torch, repro_torch.serving, repro_torch.models, "
            "repro_torch.kernels, repro_torch.configs, repro_torch.obs, "
            "repro_torch.core, repro_torch.agents, repro_torch.quickstart\n"
            "import repro_torch.kernels.build, repro_torch.serving.cluster, "
            "repro_torch.serving.faults, repro_torch.serving.recovery, "
            "repro_torch.serving.config, repro_torch.obs.slo, "
            "repro_torch.obs.critical_path, repro_torch.agents.messaging\n"
            "import repro_torch.core.balancer, repro_torch.core.dispatcher, "
            "repro_torch.core.distributions, repro_torch.core.memory_model, "
            "repro_torch.core.orchestrator, repro_torch.core.priority, "
            "repro_torch.core.scheduler, repro_torch.core.workflow\n"
            "import repro_torch.serving.migration, "
            "repro_torch.serving.handoff, repro_torch.serving.autoscaler, "
            "repro_torch.sim, repro_torch.sim.cost_model, "
            "repro_torch.sim.simulator, repro_torch.sim.workload, "
            "repro_torch.workloads, repro_torch.workloads.traces, "
            "repro_torch.obs.export, repro_torch.cluster_sim\n"
            "assert 'jax' not in sys.modules, 'jax imported'\n"
            "assert not any(m == 'repro' or m.startswith('repro.') "
            "for m in sys.modules), 'repro imported'\n")
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(src))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)


def test_bare_cuda_device_is_pinned_to_the_current_card(monkeypatch):
    """Tensors made on ``"cuda"`` report ``"cuda:<index>"``; the resolved
    device must compare equal to them."""
    from repro_torch.device import resolve_device
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    assert resolve_device("cuda") == torch.device("cuda:0")
    assert resolve_device("cuda:0") == torch.device("cuda:0")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert resolve_device("cpu") == torch.device("cpu")
