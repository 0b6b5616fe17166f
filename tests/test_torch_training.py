"""The port's training loss and its gradients against the JAX package's, at
every reduced arch (2 layers, d 256; the MoE archs 4 experts, top 2).

Both sides run the same weights: the JAX param pytree is carried across
through numpy by ``params_from_jax``.  Tokens, labels and the
encoder-decoder's frames are made by numpy from a seed.  The loss and the
gradient of every leaf are held to ``jax.grad`` of the reference's
``loss`` at fp32 1e-4, the absolute part scaled by the leaf's largest
magnitude (the two frameworks sum in different orders, and RWKV's decays
amplify it); the bf16 loss to 2e-2, scaled the same way.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode
from torch.utils.checkpoint import checkpoint

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models import layers as jlayers
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import build_model, params_from_jax
from repro_torch.models import layers as tlayers
from repro_torch.models import model as model_mod
from repro_torch.training.optimizer import tree_leaves, tree_map

B, S = 2, 24


def _pair(arch, dtype, seed=0):
    """(jax model, jax params, port model, port params) on shared
    weights."""
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(), dtype=dtype)
    tcfg = dataclasses.replace(get_config(arch).reduced(), dtype=dtype)
    jm = jax_build_model(jcfg)
    jp = jm.init_params(jax.random.PRNGKey(seed))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                         device="cpu")
    return jm, jp, build_model(tcfg), tp


def make_batch(cfg, seed=1, mask=False, shape=(B, S)):
    """numpy tokens, labels[, frames][, a 0/1 mask]."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, shape).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, shape).astype(np.int32)}
    if cfg.is_encdec:
        batch["frames"] = rng.standard_normal((*shape, cfg.d_model)).astype(
            np.float32)
    if mask:
        batch["mask"] = (rng.random((B, S)) < 0.7).astype(np.float32)
    return batch


def port_loss_and_grads(model, params, batch):
    """(loss, metrics, grads as a tree like ``params``) from the port."""
    tracked = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, metrics = model.loss(tracked, {k: torch.from_numpy(v)
                                         for k, v in batch.items()})
    grads = torch.autograd.grad(loss, tree_leaves(tracked), allow_unused=True,
                                materialize_grads=True)
    it = iter(grads)
    return loss.detach(), metrics, tree_map(lambda _: next(it), params)


def plain_call(fn, *args, **kw):
    """``checkpoint``'s stand-in that keeps every activation."""
    return fn(*args)


class Float64(TorchFunctionMode):
    """Evaluates the port in float64: every float32 dtype argument and
    every ``Tensor.float()`` becomes float64."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func is torch.Tensor.float:
            return args[0].double()
        wide = lambda a: torch.float64 if a is torch.float32 else a
        return func(*map(wide, args),
                    **{k: wide(v) for k, v in (kwargs or {}).items()})


def scaled_err(actual, expected) -> float:
    """The largest error over the expected value's largest magnitude."""
    a, e = np.asarray(actual, np.float64), np.asarray(expected, np.float64)
    return float(np.abs(a - e).max()) / max(1.0, float(np.abs(e).max()))


def close(actual, expected, tol):
    """allclose at ``tol``, the absolute part scaled by the expected
    value's largest magnitude."""
    if isinstance(actual, torch.Tensor):
        actual = actual.detach().float().numpy()
    expected = np.asarray(expected, np.float32)
    atol = tol * max(1.0, float(np.abs(expected).max()))
    np.testing.assert_allclose(np.asarray(actual, np.float32), expected,
                               rtol=tol, atol=atol)


def each_leaf(jax_tree, port_tree):
    """(path, jax leaf, port leaf) for every leaf of the JAX tree."""
    for path, leaf in jax.tree_util.tree_flatten_with_path(jax_tree)[0]:
        t = port_tree
        for k in path:
            t = t[k.key]
        yield tuple(k.key for k in path), leaf, t


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_and_every_gradient_match_jax_fp32(arch):
    jm, jp, tm, tp = _pair(arch, "float32")
    batch = make_batch(tm.cfg)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, met, grads = port_loss_and_grads(tm, tp, batch)
    close(loss, jloss, 1e-4)
    close(met["ce"], jmet["ce"], 1e-4)
    close(met["aux"], jmet["aux"], 1e-4)
    if tm.cfg.moe is not None:
        assert float(met["aux"].detach()) > 0, "the MoE aux reaches the loss"
    n = 0
    for path, jg, tg in each_leaf(jgrads, grads):
        assert tuple(tg.shape) == jg.shape and tg.dtype == torch.float32, path
        try:
            close(tg, jg, 1e-4)
        except AssertionError as e:
            raise AssertionError(f"{arch} grad {path}: {e}") from None
        n += 1
    assert n == len(tree_leaves(tp))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_matches_jax_bf16(arch):
    jm, jp, tm, tp = _pair(arch, "bfloat16")
    batch = make_batch(tm.cfg, seed=2)
    jloss, _ = jax.jit(jm.loss)(jp, {k: jnp.asarray(v)
                                     for k, v in batch.items()})
    loss, met, grads = port_loss_and_grads(tm, tp, batch)
    close(loss, jloss, 2e-2)
    for leaf, g in zip(tree_leaves(tp), tree_leaves(grads)):
        assert g.dtype == leaf.dtype and bool(torch.isfinite(g.float()).all())


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "qwen2-moe-a2.7b"])
def test_masked_loss_matches_jax(arch):
    jm, jp, tm, tp = _pair(arch, "float32", seed=3)
    batch = make_batch(tm.cfg, seed=4, mask=True)
    jloss, _ = jm.loss(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, _, _ = port_loss_and_grads(tm, tp, batch)
    close(loss, jloss, 1e-4)


@pytest.mark.parametrize("mask", [None, "float", "int", "empty"])
def test_softmax_cross_entropy_matches_jax(mask):
    rng = np.random.default_rng(5)
    logits = (rng.standard_normal((3, 7, 50)) * 4).astype(np.float32)
    targets = rng.integers(0, 50, (3, 7)).astype(np.int32)
    m = {None: None,
         "float": (rng.random((3, 7)) < 0.5).astype(np.float32),
         "int": (rng.random((3, 7)) < 0.5).astype(np.int32),
         "empty": np.zeros((3, 7), np.float32)}[mask]
    want = jlayers.softmax_cross_entropy(
        jnp.asarray(logits), jnp.asarray(targets),
        None if m is None else jnp.asarray(m))
    got = tlayers.softmax_cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(targets),
        None if m is None else torch.from_numpy(m))
    assert got.dtype == torch.float32 and got.shape == ()
    close(got, want, 1e-6)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_checkpointed_gradients_equal_uncheckpointed(arch, monkeypatch):
    """Recomputing each layer in the backward changes no gradient."""
    _, _, tm, tp = _pair(arch, "float32")
    batch = make_batch(tm.cfg, seed=6)
    calls = []

    def counted(fn, *args, **kw):
        calls.append(fn)
        return checkpoint(fn, *args, **kw)

    monkeypatch.setattr(model_mod, "checkpoint", counted)
    loss, _, grads = port_loss_and_grads(tm, tp, batch)
    n_blocks = (tm.cfg.num_layers if tm.cfg.is_encdec or tm.uniform_kind
                else tm.n_blocks)
    assert len(calls) == n_blocks, "train mode checkpoints every layer"
    monkeypatch.setattr(model_mod, "checkpoint", plain_call)
    loss2, _, grads2 = port_loss_and_grads(tm, tp, batch)
    assert torch.equal(loss, loss2)
    for a, b in zip(tree_leaves(grads), tree_leaves(grads2)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "rwkv6-3b", "jamba-v0.1-52b",
                                  "seamless-m4t-large-v2"])
def test_serving_builds_no_graph(arch):
    """With every param leaf requiring grad, ``prefill`` and
    ``decode_step`` still return tensors without ``grad_fn``."""
    _, _, tm, tp = _pair(arch, "float32")
    tracked = tree_map(lambda p: p.detach().requires_grad_(), tp)
    rng = np.random.default_rng(7)
    toks = torch.from_numpy(rng.integers(0, tm.cfg.vocab_size, (B, 9))
                            .astype(np.int32))
    extra = []
    if tm.cfg.is_encdec:
        extra = [torch.from_numpy(rng.standard_normal(
            (B, 5, tm.cfg.d_model)).astype(np.float32))]
    logits, cache = tm.prefill(tracked, toks, *extra)
    if "kv" in cache:
        cache = dict(cache, kv=torch.nn.functional.pad(
            cache["kv"], (0, 0, 0, 0, 0, 1)))
    dec, new = tm.decode_step(tracked, cache, toks[:, :1])
    outs = [logits, dec] + [v for c in (cache, new) for v in c.values()
                            if isinstance(v, torch.Tensor)]
    for t in outs:
        assert t.grad_fn is None and not t.requires_grad


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "rwkv6-3b", "jamba-v0.1-52b"])
def test_float32_gradients_as_far_from_float64_as_jax(arch, monkeypatch):
    """The port's float32 gradients lie no farther from the port's float64
    evaluation than ``jax.grad``'s float32 gradients do: what float32
    loses is the function's, not the port's.  The weights and batch are
    those of ``chip_smoke.py``'s card-against-CPU check (the port's
    initialiser, seed 0; 2 x 32 tokens), where rwkv6's chunked decays lose
    the most.  The float64 run keeps its activations, since a
    checkpoint's recompute runs outside the mode."""
    jm = jax_build_model(dataclasses.replace(jax_get_config(arch).reduced(),
                                             dtype="float32"))
    tm = build_model(dataclasses.replace(get_config(arch).reduced(),
                                         dtype="float32"))
    tp = tm.init_params(torch.Generator().manual_seed(0), "cpu")
    jp = tree_map(lambda t: jnp.asarray(t.numpy()), tp)
    batch = make_batch(tm.cfg, seed=0, shape=(2, 32))
    jgrads = jax.jit(jax.grad(lambda p, b: jm.loss(p, b)[0]))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    _, _, grads = port_loss_and_grads(tm, tp, batch)
    monkeypatch.setattr(model_mod, "checkpoint", plain_call)
    with Float64():
        _, _, grads64 = port_loss_and_grads(
            tm, tree_map(torch.Tensor.double, tp), batch)
    d_port = d_jax = 0.0
    for path, jg, g64 in each_leaf(jgrads, grads64):
        assert g64.dtype == torch.float64, path
        t = grads
        for k in path:
            t = t[k]
        d_port = max(d_port, scaled_err(t.numpy(), g64.numpy()))
        d_jax = max(d_jax, scaled_err(jg, g64.numpy()))
    assert d_port <= 2 * d_jax + 1e-6, (d_port, d_jax)
