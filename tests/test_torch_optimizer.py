"""The port's optimizers, train step and data stream against the JAX
package's.

One Adam and one Adafactor step run on the same params, grads and state
(numpy from a seed, carried to each side) at fp32 1e-6; three
``make_train_step`` steps on reduced qwen3 and reduced qwen2-moe run from
shared weights on the reference's packed batches at fp32 1e-4, the
absolute part scaled by each leaf's largest magnitude (the gradients
differ by summation order, and Adam's first steps divide by their square
roots).  ``PackedStream`` batches must be bit-identical.
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
from repro.training import data as jdata
from repro.training import optimizer as jopt
from repro_torch.configs import get_config
from repro_torch.models import build_model, params_from_jax
from repro_torch.training import optimizer as topt
from repro_torch.training.data import DataConfig, PackedStream

# a layer-stacked 3D leaf, a plain matrix, a stacked and a plain vector,
# a bf16 matrix: every layout the update distinguishes
LAYERS = {"stack": (3, 6, 5), "mat": (4, 7), "vecs": (3, 5), "bf16": (5, 4)}


def _tree(rng, scale=1.0):
    """numpy fp32 leaves; ``_to_jax`` / ``_to_torch`` make "bf16" bf16."""
    draw = lambda shape: (rng.standard_normal(shape) * scale).astype(
        np.float32)
    return {"layers": {k: draw(shape) for k, shape in LAYERS.items()},
            "vec": draw((6,))}


def _to_jax(tree):
    return {k: _to_jax(v) if isinstance(v, dict) else
            jnp.asarray(v, jnp.bfloat16 if k == "bf16" else jnp.float32)
            for k, v in tree.items()}


def _to_torch(tree):
    return {k: _to_torch(v) if isinstance(v, dict) else
            torch.from_numpy(v).to(torch.bfloat16 if k == "bf16"
                                   else torch.float32)
            for k, v in tree.items()}


def leaves_by_path(jax_tree, port_tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(jax_tree)[0]:
        t = port_tree
        for k in path:
            t = t[k.key]
        yield tuple(k.key for k in path), leaf, t


def close(actual, expected, tol, scaled=False):
    expected = np.asarray(expected, np.float32)
    atol = tol * max(1.0, float(np.abs(expected).max())) if scaled else tol
    np.testing.assert_allclose(actual.detach().float().numpy(), expected,
                               rtol=tol, atol=atol)


def assert_trees_close(jax_tree, port_tree, tol, scaled=False):
    n = 0
    for path, j, t in leaves_by_path(jax_tree, port_tree):
        assert tuple(t.shape) == j.shape, path
        assert str(t.dtype).removeprefix("torch.") == str(j.dtype), path
        try:
            close(t, j, tol, scaled)
        except AssertionError as e:
            raise AssertionError(f"{path}: {e}") from None
        n += 1
    assert n == len(topt.tree_leaves(port_tree))


@pytest.mark.parametrize("step", [0, 6])
@pytest.mark.parametrize("kind", ["adam", "adafactor"])
def test_one_step_matches_jax(kind, step):
    """Params, grads and a non-zero optimizer state (a few updates in)
    give the reference's new params and state, leaf for leaf."""
    rng = np.random.default_rng(0)
    params = _tree(rng)
    _, jinit, jupdate = jopt.make_optimizer(kind)
    _, tinit, tupdate = topt.make_optimizer(kind)
    jp, tp = _to_jax(params), _to_torch(params)
    js, ts = jinit(jp), tinit(tp)
    assert_trees_close(js, ts, 0)        # the same state layout, zeroed
    for i in range(step + 1):
        grads = _tree(rng, 0.3)
        jp, js = jupdate(jp, _to_jax(grads), js, jnp.asarray(i, jnp.int32))
        tp, ts = tupdate(tp, _to_torch(grads), ts,
                         torch.tensor(i, dtype=torch.int32))
    assert_trees_close(jp, tp, 1e-6)
    assert_trees_close(js, ts, 1e-6)


@pytest.mark.parametrize("kind", ["adam", "adafactor"])
def test_donated_update_equals_the_functional_one(kind):
    _, init, update = topt.make_optimizer(kind)
    rng = np.random.default_rng(1)
    params, grads = _to_torch(_tree(rng)), _to_torch(_tree(rng, 0.3))
    state = init(params)
    step = torch.tensor(2, dtype=torch.int32)
    want_p, want_s = update(params, grads, state, step)
    got_p, got_s = update(params, grads, state, step, donate=True)
    for a, b, old in zip(topt.tree_leaves({"p": got_p, "s": got_s}),
                         topt.tree_leaves({"p": want_p, "s": want_s}),
                         topt.tree_leaves({"p": params, "s": state})):
        assert torch.equal(a, b)
        assert a is old, "the donated state is updated in place"


def _train_pair(arch):
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(), dtype="float32")
    tcfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    jm = jax_build_model(jcfg)
    jp = jm.init_params(jax.random.PRNGKey(0))
    return jm, jp, build_model(tcfg), params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp), device="cpu")


@pytest.mark.parametrize("kind", ["adam", "adafactor"])
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "qwen2-moe-a2.7b"])
def test_three_train_steps_match_jax(arch, kind):
    jm, jp, tm, tp = _train_pair(arch)
    _, jstep = jopt.make_train_step(jm, kind)
    _, tstep = topt.make_train_step(tm, kind)
    _, jinit, _ = jopt.make_optimizer(kind)
    _, tinit, _ = topt.make_optimizer(kind)
    jstate = {"params": jp, "opt": jinit(jp), "step": jnp.zeros((), jnp.int32)}
    tstate = {"params": tp, "opt": tinit(tp),
              "step": torch.zeros((), dtype=torch.int32)}
    data = jdata.PackedStream(jdata.DataConfig(tm.cfg.vocab_size, 32, 2))
    jstep = jax.jit(jstep)
    for i in range(3):
        batch = data.batch(i)
        jstate, jmet = jstep(jstate, {k: jnp.asarray(v)
                                      for k, v in batch.items()})
        tstate, tmet = tstep(tstate, {k: torch.from_numpy(v)
                                      for k, v in batch.items()})
        for k in ("loss", "ce", "aux"):
            close(tmet[k], jmet[k], 1e-4)
    assert int(tstate["step"]) == int(jstate["step"]) == 3
    assert_trees_close(jstate["params"], tstate["params"], 1e-4, scaled=True)
    assert_trees_close(jstate["opt"], tstate["opt"], 1e-4, scaled=True)


@pytest.mark.parametrize("kind", ["adam", "adafactor"])
def test_optimizer_reduces_quadratic(kind):
    """tests/test_model_components.py's case, on the port."""
    _, init, update = topt.make_optimizer(kind)
    params = {"w": torch.tensor([5.0, -3.0, 2.0])}
    state = init(params)
    start = float(torch.sum(params["w"] ** 2))
    for step in range(800):
        grads = {"w": 2 * params["w"]}       # d/dw ||w||^2
        params, state = update(params, grads, state, torch.tensor(step))
    end = float(torch.sum(params["w"] ** 2))
    assert np.isfinite(end) and end < start * 0.95, (start, end)


def test_data_pipeline_deterministic_and_sharded():
    """tests/test_model_components.py's case, on the port."""
    cfg = DataConfig(vocab_size=100, seq_len=32, global_batch=8, seed=3)
    ds = PackedStream(cfg)
    b1 = ds.batch(5)
    b2 = ds.batch(5)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    # shards partition the global batch
    s0 = ds.batch(5, shard=0, num_shards=2)
    s1 = ds.batch(5, shard=1, num_shards=2)
    np.testing.assert_array_equal(
        np.concatenate([s0["tokens"], s1["tokens"]]), b1["tokens"])
    # labels are next-token shifted
    np.testing.assert_array_equal(b1["tokens"][:, 1:], b1["labels"][:, :-1])
    assert b1["tokens"].max() < 100


@pytest.mark.parametrize("vocab, seq, batch, seed", [
    (100, 32, 8, 3), (151936, 1024, 4, 0), (512, 128, 4, 7)])
def test_packed_stream_equals_jax(vocab, seq, batch, seed):
    ours = PackedStream(DataConfig(vocab, seq, batch, seed))
    ref = jdata.PackedStream(jdata.DataConfig(vocab, seq, batch, seed))
    for step in (0, 1, 17):
        for shard, n in ((0, 1), (1, 2)):
            a, b = ours.batch(step, shard, n), ref.batch(step, shard, n)
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])


def test_train_small_runs_on_the_cpu():
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(src))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.train_small", "--device", "cpu",
         "--steps", "12"], env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "OK — decreasing" in out.stdout
