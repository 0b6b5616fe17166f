"""The model on DTensors computes what it computes on plain tensors.

Four processes form a gloo process group on the CPU (through a file
store in a temporary directory), each a rank of a
(2, 2) ("data", "model") mesh and of a (1, 4) one, where the reduced
qwen3's 2 KV heads split unevenly over 4 model ranks.  Each rank builds
the same seeded float32 weights, shards params, caches and tokens by
``repro_torch.models.sharding`` as the dry-run does (FSDP on), pins the
activations, and runs ``prefill``, ``decode_step`` at position S - 1 and
the loss with its gradient, and one Adafactor train step of the
qwen2-moe variant; rank 0 gathers every result whole.  Each is held to
the same call on plain tensors at 1e-4 of its largest magnitude (the
sharded sums add in another order; the Adafactor step at 1e-3, see its
test).
"""
import os
import subprocess
import sys
import tempfile
import time

import pytest
import torch

# "qwen2-moe-a2.7b:e6": six experts, expert-parallel over 2 model ranks,
# while 4 cannot split them, so there each expert runs tensor-parallel
# and its product is a partial sum; "qwen3-1.7b:h6": six query heads,
# which 4 ranks cannot split either, so the queries are split instead
ARCHS = ("qwen3-1.7b", "qwen3-1.7b:h6", "qwen2-moe-a2.7b:e6", "rwkv6-3b",
         "jamba-v0.1-52b", "seamless-m4t-large-v2")
MESHES = ((2, 2), (1, 4))
B, S = 4, 16
# one Adafactor train step on a sharded state: the expert weights' row
# and column factors are laid out unlike their gradients
ADAFACTOR_ARCH = "qwen2-moe-a2.7b:e6"


def _cfg(arch):
    import dataclasses
    from repro_torch.configs import get_config
    name, _, variant = arch.partition(":")
    cfg = dataclasses.replace(get_config(name).reduced(), dtype="float32")
    if variant == "e6":
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, num_experts=6))
    if variant == "h6":
        cfg = dataclasses.replace(cfg, num_heads=6)
    return cfg


def _inputs(cfg):
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           dtype=torch.int32)
    frames = torch.randn(B, S // 2, cfg.d_model, generator=gen)
    return tokens, frames


def _params(model):
    return model.init_params(torch.Generator().manual_seed(0), "cpu")


def run(arch, shard=None):
    """{name: tensor} of one arch's prefill logits, decode logits, loss
    and gradients.  ``shard`` puts the params and inputs on a mesh (and
    ``shard.cache`` the decode cache); None runs on plain tensors."""
    import torch.nn.functional as F
    from repro_torch.models import build_model
    from repro_torch.training.optimizer import tree_leaves
    cfg = _cfg(arch)
    model = build_model(cfg)
    params = _params(model)
    tokens, frames = _inputs(cfg)
    extra = (frames,) if cfg.is_encdec else ()
    if shard is not None:
        params, tokens, extra, model = shard(model, cfg, params, tokens,
                                             extra)
    out = {}
    logits, cache = model.prefill(params, tokens, *extra)
    out["prefill"] = logits
    # decode at S - 1 on the cache of the first S - 1 tokens, padded by one
    _, c1 = model.prefill(*_plain(params, tokens, extra, S - 1))
    for k, v in c1.items():
        if k in ("kv",):
            c1[k] = F.pad(v, (0, 0, 0, 0, 0, 1))
    c1["pos"] = S - 1
    if shard is not None:
        c1 = shard.cache(cfg, c1)
    logits, _ = model.decode_step(params, c1, tokens[:, S - 1:])
    out["decode"] = logits
    batch = {"tokens": tokens, "labels": tokens}
    if cfg.is_encdec:
        batch["frames"] = extra[0]
    leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
    tracked = _rebuild(params, iter(leaves))
    loss, _ = model.loss(tracked, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    out["loss"] = loss.detach()
    for i, g in enumerate(grads):
        out[f"grad{i}"] = g
    return out


def adafactor_step(arch, shard_state=None):
    """{name: tensor} of the train state after one Adafactor step;
    ``shard_state`` puts the state and the batch on a mesh."""
    from repro_torch.models import build_model
    from repro_torch.training.optimizer import make_train_step, tree_leaves
    cfg = _cfg(arch)
    model = build_model(cfg)
    init_state, train_step = make_train_step(model, "adafactor")
    state = init_state(torch.Generator().manual_seed(0), "cpu")
    tokens, _ = _inputs(cfg)
    batch = {"tokens": tokens, "labels": tokens}
    if shard_state is not None:
        state, batch = shard_state(model, cfg, state, batch)
    state, metrics = train_step(state, batch)
    out = {f"leaf{i}": t for i, t in enumerate(tree_leaves(state))}
    out["loss"] = metrics["loss"]
    return out


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    return next(it)


def _plain(params, tokens, extra, n):
    """Plain copies of the (possibly sharded) args, cut to n tokens."""
    def full(t):
        return t.full_tensor() if hasattr(t, "full_tensor") else t
    from repro_torch.training.optimizer import tree_map
    p = tree_map(full, params)
    return (p, full(tokens)[:, :n], *(full(e) for e in extra))


def _worker(rank: int, store: str, out_path: str) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.dryrun import shard_tensor
    from repro_torch.models.sharding import (NamedMesh, NamedSharding, P,
                                             batch_pspec, cache_pspecs,
                                             param_shardings)
    from repro_torch.training.optimizer import tree_map
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=4)
    try:
        results = {}
        for mesh_shape in MESHES:
            mesh = NamedMesh(init_device_mesh(
                "cpu", mesh_shape, mesh_dim_names=("data", "model")))
            shape = ShapeConfig("t", S, B, "decode")

            def shard(model, cfg, params, tokens, extra):
                bspec = batch_pspec(shape, mesh)
                model.act_sharding = NamedSharding(mesh, P(*bspec, None))
                params = tree_map(shard_tensor, params, param_shardings(
                    params, cfg, mesh, fsdp=True))
                tokens = shard_tensor(tokens, NamedSharding(mesh, bspec))
                extra = tuple(shard_tensor(e, NamedSharding(
                    mesh, P(*bspec, None))) for e in extra)
                return params, tokens, extra, model

            def cache(cfg, c):
                specs = cache_pspecs(cfg, shape, mesh, c)
                return {k: shard_tensor(v, NamedSharding(mesh, specs[k]))
                        if isinstance(v, torch.Tensor) else v
                        for k, v in c.items()}
            shard.cache = cache

            def shard_state(model, cfg, state, batch):
                bspec = batch_pspec(shape, mesh)
                model.act_sharding = NamedSharding(mesh, P(*bspec, None))
                state = tree_map(
                    lambda t, s: shard_tensor(t, s)
                    if isinstance(t, torch.Tensor) else t,
                    state, param_shardings(state, cfg, mesh, fsdp=True))
                batch = {k: shard_tensor(v, NamedSharding(mesh, bspec))
                         for k, v in batch.items()}
                return state, batch

            runs = [(arch, run(arch, shard)) for arch in ARCHS]
            runs.append(("adafactor", adafactor_step(ADAFACTOR_ARCH,
                                                     shard_state)))
            for name, got in runs:
                results[(mesh_shape, name)] = {
                    k: (v.full_tensor() if hasattr(v, "full_tensor") else v)
                    for k, v in got.items()}
        if rank == 0:
            torch.save(results, out_path)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def sharded():
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(src),
               OMP_NUM_THREADS="1")
    # a file store in a fresh directory: no TCP port another test worker
    # could take between choosing it and binding it
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "out.pt")
        store = os.path.join(tmp, "store")
        procs = [subprocess.Popen([sys.executable, __file__, str(r),
                                   store, out], env=env,
                                  stderr=subprocess.PIPE, text=True)
                 for r in range(4)]
        errs = []
        deadline = time.monotonic() + 600    # for all four together
        for p in procs:
            try:
                _, err = p.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                _, err = p.communicate()
            errs.append(err)
        assert all(p.returncode == 0 for p in procs), \
            "\n".join(e[-3000:] for e in errs if e)
        return torch.load(out)


@pytest.mark.parametrize("mesh", MESHES, ids=["2x2", "1x4"])
@pytest.mark.parametrize("arch", ARCHS)
def test_dtensor_model_equals_plain(sharded, mesh, arch):
    want = run(arch)
    got = sharded[(mesh, arch)]
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, (k, g.shape, w.shape)
        scale = max(float(w.abs().max()), 1e-6)
        err = float((g - w).abs().max())
        assert err <= 1e-4 * scale, (arch, mesh, k, err, scale)


@pytest.mark.parametrize("mesh", MESHES, ids=["2x2", "1x4"])
def test_dtensor_adafactor_step_equals_plain(sharded, mesh):
    """Every leaf of the state after one Adafactor step, at 1e-3 of its
    largest magnitude: a vector leaf's update is each gradient entry over
    its own size, so the gradients' 1e-4 (sums in another order) grows
    in small entries; the worst leaf, a zero-initialised norm scale,
    lies about 1e-4 of its magnitude off."""
    want = adafactor_step(ADAFACTOR_ARCH)
    got = sharded[(mesh, "adafactor")]
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, (k, g.shape, w.shape)
        scale = max(float(w.abs().max()), 1e-6)
        err = float((g.float() - w.float()).abs().max())
        assert err <= 1e-3 * scale, (mesh, k, err, scale)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), sys.argv[2], sys.argv[3])
