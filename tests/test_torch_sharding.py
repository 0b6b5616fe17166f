"""The port's sharding rules against the JAX package's, leaf for leaf.

Every arch's params (reduced, and at published widths with their train
state) are built on both sides without allocation: ``jax.eval_shape``
for the reference, ``FakeTensorMode`` for the port.  Each leaf's
PartitionSpec from ``repro_torch.models.sharding`` must equal the
reference's from ``repro.models.sharding`` on the same duck-typed mesh
(the rules read only ``mesh.shape`` and ``mesh.axis_names``): model-
parallel 1/2/4 on reduced shapes, the 16x16 and 2x16x16 production meshes
at published widths, FSDP on and off.  The same for ``batch_pspec`` and
``cache_pspecs`` (every arch x shape x mesh), ``serving_param_specs``,
``validate_serving_tp`` (message for message), ``should_fsdp`` and the
dry-run's input shapes.  ``to_placements`` is checked on DTensors over an
8-rank fake process group.
"""
import dataclasses
import functools
import os
from types import SimpleNamespace

import jax
import pytest
import torch
import torch.distributed as dist

from repro.configs import (INPUT_SHAPES as J_SHAPES, get_config as jget,
                           shape_applicable as j_applicable)
from repro.models import build_model as jbuild
from repro.models import sharding as jsh
from repro.training.optimizer import make_train_step as j_train_step
from repro_torch.configs import (ARCH_IDS, INPUT_SHAPES, ShapeConfig,
                                 get_config, shape_applicable)
from repro_torch.models import build_model
from repro_torch.models import sharding as tsh
from repro_torch.training.optimizer import make_train_step

MESHES = {
    "16x16": SimpleNamespace(shape={"data": 16, "model": 16},
                             axis_names=("data", "model")),
    "2x16x16": SimpleNamespace(shape={"pod": 2, "data": 16, "model": 16},
                               axis_names=("pod", "data", "model")),
}


def _mp_mesh(mp: int):
    return SimpleNamespace(shape={"data": 1, "model": mp},
                           axis_names=("data", "model"))


def _cfgs(arch: str, reduced: bool):
    j, t = jget(arch), get_config(arch)
    return (j.reduced(), t.reduced()) if reduced else (j, t)


def _opt_kind(cfg) -> str:
    """The dry-run's choice: Adafactor above 1e11 parameters."""
    return "adafactor" if cfg.param_count() > 100e9 else "adam"


def _flat_jax(tree) -> dict:
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = tuple(str(getattr(k, "key", getattr(k, "idx", None)))
                     for k in path)
        out[keys] = leaf
    return out


def _flat_port(tree, path=()) -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_port(v, path + (str(k),)))
        return out
    return {path: tree}


@functools.lru_cache(maxsize=None)
def _jax_tree(arch: str, reduced: bool, what: str) -> dict:
    cfg, _ = _cfgs(arch, reduced)
    model = jbuild(cfg)
    key = jax.random.PRNGKey(0)
    if what == "params":
        return _flat_jax(jax.eval_shape(model.init_params, key))
    init, _ = j_train_step(model, _opt_kind(cfg))
    return _flat_jax(jax.eval_shape(init, key))


@functools.lru_cache(maxsize=None)
def _port_tree(arch: str, reduced: bool, what: str):
    """(the nested tree, flattened) of fake tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    _, cfg = _cfgs(arch, reduced)
    model = build_model(cfg)
    with FakeTensorMode():
        gen = torch.Generator()
        if what == "params":
            tree = model.init_params(gen, "cpu")
        else:
            tree = make_train_step(model, _opt_kind(cfg))[0](gen, "cpu")
    return tree, _flat_port(tree)


def _same_leaves(jtree: dict, ttree: dict):
    assert set(jtree) == set(ttree), set(jtree) ^ set(ttree)
    for path, leaf in jtree.items():
        assert tuple(leaf.shape) == tuple(ttree[path].shape), path


def _check_param_specs(arch, reduced, what, mesh, fsdp):
    jcfg, tcfg = _cfgs(arch, reduced)
    jtree = _jax_tree(arch, reduced, what)
    tree, flat = _port_tree(arch, reduced, what)
    _same_leaves(jtree, flat)
    got = _flat_port(tsh.param_shardings(tree, tcfg, mesh, fsdp=fsdp))
    for path, leaf in jtree.items():
        want = jsh.param_pspec(path, leaf, jcfg, mesh, fsdp)
        assert got[path].spec == want, (arch, path, got[path].spec, want)
        assert tsh.param_pspec(path, flat[path], tcfg, mesh, fsdp) == want


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("mp", [1, 2, 4])
def test_param_specs_reduced(arch, mp):
    _check_param_specs(arch, True, "params", _mp_mesh(mp), False)


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("fsdp", [False, True])
def test_param_and_train_state_specs_published(arch, mesh, fsdp):
    for what in ("params", "state"):
        _check_param_specs(arch, False, what, MESHES[mesh], fsdp)


def _caches(arch: str, shape: ShapeConfig):
    """(reference cache shapes, the port's fake cache) of the dry-run's
    decode cache at ``shape``'s batch and length."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    jcfg, tcfg = _cfgs(arch, False)
    b, s = shape.global_batch, shape.seq_len
    enc = min(4096, s // 2)
    jm, tm = jbuild(jcfg), build_model(tcfg)
    args = (b, s, enc) if jcfg.is_encdec else (b, s)
    jcache = jax.eval_shape(lambda: jm.init_cache(*args))
    with FakeTensorMode():
        tcache = tm.init_cache(*args, device="cpu")
    return jcache, tcache


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("shape", sorted(INPUT_SHAPES))
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_batch_and_cache_specs(arch, shape, mesh):
    m = MESHES[mesh]
    jcfg, tcfg = _cfgs(arch, False)
    assert tsh.batch_pspec(INPUT_SHAPES[shape], m) == \
        jsh.batch_pspec(J_SHAPES[shape], m)
    jcache, tcache = _caches(arch, INPUT_SHAPES[shape])
    want = jsh.cache_pspecs(jcfg, J_SHAPES[shape], m, jcache)
    got = tsh.cache_pspecs(tcfg, INPUT_SHAPES[shape], m, tcache)
    assert set(got) == set(want)
    for k in want:
        assert got[k] == want[k], (k, got[k], want[k])
        if k != "pos":     # the port's cache holds pos as a Python int
            assert tuple(tcache[k].shape) == tuple(jcache[k].shape), k


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("mp", [2, 4])
def test_serving_param_specs(arch, mp):
    jcfg, tcfg = _cfgs(arch, True)
    jtree = _jax_tree(arch, True, "params")
    tree, _ = _port_tree(arch, True, "params")
    mesh = _mp_mesh(mp)
    got = _flat_port(tsh.serving_param_specs(tree, tcfg, mesh))
    for path, leaf in jtree.items():
        want = jsh.param_pspec(path, leaf, jcfg, mesh) \
            if "layers" in path else jax.sharding.PartitionSpec()
        assert got[path] == want, (path, got[path], want)


def _raised(fn, *args):
    try:
        fn(*args)
    except Exception as e:          # noqa: BLE001 - compared below
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("reduced", [True, False])
def test_validate_serving_tp_message_for_message(arch, reduced):
    jcfg, tcfg = _cfgs(arch, reduced)
    for tp in (1, 2, 3, 4, 8, 16):
        assert _raised(tsh.validate_serving_tp, tcfg, tp) == \
            _raised(jsh.validate_serving_tp, jcfg, tp), (arch, tp)
    wide = dataclasses.replace(tcfg, num_heads=8, num_kv_heads=4, d_ff=510)
    jwide = dataclasses.replace(jcfg, num_heads=8, num_kv_heads=4, d_ff=510)
    assert _raised(tsh.validate_serving_tp, wide, 4) == \
        _raised(jsh.validate_serving_tp, jwide, 4)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_should_fsdp_and_shape_applicable(arch):
    jcfg, tcfg = _cfgs(arch, False)
    for kind in ("train", "prefill", "decode"):
        assert tsh.should_fsdp(tcfg, kind) == jsh.should_fsdp(jcfg, kind)
    for name in INPUT_SHAPES:
        assert shape_applicable(tcfg, INPUT_SHAPES[name]) == \
            j_applicable(jcfg, J_SHAPES[name]), name


def test_input_shapes_are_the_reference_s():
    assert list(INPUT_SHAPES) == list(J_SHAPES)
    for name, shape in INPUT_SHAPES.items():
        assert isinstance(shape, ShapeConfig)
        assert dataclasses.asdict(shape) == dataclasses.asdict(J_SHAPES[name])
    assert tsh.POOL_PSPEC == jsh.POOL_PSPEC


@pytest.mark.parametrize("spec", [("data", None), (("pod", "data"), None),
                                  (("data",), None), ((), "model"), ()])
def test_partition_spec_canonical_as_jax(spec):
    assert tsh.P(*spec) == jax.sharding.PartitionSpec(*spec)


@pytest.fixture
def fake_group():
    """An 8-rank fake process group, this process rank 0."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        yield
    finally:
        dist.destroy_process_group()
    assert not dist.is_initialized()


PLACEMENT_CASES = [
    # mesh shape, spec, global shape, expected (kind, dim) per mesh dim
    ((2, 4), ("data", "model"), (8, 12), [("S", 0), ("S", 1)]),
    ((2, 4), (None, "model"), (8, 12), [("R", None), ("S", 1)]),
    ((2, 4), ("model", None, "data"), (4, 3, 6), [("S", 2), ("S", 0)]),
    ((2, 4), (), (8, 12), [("R", None), ("R", None)]),
    ((2, 2, 2), (("pod", "data"), None), (8, 5), [("S", 0), ("S", 0),
                                                   ("R", None)]),
    ((2, 2, 2), (None, None, ("pod", "data", "model")), (1, 3, 16),
     [("S", 2), ("S", 2), ("S", 2)]),
]


@pytest.mark.parametrize("case", range(len(PLACEMENT_CASES)))
def test_to_placements_on_a_fake_8_rank_mesh(fake_group, case):
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.sharding import NamedMesh
    from torch.distributed.device_mesh import init_device_mesh
    mesh_shape, spec, shape, want = PLACEMENT_CASES[case]
    names = ("pod", "data", "model")[-len(mesh_shape):]
    mesh = NamedMesh(init_device_mesh("cpu", mesh_shape,
                                      mesh_dim_names=names))
    got = tsh.to_placements(tsh.P(*spec), mesh)
    assert [("S", p.dim) if isinstance(p, Shard) else ("R", None)
            for p in got] == want
    assert all(isinstance(p, (Shard, Replicate)) for p in got)
    # a DTensor of rank 0's shard has the global shape back
    local = list(shape)
    for i, p in enumerate(got):
        if isinstance(p, Shard):
            local[p.dim] //= mesh_shape[i]
    dt = DTensor.from_local(torch.zeros(local), mesh.device_mesh, got,
                            run_check=False)
    assert tuple(dt.shape) == shape
    with pytest.raises(ValueError, match="order"):
        tsh.to_placements(tsh.P(("model", "data")), mesh)
    assert make_local_mesh(2).shape == {"data": 4, "model": 2}


def test_hygiene_after_this_file():
    """Nothing here leaves global state behind for later files in the
    worker: no process group, no dispatch mode, torch's defaults, and no
    forced XLA device count."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode
    assert not dist.is_initialized()
    assert _get_current_dispatch_mode() is None
    assert torch.get_default_dtype() == torch.float32
    assert torch.empty(()).device.type == "cpu"
    assert "xla_force_host_platform_device_count" not in \
        os.environ.get("XLA_FLAGS", "")
