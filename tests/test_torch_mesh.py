"""The port's meshes (``repro_torch.launch.mesh``) over fake process
groups, against the reference's ``repro.launch.mesh``.

The production meshes have the reference's shapes and axis names; the
serving slices are disjoint, cover the ranks they were given, and keep
their order; every error path raises the reference's message, before a
mesh is built (the reference's functions are called with stand-in device
lists, which they validate before touching a device).
"""
import os

import pytest
import torch.distributed as dist

from repro.launch import mesh as jmesh
from repro_torch.launch import mesh as tmesh


@pytest.fixture
def fake_group(request):
    """A fake process group of ``request.param`` ranks (8 by default),
    this process rank 0; torn down after the test."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    world = getattr(request, "param", 8)
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield world
    finally:
        dist.destroy_process_group()
    assert not dist.is_initialized()


def _ranks(mesh):
    return mesh.device_mesh.mesh.flatten().tolist()


@pytest.mark.parametrize("fake_group,multi_pod", [(256, False), (512, True)],
                         indirect=["fake_group"])
def test_production_mesh_shape_and_axes(fake_group, multi_pod):
    m = tmesh.make_production_mesh(multi_pod=multi_pod)
    if multi_pod:
        assert m.axis_names == ("pod", "data", "model")
        assert m.shape == {"pod": 2, "data": 16, "model": 16}
    else:
        assert m.axis_names == ("data", "model")
        assert m.shape == {"data": 16, "model": 16}
    assert m.size == fake_group
    assert sorted(_ranks(m)) == list(range(fake_group))


@pytest.mark.parametrize("mp", [1, 2, 4, 8])
def test_local_mesh_over_every_rank(fake_group, mp):
    m = tmesh.make_local_mesh(mp)
    assert m.axis_names == ("data", "model")
    assert m.shape == {"data": 8 // mp, "model": mp}
    assert _ranks(m) == list(range(8))


@pytest.mark.parametrize("n_slices,mp", [(8, 1), (4, 2), (2, 4), (1, 8),
                                         (2, 2), (3, 2)])
def test_slices_are_disjoint_and_cover_their_ranks(fake_group, n_slices, mp):
    meshes = tmesh.make_slice_meshes(n_slices, mp)
    assert len(meshes) == n_slices
    got = [_ranks(m) for m in meshes]
    for i, ranks in enumerate(got):
        assert ranks == list(range(i * mp, (i + 1) * mp))
        assert meshes[i].shape == {"data": 1, "model": mp}
    flat = [r for ranks in got for r in ranks]
    assert len(set(flat)) == len(flat) == n_slices * mp


def test_slices_over_an_explicit_rank_list(fake_group):
    meshes = tmesh.make_slice_meshes(2, 2, ranks=[7, 5, 3, 1])
    assert [_ranks(m) for m in meshes] == [[7, 5], [3, 1]]


ERROR_CASES = [
    ("local", (0,), 8), ("local", (-1,), 8), ("local", (3,), 8),
    ("local", (16,), 8), ("local", (1,), 0),
    ("slices", (0, 1), 8), ("slices", (3, 4), 8), ("slices", (9, 1), 8),
    ("slices", (1, 0), 8), ("slices", (2, -1), 8),
]


def _message(fn, *args):
    try:
        fn(*args)
    except ValueError as e:
        return str(e)
    return None


@pytest.mark.parametrize("case", range(len(ERROR_CASES)))
def test_errors_match_the_reference(fake_group, case):
    kind, args, n = ERROR_CASES[case]
    stand_in = list(range(n))
    if kind == "local":
        want = _message(jmesh.make_local_mesh, *args, stand_in)
        got = _message(tmesh.make_local_mesh, *args, stand_in)
    else:
        want = _message(jmesh.make_slice_meshes, *args, stand_in)
        got = _message(tmesh.make_slice_meshes, *args, stand_in)
    assert want is not None and got == want


def test_no_process_group_is_an_error():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.make_local_mesh(1)


def test_hygiene_after_this_file():
    from torch.utils._python_dispatch import _get_current_dispatch_mode
    assert not dist.is_initialized()
    assert _get_current_dispatch_mode() is None
    assert "xla_force_host_platform_device_count" not in \
        os.environ.get("XLA_FLAGS", "")
