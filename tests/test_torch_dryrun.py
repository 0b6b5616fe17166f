"""The port's dry-run (``repro_torch.launch.dryrun``) against the
reference's, on the CPU over fake process groups.

* ``input_specs`` of every arch x shape equal the reference's, which are
  read from a subprocess: importing ``repro.launch.dryrun`` forces 512 XLA
  host devices for the whole process, so it never runs in this one.
* qwen3-1.7b decode_32k on both production meshes and rwkv6-3b long_500k
  come back ``ok``; qwen3-1.7b long_500k is ``skipped``.
* ``argument_bytes`` equal rank 0's shard sizes computed from the
  reference's own specs on the same meshes.
* Collective bytes are above zero on the sharded meshes and zero on a
  one-rank mesh.
"""
import json
import math
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import INPUT_SHAPES as J_SHAPES, get_config as jget
from repro.models import build_model as jbuild
from repro.models import sharding as jsh
from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, ShapeConfig, get_config
from repro_torch.launch import dryrun

ROOT = Path(__file__).resolve().parent.parent

MESHES = {
    "16x16": SimpleNamespace(shape={"data": 16, "model": 16},
                             axis_names=("data", "model")),
    "2x16x16": SimpleNamespace(shape={"pod": 2, "data": 16, "model": 16},
                               axis_names=("pod", "data", "model")),
}

_REF_SPECS = """
import json
from repro.configs import ARCH_IDS, INPUT_SHAPES
from repro.launch.dryrun import input_specs
print(json.dumps({a: {s: {k: [list(v.shape), str(v.dtype)]
                          for k, v in input_specs(a, s).items()}
                      for s in INPUT_SHAPES} for a in ARCH_IDS}))
"""


def test_input_specs_equal_the_reference_s():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _REF_SPECS], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    ref = json.loads(proc.stdout.strip().splitlines()[-1])
    assert set(ref) == set(ARCH_IDS)
    for arch in ARCH_IDS:
        for shape in INPUT_SHAPES:
            got = {k: [list(v.shape), str(v.dtype).replace("torch.", "")]
                   for k, v in dryrun.input_specs(arch, shape).items()}
            assert got == ref[arch][shape], (arch, shape)
            for v in dryrun.input_specs(arch, shape).values():
                assert v.device.type == "meta"


@pytest.fixture(scope="module")
def records():
    out = {}
    for arch, shape, mp in (("qwen3-1.7b", "decode_32k", False),
                            ("qwen3-1.7b", "decode_32k", True),
                            ("rwkv6-3b", "long_500k", False),
                            ("qwen3-1.7b", "long_500k", False)):
        rec = dryrun.dryrun_one(arch, shape, mp)
        out[(arch, shape, "2x16x16" if mp else "16x16")] = rec
    assert not dist.is_initialized()
    return out


def test_records_ok_and_skipped(records):
    for (arch, shape, mesh), rec in records.items():
        assert rec["arch"] == arch and rec["shape"] == shape
        assert rec["mesh"] == mesh
        assert rec["n_devices"] == (512 if mesh == "2x16x16" else 256)
        if shape == "long_500k" and arch == "qwen3-1.7b":
            assert rec["status"].startswith("skipped"), rec["status"]
            continue
        assert rec["status"] == "ok", rec.get("traceback", rec["status"])
        mem = rec["memory"]
        assert mem["peak_bytes_estimated"] is True
        assert mem["peak_bytes"] >= mem["argument_bytes"] > 0
        assert mem["output_bytes"] > 0
        assert rec["cost"]["flops"] > 0
        assert set(rec["collectives"]) == set(dryrun.COLLECTIVE_OPS)
        assert sum(rec["collectives"].values()) > 0, rec["collectives"]
        assert rec["layout_notes"] == []


def _shard_bytes(shape, dtype, spec, mesh) -> int:
    n = math.prod(shape)
    for ax in spec:
        if ax is None:
            continue
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            n //= mesh.shape[a]
    return n * np.dtype(dtype).itemsize


def _reference_argument_bytes(arch: str, shape_name: str, mesh) -> int:
    """Rank 0's bytes of the decode step's params, cache and tokens,
    from the reference's specs.  The reference's cache also holds ``pos``
    (an int32 scalar); the port carries it as a Python int, so it is not
    counted."""
    cfg, shape = jget(arch), J_SHAPES[shape_name]
    model = jbuild(cfg)
    fsdp = jsh.should_fsdp(cfg, shape.kind)
    params = jax.eval_shape(model.init_params, jax.random.PRNGKey(0))
    total = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        keys = tuple(str(getattr(k, "key", getattr(k, "idx", None)))
                     for k in path)
        total += _shard_bytes(leaf.shape, leaf.dtype, jsh.param_pspec(
            keys, leaf, cfg, mesh, fsdp), mesh)
    cache = jax.eval_shape(lambda: model.init_cache(shape.global_batch,
                                                    shape.seq_len))
    specs = jsh.cache_pspecs(cfg, shape, mesh, cache)
    for k, leaf in cache.items():
        if k != "pos":
            total += _shard_bytes(leaf.shape, leaf.dtype, specs[k], mesh)
    return total + _shard_bytes((shape.global_batch, 1), np.int32,
                                jsh.batch_pspec(shape, mesh), mesh)


@pytest.mark.parametrize("key", [("qwen3-1.7b", "decode_32k", "16x16"),
                                 ("qwen3-1.7b", "decode_32k", "2x16x16"),
                                 ("rwkv6-3b", "long_500k", "16x16")])
def test_argument_bytes_are_rank0_shards_of_the_reference_specs(records,
                                                                key):
    arch, shape, mesh = key
    assert records[key]["memory"]["argument_bytes"] == \
        _reference_argument_bytes(arch, shape, MESHES[mesh])


def test_no_collectives_on_one_rank():
    cfg = get_config("qwen3-1.7b").reduced()
    for shape in (ShapeConfig("t", 64, 2, "train"),
                  ShapeConfig("d", 64, 2, "decode")):
        rec = dryrun.dryrun_one("qwen3-1.7b", shape, False, cfg=cfg,
                                mesh_shape=(1, 1))
        assert rec["status"] == "ok", rec.get("traceback")
        assert rec["n_devices"] == 1 and rec["mesh"] == "1x1"
        assert not any(rec["collectives"].values()), rec["collectives"]
        assert rec["memory"]["argument_bytes"] > 0
    assert not dist.is_initialized()


@pytest.mark.parametrize("arch,shape,mesh,kinds", [
    ("rwkv6-3b", "train_4k", "16x16", ["rwkv"]),
    ("rwkv6-3b", "decode_32k", "16x16", []),
    ("qwen2-moe-a2.7b", "prefill_32k", "2x16x16", ["moe"]),
    ("jamba-v0.1-52b", "train_4k", "16x16", ["moe"]),
    ("qwen3-1.7b", "train_4k", "16x16", []),
])
def test_layout_notes_name_the_port_s_own_layouts(arch, shape, mesh, kinds):
    notes = dryrun.layout_notes(get_config(arch), INPUT_SHAPES[shape],
                                MESHES[mesh])
    assert [n.split(":")[0] for n in notes] == kinds


def test_moe_expert_work_is_split_over_the_data_ranks():
    """Each of four data ranks does a quarter of the reduced MoE's train
    step, the experts' products included: the capacity buffer is split
    over the data axis, not repeated whole on every rank."""
    cfg = get_config("qwen2-moe-a2.7b").reduced()
    shape = ShapeConfig("t", 64, 8, "train")
    one, four = (dryrun.dryrun_one(cfg.name, shape, False, cfg=cfg,
                                   mesh_shape=m) for m in ((1, 1), (4, 1)))
    assert one["status"] == four["status"] == "ok", four.get("traceback")
    # the capacity is padded to divide by 4: a few slots more per expert
    assert four["cost"]["flops"] <= 1.05 * one["cost"]["flops"] / 4
    assert four["memory"]["peak_bytes"] < one["memory"]["peak_bytes"]


def test_a_renamed_dtensor_internal_fails_the_combination(monkeypatch):
    """The tally knows two private DTensor functions by name; a torch
    without them fails the record instead of tallying wrong bytes."""
    monkeypatch.setattr(dryrun, "_STACK_NAMES", dryrun._STACK_NAMES + (
        ("torch.distributed.tensor._collective_utils", None,
         "no_such_function"),))
    cfg = get_config("qwen3-1.7b").reduced()
    rec = dryrun.dryrun_one("qwen3-1.7b", ShapeConfig("d", 64, 2, "decode"),
                            False, cfg=cfg, mesh_shape=(1, 1))
    assert rec["status"].startswith("FAILED: RuntimeError"), rec["status"]
    assert "no_such_function" in rec["status"]
    assert not dist.is_initialized()


def test_cli_writes_records_and_exit_code(tmp_path):
    out = tmp_path / "dry.json"
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "qwen3-1.7b", "--shape", "long_500k",
                     "--both-meshes", "--out", str(out)])
    assert e.value.code == 0
    recs = json.loads(out.read_text())
    assert [r["mesh"] for r in recs] == ["16x16", "2x16x16"]
    assert all(r["status"].startswith("skipped") for r in recs)
    assert not dist.is_initialized()


def test_a_failed_combination_is_reported_and_torn_down(monkeypatch):
    def broken(*a, **k):
        raise RuntimeError("no step")
    monkeypatch.setattr(dryrun, "build_step", broken)
    rec = dryrun.dryrun_one("qwen3-1.7b", "decode_32k", False)
    assert rec["status"] == "FAILED: RuntimeError: no step"
    assert not dist.is_initialized()
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "qwen3-1.7b", "--shape", "decode_32k"])
    assert e.value.code == 1


def test_hygiene_after_this_file():
    """No process group, dispatch mode or forced XLA device count is left
    for the next file in this worker."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode
    assert not dist.is_initialized()
    assert _get_current_dispatch_mode() is None
    assert torch.get_default_dtype() == torch.float32
    assert "xla_force_host_platform_device_count" not in \
        os.environ.get("XLA_FLAGS", "")
