"""Tensor-parallel serving in the port against the JAX package's tp 1.

One module-scoped fixture spawns four processes once.  They form a gloo
process group on the CPU through a ``file://`` store in a temporary
directory (no TCP port to race for), one thread each, under one
deadline, and destroy it on the way out.  Each runs the scenarios
below on the model of ``tests/test_sharded_engine.py`` (reduced
qwen3-1.7b widened to 8 heads over 4 KV heads, hd 64, float32) with the
JAX package's ``PRNGKey(0)`` weights; the driver, rank 0, runs the
engines, and every rank writes what it saw to the directory:

* tp 2 on ranks {0, 1} and tp 4 on all four: the fused drain of the
  reference test's mix (prefix cache, 8-token chunks, 9 blocks, so the
  engine preempts) against the JAX package's unsharded drain, and its
  events and counters against the port's unsharded drain; every
  shard's pool address over the drain;
* the legacy per-chunk engine at tp 2;
* ``clone()`` at tp 2, on the driver and on the follower;
* ``ServingCluster.on_mesh_slices`` with two tp 2 instances (their
  steps block the host, so the pipelined cluster dispatches them from
  its workers), and ``from_config(model_parallel=2)`` with one live
  migration between them;
* the bf16 model at tp 2 against the port's bf16 tp 1, under a margin
  rule (the sharded sums round in another order).

The reference's errors are checked without a process group.
"""
import dataclasses
import os
import subprocess
import sys
import tempfile
import time
from datetime import timedelta

import numpy as np
import pytest
import torch
import torch.distributed as dist

WORLD = 4
DEADLINE_S = 300          # for the four processes together
COLLECTIVE_TIMEOUT_S = 120
RUNNER = dict(num_blocks=9, block_size=8, max_batch=4)
BF16_BLOCKS = 64          # no preemption: every emitted token has a margin
# the top-2 logit margin, as a share of the row's largest |logit|, under
# which a bf16 divergence counts as a near tie (the families' bf16
# tolerance, tests/test_torch_families.py)
BF16_LOGITS_TOL = 2e-2
COUNTERS = ("n_finished", "n_admitted", "n_preempted", "prefill_tokens",
            "prefill_tokens_saved", "n_dispatches", "pool_bytes",
            "prefix_cache_hit_rate")
# what setting up a process group could leave in this process's
# environment
_PG_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK",
           "OMP_NUM_THREADS", "TORCHELASTIC_RUN_ID")
_ENV_AT_IMPORT = {k: os.environ.get(k) for k in _PG_ENV}


def _cfg(dtype: str):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("qwen3-1.7b").reduced(),
                               num_heads=8, num_kv_heads=4, head_dim=64,
                               dtype=dtype)


def _reqs(mod, n=6, max_new=5):
    """The mix of tests/test_sharded_engine.py."""
    rng = np.random.default_rng(7)
    prefix = rng.integers(0, 500, 16).astype(np.int32)
    out = []
    for i in range(n):
        toks = np.concatenate(
            [prefix, rng.integers(0, 500, 5 + i).astype(np.int32)])
        out.append(mod.Request(agent_name=f"a{i % 2}", msg_id=f"m{i}",
                               prompt_len=len(toks), prompt_tokens=toks,
                               max_new_tokens=max_new, arrival_time=float(i)))
    return out


def _streams(done):
    return sorted((r.msg_id, tuple(int(t) for t in r.output_tokens))
                  for r in done)


def _drain(mod, runner, tracer=None, fused=True):
    """One engine, prefix cache + 8-token chunks; one request submitted a
    step.  Returns (streams, engine, the pool address after each step)."""
    eng = mod.LLMEngine(runner, max_batch=4, enable_prefix_cache=True,
                        prefill_chunk_tokens=8, fused_iteration=fused,
                        **({} if tracer is None else {"tracer": tracer}))
    mod.reset_request_ids()
    pending, done = _reqs(mod), []
    addrs = [runner.pool_address()]
    for _ in range(4000):
        if pending:
            eng.submit(pending.pop(0))
        done.extend(eng.step())
        addrs.append(runner.pool_address())
        if not pending and not eng.running and not eng.waiting:
            break
    assert len(done) == 6
    return _streams(done), eng, addrs


def _record(eng, tracer) -> dict:
    snap = eng.metrics_snapshot()
    return {"events": [(e.kind, e.req_id, e.instance_id)
                       for e in tracer.events()],
            "counters": {k: snap[k] for k in COUNTERS},
            "n_preempted": eng.stats.n_preempted}


def _orchestrator(kv_tokens: int):
    from repro_torch.core.orchestrator import HardwareProfile, Orchestrator
    return Orchestrator(hardware=HardwareProfile(
        decode_tok_per_s=20.0, kv_capacity_tokens=kv_tokens))


def _cluster_drain(cluster, reqs, on_step=None):
    pending, done = list(reqs), []
    for _ in range(4000):
        if pending:
            cluster.submit(pending.pop(0))
        done.extend(cluster.step())
        if on_step is not None:
            on_step(cluster)
        if not pending and not cluster.has_work:
            break
    return done


# =============================================================================
# the four processes
# =============================================================================


def _sharded(model, params, mesh, *, fused=True, traced=False, clone=False,
             num_blocks=RUNNER["num_blocks"]):
    """One runner on ``mesh``: the driver drains, a follower serves."""
    from repro_torch import serving
    from repro_torch.obs.trace import Tracer
    if not mesh.is_member:
        return None
    runner = serving.PagedModelRunner(
        model, params, device="cpu", mesh=mesh,
        **dict(RUNNER, num_blocks=num_blocks))
    if not mesh.is_driver:
        served = serving.serve_follower(runner)
        if not clone:
            return None
        return {"shares_params": served[1].params is served[0].params,
                "own_pools": served[1]._pool_buf.data_ptr()
                != served[0]._pool_buf.data_ptr()}
    tracer = Tracer() if traced else None
    streams, eng, addrs = _drain(serving, runner, tracer, fused)
    out = {"streams": streams, "addresses": addrs,
           **(_record(eng, tracer) if traced else {})}
    if clone:
        c = runner.clone()
        out["clone"] = {"shares_params": c.params is runner.params,
                        "runner_address": runner.pool_address(),
                        "clone_address": c.pool_address(),
                        "streams": _drain(serving, c)[0]}
    runner.shutdown()
    return out


def _on_mesh_slices(model, params):
    from repro_torch import serving
    cluster = serving.ServingCluster.on_mesh_slices(
        model, params, _orchestrator(16 * 8), n_instances=2,
        model_parallel=2, device="cpu",
        runner_kwargs=dict(num_blocks=16, block_size=8, max_batch=4),
        engine_kwargs=dict(max_batch=4, enable_prefix_cache=True,
                           prefill_chunk_tokens=8))
    if cluster is None:
        return None
    try:
        serving.reset_request_ids()
        done = _cluster_drain(cluster, _reqs(serving))
        return {"slices": [e.runner.mesh.ranks for e in cluster.engines],
                "streams": _streams(done),
                "instances": sorted({r.instance_id for r in done}),
                "metrics": sorted(cluster.metrics_snapshot()),
                "blocks_host": [e.runner.blocks_host
                                for e in cluster.engines],
                "dispatches": (cluster.n_inline_dispatches,
                               cluster.n_pooled_dispatches)}
    finally:
        cluster.close()


def _from_config_with_migration(model, params):
    """``from_config(model_parallel=2)``; once a request decodes on
    instance 0, it live-migrates to instance 1."""
    from repro_torch import serving
    config = serving.ServingConfig(
        num_blocks=16, block_size=8, max_batch=4, n_instances=2,
        model_parallel=2, prefix_caching=True, prefill_chunk_tokens=8)
    cluster = serving.ServingCluster.from_config(
        model, params, _orchestrator(config.kv_capacity_tokens), config,
        device="cpu")
    if cluster is None:
        return None
    moved = {}

    def migrate_one(c):
        src, dst = c.engines
        if moved:
            return
        for r in src.running:
            if 1 <= r.output_len < r.max_new_tokens - 1 \
                    and dst.sched.can_adopt(r):
                addrs = (src.runner.pool_address(),
                         dst.runner.pool_address())
                snap = serving.migrate(src, dst, r)
                moved.update(msg_id=r.msg_id, at_output_len=r.output_len,
                             bytes=snap.n_bytes, addresses=addrs,
                             addresses_after=(src.runner.pool_address(),
                                              dst.runner.pool_address()))
                return

    try:
        serving.reset_request_ids()
        done = _cluster_drain(cluster, _reqs(serving), migrate_one)
        return {"slices": [e.runner.mesh.ranks for e in cluster.engines],
                "tp": [e.runner.tp for e in cluster.engines],
                "elastic": cluster._engine_factory is not None,
                "config": cluster.config is config,
                "streams": _streams(done), "moved": moved,
                "finished_on": {r.msg_id: r.instance_id for r in done}}
    finally:
        cluster.close()


def _worker(rank: int, tmp: str) -> None:
    torch.set_num_threads(1)
    from repro_torch.models import LanguageModel
    from repro_torch.serving import make_serving_slices
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(tmp, 'store')}",
        rank=rank, world_size=WORLD,
        timeout=timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    try:
        m32, m16 = LanguageModel(_cfg("float32")), LanguageModel(
            _cfg("bfloat16"))
        p32 = torch.load(os.path.join(tmp, "float32.pt"))
        p16 = torch.load(os.path.join(tmp, "bfloat16.pt"))
        out = {}
        (tp2,) = make_serving_slices(1, 2, ranks=[0, 1])
        out["tp2"] = _sharded(m32, p32, tp2, traced=True, clone=True)
        out["legacy"] = _sharded(m32, p32, tp2, fused=False, traced=True)
        out["bf16"] = _sharded(m16, p16, tp2, num_blocks=BF16_BLOCKS)
        (tp4,) = make_serving_slices(1, 4)
        out["tp4"] = _sharded(m32, p32, tp4, traced=True)
        out["cluster"] = _on_mesh_slices(m32, p32)
        out["from_config"] = _from_config_with_migration(m32, p32)
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


# =============================================================================
# the test process: the references, then the four processes' results
# =============================================================================


def _margin_log(runner):
    """Hook ``runner``'s fused steps: per iteration, each real segment's
    (msg, emits a token) and its row's top-2 logit margin and largest
    |logit|.  Returns (log, undo)."""
    from repro_torch.serving import engine as engine_mod
    log, last = [], {}
    orig_logits, orig_run = engine_mod.lm_logits, runner.run_iteration

    def logits_hook(params, x, cfg):
        logits = orig_logits(params, x, cfg)
        top = logits.float().topk(2, dim=-1).values
        last["rows"] = list(zip((top[:, 0] - top[:, 1]).tolist(),
                                logits.float().abs().amax(-1).tolist()))
        return logits

    def run_hook(batch):
        nxt = orig_run(batch)
        log.append(([(s.req.msg_id, s.kind == "decode" or s.emits_token)
                     for s in batch.segments], last["rows"]))
        return nxt

    def undo():
        engine_mod.lm_logits = orig_logits
        runner.run_iteration = orig_run

    engine_mod.lm_logits = logits_hook
    runner.run_iteration = run_hook
    return log, undo


def _references(tmp: str) -> dict:
    """The JAX package's unsharded drain, the port's unsharded drains
    (traced fused, traced legacy, bf16 with margins); the weights go to
    ``tmp`` for the four processes first."""
    import jax
    from repro import serving as jserving
    from repro.configs import get_config as jax_get_config
    from repro.models import build_model as jax_build_model
    from repro_torch import serving as tserving
    from repro_torch.models import LanguageModel, params_from_jax
    from repro_torch.obs.trace import Tracer
    jmodels = {}
    for dtype in ("float32", "bfloat16"):
        jcfg = dataclasses.replace(jax_get_config("qwen3-1.7b").reduced(),
                                   num_heads=8, num_kv_heads=4, head_dim=64,
                                   dtype=dtype)
        jm = jax_build_model(jcfg)
        jp = jm.init_params(jax.random.PRNGKey(0))
        jmodels[dtype] = (jm, jp)
        torch.save(params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                   device="cpu"),
                   os.path.join(tmp, f"{dtype}.pt"))
    yield                                  # the processes start here
    out = {}
    jm, jp = jmodels["float32"]
    out["jax"] = _drain(jserving, jserving.PagedModelRunner(
        jm, jp, **RUNNER))[0]
    m32 = LanguageModel(_cfg("float32"))
    p32 = torch.load(os.path.join(tmp, "float32.pt"))
    for name, fused in (("tp1", True), ("tp1_legacy", False)):
        tracer = Tracer()
        streams, eng, addrs = _drain(tserving, tserving.PagedModelRunner(
            m32, p32, device="cpu", **RUNNER), tracer, fused)
        out[name] = {"streams": streams, **_record(eng, tracer)}
    m16 = LanguageModel(_cfg("bfloat16"))
    runner = tserving.PagedModelRunner(
        m16, torch.load(os.path.join(tmp, "bfloat16.pt")), device="cpu",
        **dict(RUNNER, num_blocks=BF16_BLOCKS))
    log, undo = _margin_log(runner)
    try:
        streams, eng, _ = _drain(tserving, runner)
    finally:
        undo()
    assert eng.stats.n_preempted == 0
    rows = {}
    for segs, vals in log:
        for (msg, emits), v in zip(segs, vals):
            if emits:
                rows.setdefault(msg, []).append(v)
    out["bf16_tp1"] = {"streams": dict(streams), "rows": rows}
    yield out


@pytest.fixture(scope="module")
def runs():
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(src),
               OMP_NUM_THREADS="1")
    t0 = time.monotonic()
    with tempfile.TemporaryDirectory() as tmp:
        refs = _references(tmp)
        next(refs)
        procs = [subprocess.Popen([sys.executable, __file__, str(r), tmp],
                                  env=env, stderr=subprocess.PIPE,
                                  text=True)
                 for r in range(WORLD)]
        errs = []
        try:
            out = next(refs)
        finally:
            for p in procs:
                try:
                    _, err = p.communicate(timeout=max(
                        1.0, t0 + DEADLINE_S - time.monotonic()))
                except subprocess.TimeoutExpired:
                    p.kill()
                    _, err = p.communicate()
                errs.append(err)
        assert all(p.returncode == 0 for p in procs), \
            "\n".join(f"rank {r}: {e[-3000:]}" for r, e in enumerate(errs))
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"))
                 for r in range(WORLD)]
    return out, ranks


@pytest.mark.parametrize("tp", ["tp2", "tp4"])
def test_sharded_drain_equals_jax_tp1(runs, tp):
    refs, ranks = runs
    got = ranks[0][tp]
    assert got["streams"] == refs["jax"]
    assert got["n_preempted"] > 0, "the mix must preempt"


@pytest.mark.parametrize("tp", ["tp2", "tp4"])
def test_sharded_events_and_counters_equal_port_tp1(runs, tp):
    refs, ranks = runs
    got, want = ranks[0][tp], refs["tp1"]
    assert got["events"] == want["events"]
    assert got["counters"] == want["counters"]


@pytest.mark.parametrize("tp", ["tp2", "tp4"])
def test_every_shard_pool_address_is_stable(runs, tp):
    addrs = runs[1][0][tp]["addresses"]
    assert isinstance(addrs[0], tuple) and len(addrs[0]) == int(tp[2:])
    assert set(addrs) == {addrs[0]}


def test_legacy_engine_at_tp2(runs):
    refs, ranks = runs
    got = ranks[0]["legacy"]
    assert got["streams"] == refs["jax"]
    assert got["events"] == refs["tp1_legacy"]["events"]
    assert got["counters"] == refs["tp1_legacy"]["counters"]
    assert got["n_preempted"] > 0
    assert set(got["addresses"]) == {got["addresses"][0]}


def test_clone_shares_params_and_owns_a_fresh_pool(runs):
    refs, ranks = runs
    c = ranks[0]["tp2"]["clone"]
    assert c["shares_params"]
    assert len(c["clone_address"]) == len(c["runner_address"]) == 2
    assert all(a != b for a, b in zip(c["clone_address"],
                                      c["runner_address"]))
    assert c["streams"] == refs["jax"]
    assert ranks[1]["tp2"] == {"shares_params": True, "own_pools": True}


def test_on_mesh_slices_disjoint_prefixed_and_equal_to_jax(runs):
    refs, ranks = runs
    got = ranks[0]["cluster"]
    assert got["slices"] == [(0, 1), (2, 3)]
    assert got["instances"] == [0, 1]
    assert any(k.startswith("engine0.") for k in got["metrics"])
    assert any(k.startswith("engine1.") for k in got["metrics"])
    assert got["streams"] == refs["jax"]
    assert all(ranks[r]["cluster"] is None for r in range(1, WORLD))


def test_tensor_parallel_group_dispatches_on_workers(runs):
    """Both tp 2 instances' steps block the host (the driver's
    all-reduces on one, the result from rank 2 on the other), so the
    pipelined cluster dispatches them from its worker pool, never
    inline."""
    got = runs[1][0]["cluster"]
    assert got["blocks_host"] == [True, True]
    inline, pooled = got["dispatches"]
    assert inline == 0 and pooled > 0 and pooled % 2 == 0


def test_from_config_model_parallel_builds_the_mesh_cluster(runs):
    got = runs[1][0]["from_config"]
    assert got["slices"] == [(0, 1), (2, 3)] and got["tp"] == [2, 2]
    assert got["config"] and not got["elastic"]


def test_live_migration_between_tp_instances_keeps_the_stream(runs):
    refs, ranks = runs
    got = ranks[0]["from_config"]
    moved = got["moved"]
    assert moved, "no request was migrated"
    assert got["finished_on"][moved["msg_id"]] == 1
    assert moved["bytes"] > 0
    assert moved["addresses_after"] == moved["addresses"]
    assert all(len(a) == 2 for a in moved["addresses"])
    assert got["streams"] == refs["jax"]


def test_bf16_tp2_against_tp1_under_the_margin_rule(runs, record_property):
    """The sharded products sum their fp32 partials in another order, so
    a bf16 stream may leave tp 1's where tp 1's top-2 logit margin is
    within the bf16 logits tolerance; nowhere else."""
    refs, ranks = runs
    want, rows = refs["bf16_tp1"]["streams"], refs["bf16_tp1"]["rows"]
    got = dict(ranks[0]["bf16"]["streams"])
    assert set(got) == set(want)
    diverged = 0
    for msg in sorted(want):
        g, w = got[msg], want[msg]
        assert len(g) == len(w) <= len(rows[msg])
        for i in range(len(w)):
            if g[i] != w[i]:
                margin, scale = rows[msg][i]
                assert margin <= BF16_LOGITS_TOL * scale, \
                    (msg, i, g[i], w[i], margin, scale)
                diverged += 1
                break
    record_property("bf16_streams_diverged", diverged)
    record_property("bf16_streams", len(want))


# =============================================================================
# the reference's errors, with no process group
# =============================================================================


def _reference_message(case: str):
    import jax
    from repro.configs import get_config as jax_get_config
    from repro.launch.mesh import make_slice_meshes
    from repro.models.sharding import validate_serving_tp
    try:
        if case == "moe":
            validate_serving_tp(jax_get_config("qwen2-moe-a2.7b").reduced(), 2)
        elif case == "heads":
            validate_serving_tp(jax_get_config("qwen3-1.7b").reduced(), 4)
        else:
            make_slice_meshes(2, 2, devices=jax.devices()[:1])
    except ValueError as e:
        return str(e)
    return None


def _port_message(case: str):
    from repro_torch.configs import get_config
    from repro_torch.models import LanguageModel, build_model
    from repro_torch.serving import ServingCluster
    arch, mp, n, ranks = {"moe": ("qwen2-moe-a2.7b", 2, 1, [0, 1]),
                          "heads": ("qwen3-1.7b", 4, 1, [0, 1, 2, 3]),
                          "ranks": ("qwen3-1.7b", 2, 2, [0])}[case]
    cfg = get_config(arch).reduced()
    model = build_model(cfg) if cfg.moe else LanguageModel(cfg)
    try:
        ServingCluster.on_mesh_slices(model, None, None, n_instances=n,
                                      model_parallel=mp, ranks=ranks)
    except ValueError as e:
        return str(e)
    return None


@pytest.mark.parametrize("case", ["moe", "heads", "ranks"])
def test_errors_match_the_reference(case):
    want = _reference_message(case)
    assert want is not None and _port_message(case) == want
    assert not dist.is_initialized()


def test_hygiene_after_this_file():
    from torch.utils._python_dispatch import _get_current_dispatch_mode
    assert not dist.is_initialized()
    assert _get_current_dispatch_mode() is None
    assert {k: os.environ.get(k) for k in _PG_ENV} == _ENV_AT_IMPORT


if __name__ == "__main__":
    _worker(int(sys.argv[1]), sys.argv[2])
