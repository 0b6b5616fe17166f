"""The port's agents ``Workflow`` against the JAX package's.

The quickstart's QA application (Router -> MathAgent | HumanitiesAgent,
6 tasks) runs through ``repro.agents.Workflow`` with
``examples/quickstart.py``'s agents and through
``repro_torch.agents.Workflow`` with ``repro_torch.quickstart``'s, in one
process (``BaseAgent.encode_prompt`` hashes text with the process's
``hash``), on the reduced qwen3-1.7b in fp32 with the JAX weights carried
across.  Each cluster is built by ``ServingCluster.from_config`` as
``add_engine`` would build it.  The results must be identical, message
for message.  Also carried over: the two-stage identifier test, the
``_llm_call`` timeout, failure surfacing, the cluster wiring, and the
device rule (no CUDA, no ``device``: raise).
"""
import dataclasses
import importlib.util
import pathlib

import jax
import numpy as np
import pytest
import torch

import repro_torch.quickstart as port_quickstart
from repro import agents as jagents
from repro import serving as jserving
from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro_torch import agents as tagents
from repro_torch import serving as tserving
from repro_torch.configs import get_config
from repro_torch.models import LanguageModel, params_from_jax
from repro_torch.obs import Tracer

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _jax_quickstart():
    spec = importlib.util.spec_from_file_location(
        "jax_quickstart", ROOT / "examples" / "quickstart.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jax_get_config("qwen3-1.7b").reduced(),
                               dtype="float32")
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    cfg = dataclasses.replace(get_config("qwen3-1.7b").reduced(),
                              dtype="float32")
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                             device="cpu")
    return jmodel, jparams, LanguageModel(cfg), params


def _run_qa(agents_mod, serving_mod, qs, model, params, n_instances,
            **wf_kw):
    """The quickstart's QA app on ``model``: the cluster built as
    ``add_engine`` builds it.  Returns (results in task order, workflow,
    msg ids)."""
    config = serving_mod.ServingConfig(
        n_instances=n_instances, num_blocks=128, block_size=8, max_batch=4,
        prefix_caching=True)
    wf = agents_mod.Workflow(app_name="QA", config=config, **wf_kw)
    build_kw = {"device": "cpu"} if "device" in wf_kw else {}
    wf.cluster = serving_mod.ServingCluster.from_config(
        model, params, wf.orch, wf.config, pipelined=wf.pipelined,
        tracer=wf.tracer, **build_kw)
    wf.vocab_size = model.cfg.vocab_size
    for name in ("Router", "MathAgent", "HumanitiesAgent"):
        wf.add_agent(name, getattr(qs, name))
    ids = [wf.submit_task("Router", {"question": q}) for q in
           (f"question number {i}: what is {i}*{i+1}?" for i in range(6))]
    results = wf.run(timeout=180)
    wf.cluster.close()
    return [results[m] for m in ids], wf, ids


@pytest.mark.parametrize("n_instances", [1, 2])
def test_port_qa_workflow_equals_jax_workflow(models, n_instances):
    jmodel, jparams, model, params = models
    jax_res, _, _ = _run_qa(jagents, jserving, _jax_quickstart(), jmodel,
                            jparams, n_instances)
    port_res, wf, ids = _run_qa(tagents, tserving, port_quickstart, model,
                                params, n_instances, device="cpu",
                                tracer=Tracer())
    assert len(port_res) == 6
    assert [(r["by"], [int(t) for t in r["answer"]]) for r in port_res] == \
        [(r["by"], [int(t) for t in r["answer"]]) for r in jax_res]
    assert {r["by"] for r in port_res} <= {"MathAgent", "HumanitiesAgent"}
    # the control plane learned every agent and ranks them
    assert set(wf.orch.profiler.agents()) == {"Router", "MathAgent",
                                              "HumanitiesAgent"}
    wf.orch.refresh_priorities()
    assert {k[1] for k in wf.orch.priorities.scores} == {
        "Router", "MathAgent", "HumanitiesAgent"}
    assert wf.prefix_cache_stats()["prefill_tokens_saved"] > 0
    # every workflow's critical path: Router, then its expert
    for mid, r in zip(ids, port_res):
        cp = wf.critical_path(mid)
        assert [s.name for s in cp.stages] == ["Router", r["by"]]
        assert cp.total > 0


class Stage1(tagents.BaseAgent):
    def _run_impl(self, input_data, metadata):
        toks = self.generate(self.encode_prompt("stage one", 10), metadata,
                             max_new_tokens=3)
        return {"x": len(toks)}, "Stage2"


class Stage2(tagents.BaseAgent):
    def _run_impl(self, input_data, metadata):
        toks = self.generate(self.encode_prompt("stage two", 14), metadata,
                             max_new_tokens=4)
        return {"done": True, "x": input_data["x"], "y": len(toks)}, None


def test_two_stage_workflow_end_to_end():
    """``add_engine`` serves the reduced model (bf16, the port's seeded
    initialiser); identifiers propagate and the workflow is
    reconstructed."""
    wf = tagents.Workflow(app_name="test", config=tserving.ServingConfig(
        n_instances=1, num_blocks=64, block_size=8, max_batch=4),
        device="cpu")
    wf.add_engine("e0", model="qwen3-1.7b")
    assert wf.vocab_size == get_config("qwen3-1.7b").reduced().vocab_size
    wf.add_agent("Stage1", Stage1)
    wf.add_agent("Stage2", Stage2)
    ids = [wf.submit_task("Stage1", {"q": i}) for i in range(3)]
    results = wf.run(timeout=120)
    assert len(results) == 3
    for mid in ids:
        assert results[mid] == {"done": True, "x": 3, "y": 4}
    g = wf.orch.analyzer.graphs["test"]
    assert ("Stage1", "Stage2") in g.edges
    assert g.remaining_stages("Stage1") == 2
    assert set(wf.orch.profiler.agents()) == {"Stage1", "Stage2"}


def test_workflow_wires_cluster_probe_and_feedback():
    wf = tagents.Workflow(app_name="t", config=tserving.ServingConfig(
        n_instances=2, num_blocks=32, block_size=8, max_batch=4),
        device="cpu")
    wf.add_engine("e0")
    assert wf.cluster.dispatcher.admit_probe == wf.cluster.can_admit
    assert wf.cluster.oom_feedback
    assert wf.balancer is wf.cluster.balancer
    assert len(wf.engines) == 2
    r0, r1 = (e.runner for e in wf.cluster.engines)
    assert r0.params is r1.params and r0.pool_address() != r1.pool_address()


def test_llm_call_timeout_raises():
    wf = tagents.Workflow(app_name="t", llm_timeout_s=0.05, device="cpu")
    h = tagents.Headers(msg_id="m1", app_name="t", upstream_name=None,
                        app_start_time=0.0)
    with pytest.raises(TimeoutError, match="timed out"):
        wf._llm_call("agent", np.zeros(4, np.int32), h, max_new_tokens=2)


def test_failed_agent_stage_surfaces_in_results():
    class Exploding(tagents.BaseAgent):
        def _run_impl(self, input_data, metadata):
            raise RuntimeError("boom")

    wf = tagents.Workflow(app_name="t", device="cpu")
    wf.add_agent("Boom", Exploding)
    msg_id = wf.submit_task("Boom", {})
    wf.bus.drain()
    for t in wf._threads:
        t.join(timeout=10)
        assert not t.is_alive()
    assert wf._outstanding == 0
    res = wf._results[msg_id]
    assert res["failed"] and "RuntimeError: boom" in res["error"]


def test_workflow_rejects_per_knob_kwargs():
    with pytest.raises(TypeError, match="ServingConfig"):
        tagents.Workflow(num_blocks=16, device="cpu")


def test_workflow_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tagents.Workflow(app_name="t")
