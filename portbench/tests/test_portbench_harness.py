"""A whole run of each cell at a tiny size on the CPU, past the look for
a card: sound, it is correct; with the timed path broken underneath, it
is not; and the control (the reference one precision down, in the
program's place) comes out not correct where the program is."""
import time

import pytest
import torch

from portbench import check, manifest, measure, report
from portbench.control import LOWER
from portbench.harness import run_cell
from portbench.tests.tiny import CELLS, SEED, full_cell, tiny_cell
from portbench.weights import make_weights

SECONDS = 2.5
DRAIN_S = 20.0


class Args:
    trace, seed, seconds = 0, SEED, SECONDS


def run(cell, after_setup=None, traced=False):
    torch.manual_seed(0)
    return run_cell(cell, SEED, SECONDS, traced, "cpu", time.monotonic(),
                    check_registry=False, after_setup=after_setup,
                    drain_s=DRAIN_S)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    cell = tiny_cell(name)
    res = run(cell)
    assert res.verdict.correct, res.verdict.compared
    assert res.verdict.gaps["logit_gap"] < 1e-4
    assert res.end_to_end["workflows"] > 0 and res.failed == 0
    # every workflow submitted ended, the last ones after the window
    assert res.accounting["open_workflows"] == 0
    assert len(res.workflows) == res.submitted
    assert any(w.t_done > res.window[1] for w in res.workflows)
    _, line = report.build(cell, Args, res, [], "cpu", "n/a")
    assert line["correct"] and set(line["metrics"]) == {
        m["name"] for m in cell.end_to_end}
    assert list(line)[-1] == "compared"


def _alter_tokens(wf):
    """A token altered where it is produced: the first row of every
    step's argmax comes back one id higher."""
    vocab = wf.vocab_size
    for e in wf.cluster.engines:
        f = e.runner.run_iteration

        def altered(batch, f=f):
            out = f(batch).clone()
            out[0] = (out[0] + 1) % vocab
            return out

        e.runner.run_iteration = altered


def _cut_answers(wf):
    """An answer altered where it is handed back: one token short."""
    for e in wf.cluster.engines:
        f = e.collect

        def cut(*a, f=f, **kw):
            done = f(*a, **kw)
            for r in done:
                r.output_tokens.pop()
            return done

        e.collect = cut


def _drop_calls(wf):
    """A call that never comes back: the cluster takes every third call
    of the traffic and never serves it."""
    wf.llm_timeout_s = 60.0
    f, seen = wf.cluster.submit, [0]

    def dropping(req, f=f):
        seen[0] += 1
        if seen[0] % 3:
            return f(req)

    wf.cluster.submit = dropping


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", [_alter_tokens, _cut_answers, _drop_calls],
                         ids=["token_altered", "answer_cut", "call_dropped"])
def test_broken_path_is_not_correct(name, fault):
    res = run(tiny_cell(name), after_setup=fault)
    assert not res.verdict.correct
    c = res.verdict.compared
    if fault is _alter_tokens:
        assert any(c[k]["value"] > c[k]["limit"] for k in check.GAP_NUMBERS
                   if k in c)
    elif fault is _cut_answers:
        assert c["short_or_long_answers"]["value"] > 0
    else:
        assert c["calls_never_back"]["value"] > 0
        assert c["open_workflows"]["value"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_where_program_passes(name):
    """bfloat16 configuration, as the cells: on the sample a run compares,
    the program's gaps come out correct through ``check.verdict`` with
    the cell's limits, and the fp8 reference's, in its place, do not."""
    cell = tiny_cell(name, dtype="bfloat16")
    res = run_cell(cell, SEED, SECONDS, False, "cpu", time.monotonic(),
                   check_registry=False, run_check=False, drain_s=DRAIN_S)
    chk = cell.config["check"]
    calls = [c for c in res.calls if measure.inside(c.t_finish, res.window)]
    picked = check.sample(calls, SEED, chk["min_tokens"], chk["max_calls"])
    g = check.control_gaps(make_weights(res.arch, SEED, "cpu"), res.arch,
                           picked, "cpu", LOWER["bfloat16"])
    limits, n = chk["limits"], chk["min_tokens"]
    assert check.verdict(res.accounting, g["served"], limits, n).correct
    control = check.verdict(check.NO_FAULT, g["control"], limits, n)
    assert not control.correct
    assert g["control"].size == g["served"].size >= n
    for name, limit in limits.items():
        assert control.compared[name]["value"] > limit


def test_open_loop_mix_runs_correct():
    """A mix of scheduled arrivals (Poisson groups of 1-3 workflows) runs
    through the same harness: correct, and no session comes back."""
    cell = tiny_cell("qwen3-1.7b.qa-sessions")
    for k in ("sessions", "start_spread_s", "think_s"):
        del cell.traffic[k]
    cell.traffic["arrivals"] = {
        "gap_s": {"dist": "exponential", "mean": 0.15},
        "group": {"dist": "uniform_int", "lo": 1, "hi": 3}}
    res = run(cell)
    assert res.verdict.correct, res.verdict.compared
    sessions = [w.session for w in res.workflows]
    assert len(sessions) == len(set(sessions)) == res.submitted > 10


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reads_every_host_metric(name):
    cell = tiny_cell(name)
    res = run(cell, traced=True)
    readers = [(m, manifest.reader(m)) for m in cell.per_layer]
    args = type("A", (), {"trace": 1, "seed": SEED, "seconds": SECONDS})
    _, line = report.build(cell, args, res, readers, "cpu", "n/a")
    # the device's metrics need the card's trace; the rest read here
    assert {"orch_gap_s_p50", "queue_s_p90", "prefix_hit_share",
            "dispatch_host_ms", "step_mfu"} <= set(line["metrics"])
    assert line["correct"]


@pytest.mark.cuda
def test_cells_run_on_the_card():
    """On the card: one short run of each cell is correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for name in CELLS:
        res = run_cell(full_cell(name), SEED, 10, False,
                       torch.device("cuda", 0), time.monotonic())
        assert res.verdict.correct, res.verdict.compared
