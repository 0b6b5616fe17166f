"""The generator: one seed, one call list; another seed, another."""
import json

import numpy as np
import pytest

from portbench import manifest
from portbench.traffic import Traffic, draw

MIXES = ("qa-sessions", "agent-loop")
VOCAB = 151_936


def _spec(mix):
    return json.loads((manifest.BENCH / "traffic" / f"{mix}.json").read_text())


def _calls(spec, seed, n=4):
    t = Traffic(spec, seed, VOCAB)
    out = []
    for s in range(t.sessions):
        for _ in range(n):
            sc = t.next_script(s)
            out.append((sc.session, sc.index, sc.task.tobytes(), sc.think_s,
                        tuple((a, o, tl) for a, o, tl in sc.calls()),
                        tuple(t2.tool.tobytes() for st in sc.stages
                              for t2 in st.turns if t2.tool is not None)))
    return out, t.start_offsets().tolist(), {
        k: v.tobytes() for k, v in t.system.items()}


@pytest.mark.parametrize("mix", MIXES)
def test_same_seed_same_calls(mix):
    spec = _spec(mix)
    assert _calls(spec, 2 ** 31 + 7) == _calls(spec, 2 ** 31 + 7)


@pytest.mark.parametrize("mix", MIXES)
def test_other_seed_other_calls(mix):
    spec = _spec(mix)
    a, b = _calls(spec, 2 ** 31 + 7), _calls(spec, 2 ** 31 + 8)
    assert a[0] != b[0] and a[1] != b[1] and a[2] != b[2]


@pytest.mark.parametrize("mix", MIXES)
def test_session_order_does_not_change_a_session(mix):
    """A session's scripts do not depend on when other sessions draw."""
    spec = _spec(mix)
    t1, t2 = Traffic(spec, 5, VOCAB), Traffic(spec, 5, VOCAB)
    a = [t1.next_script(3).calls() for _ in range(3)]
    for s in range(t2.sessions):
        if s != 3:
            t2.next_script(s)
    b = [t2.next_script(3).calls() for _ in range(3)]
    assert a == b


def test_agent_loop_stays_within_max_context():
    spec = _spec("agent-loop")
    t = Traffic(spec, 11, VOCAB)
    for s in range(t.sessions):
        for _ in range(8):
            sc = t.next_script(s)
            total = (len(t.system["tools"]) + len(sc.task)
                     + sum(o + tl for _, o, tl in sc.calls()))
            assert total <= spec["max_context"]
            assert 2 <= len(sc.stages[0].turns) <= 5


def test_qa_branches_and_lengths():
    spec = _spec("qa-sessions")
    t = Traffic(spec, 3, VOCAB)
    experts, outs = [], []
    for s in range(t.sessions):
        sc = t.next_script(s)
        assert [st.agent for st in sc.stages][0] == "Router"
        assert sc.stages[0].turns[0].out == 4
        experts.append(sc.stages[1].agent)
        outs.append(sc.stages[1].turns[0].out)
    share = experts.count("MathAgent") / len(experts)
    assert 0.35 < share < 0.65
    assert 16 <= min(outs) and max(outs) <= 512
    assert 60 < np.median(outs) < 140


@pytest.mark.parametrize("d,lo,hi", [
    ({"dist": "uniform_int", "lo": 2, "hi": 5}, 2, 5),
    ({"dist": "lognormal", "median": 384, "sigma": 0.6, "lo": 128,
      "hi": 1024}, 128, 1024),
    ({"dist": "uniform", "lo": 0.2, "hi": 2.0}, 0.2, 2.0),
])
def test_draw_bounds(d, lo, hi):
    rng = np.random.default_rng(0)
    xs = [draw(rng, d) for _ in range(2000)]
    assert lo <= min(xs) and max(xs) <= hi


OPEN = {"arrivals": {"gap_s": {"dist": "exponential", "mean": 0.25},
                     "group": {"dist": "uniform_int", "lo": 1, "hi": 4}}}


def _open_spec():
    spec = dict(_spec("qa-sessions"), **OPEN)
    for k in ("sessions", "start_spread_s", "think_s"):
        del spec[k]
    return spec


def _open_calls(seed, n=200):
    t = Traffic(_open_spec(), seed, VOCAB)
    it = t.arrivals()
    out = []
    for _ in range(n):
        off, s = next(it)
        sc = t.next_script(s)
        assert sc.think_s is None
        out.append((off, s, sc.task.tobytes(), tuple(sc.calls())))
    return out


def test_open_loop_arrivals_repeat_by_seed():
    a, b = _open_calls(2 ** 31 + 7), _open_calls(2 ** 31 + 7)
    c = _open_calls(2 ** 31 + 8)
    assert a == b and a != c
    assert [s for _, s, _, _ in a] == list(range(len(a)))


def test_open_loop_arrivals_follow_the_mix():
    """Groups of 1-4 sessions, their gaps of mean 0.25 s: 2.5 groups, so
    about 10 sessions, a second."""
    offs = [o for o, _, _, _ in _open_calls(3, n=4000)]
    groups = np.unique(offs, return_counts=True)[1]
    assert set(groups) == {1, 2, 3, 4}
    assert offs == sorted(offs)
    rate = len(offs) / offs[-1]
    assert 9.0 < rate < 11.0


def test_closed_loop_arrivals_are_the_start_offsets():
    t = Traffic(_spec("qa-sessions"), 9, VOCAB)
    arr = list(t.arrivals())
    assert sorted(s for _, s in arr) == list(range(t.sessions))
    assert [o for o, _ in arr] == sorted(t.start_offsets().tolist())
