"""The one traffic generator: sessions of multi-agent workflows, in a
closed loop or arriving on a schedule.

A traffic mix is a JSON file (``portbench/traffic/<mix>.json``) of
parameters; this module turns it and a seed into the arrivals of
sessions and each session's sequence of workflow scripts.  Every
arrival, length, branch, think time and token id comes from
``numpy.random.default_rng`` streams keyed by the seed, never from the
model's output: the same seed gives the same calls in the same order per
session, whatever the weights say.

Keys of a mix:

``arrivals``
    Absent: a closed loop of ``sessions`` clients.  Each submits a
    workflow, waits for its last answer, thinks ``think_s`` (a
    distribution), and submits the next; session ``i`` submits its first
    at a time drawn uniformly from ``[0, start_spread_s)`` after set-up.
    Present: an open loop.  Groups of new sessions arrive, the gap
    before each group drawn from ``gap_s`` (exponential: Poisson
    arrivals) and its size from ``group`` (default 1; a large group is a
    burst); each such session submits one workflow and ends.
``warmup_s``
    Seconds of traffic before the measured window opens.
``system_prompts`` / ``agent_system``
    Token counts of the named system prompts, and the prompt each agent
    prepends to its calls (default: the prompt named after the agent).
    Agents that name one prompt share its KV through the prefix cache.
``task_tokens``
    Length of the task each workflow starts from.
``history``
    False: every call's prompt is the task.  True: the task and every
    earlier output and tool result of the workflow, in order.
``max_context``
    Optional: tool results are shortened, last first, so that no call's
    prompt and answer pass this many positions.
``stages``
    The workflow's chain.  Each stage names ``agents`` with their
    probabilities (the branch), ``turns`` (calls the agent makes in a
    row), ``output`` (each call's ``max_new_tokens``; no call stops
    early), and optionally ``tool_tokens`` and ``tool_latency_s``: after
    each call a tool runs for the drawn seconds and its result of the
    drawn length joins the history.

A distribution is ``{"dist": "const", "value": v}``, ``uniform_int``
(``lo``..``hi`` inclusive), ``uniform`` (``[lo, hi)``), ``exponential``
(``mean``), or ``lognormal`` (``median``, ``sigma``, rounded and clipped
to ``lo``..``hi``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

# stream keys beside the seed
_SYSTEM, _START, _SESSION, _TOKENS, _ARRIVAL = 1, 2, 3, 4, 7


def draw(rng: np.random.Generator, d: dict):
    kind = d["dist"]
    if kind == "const":
        return d["value"]
    if kind == "uniform_int":
        return int(rng.integers(d["lo"], d["hi"] + 1))
    if kind == "uniform":
        return float(rng.uniform(d["lo"], d["hi"]))
    if kind == "exponential":
        return float(rng.exponential(d["mean"]))
    if kind == "lognormal":
        v = d["median"] * np.exp(d["sigma"] * rng.standard_normal())
        return int(np.clip(round(float(v)), d["lo"], d["hi"]))
    raise ValueError(f"unknown distribution {kind!r}")


@dataclasses.dataclass
class Turn:
    out: int                        # max_new_tokens of the call
    tool: Optional[np.ndarray]      # the tool's result after it, if any
    tool_latency_s: float           # the tool's run time after the call


@dataclasses.dataclass
class Stage:
    agent: str
    turns: List[Turn]


@dataclasses.dataclass
class Script:
    """One workflow of one session, fully drawn."""
    session: int
    index: int
    task: np.ndarray
    stages: List[Stage]
    think_s: Optional[float]        # the session's pause after it; None
                                    # where the session ends (open loop)

    def calls(self) -> List[tuple]:
        """(agent, max_new_tokens, tool length) of every call, in order."""
        return [(s.agent, t.out, 0 if t.tool is None else len(t.tool))
                for s in self.stages for t in s.turns]


class Traffic:
    def __init__(self, spec: dict, seed: int, vocab: int):
        self.spec, self.seed, self.vocab = spec, seed % 2 ** 64, vocab
        rng = np.random.default_rng([self.seed, _SYSTEM])
        self.system = {name: rng.integers(0, vocab, n).astype(np.int32)
                       for name, n in sorted(spec["system_prompts"].items())}
        self.agents = sorted({a for st in spec["stages"] for a in st["agents"]})
        names = spec.get("agent_system", {})
        self.agent_system = {a: names.get(a, a) for a in self.agents}
        self.history = bool(spec.get("history", False))
        self._rngs: Dict[int, tuple] = {}
        self._next: Dict[int, int] = {}

    @property
    def closed(self) -> bool:
        return "arrivals" not in self.spec

    @property
    def sessions(self) -> int:
        """The closed loop's clients."""
        return int(self.spec["sessions"])

    def system_tokens(self, agent: str) -> np.ndarray:
        return self.system[self.agent_system[agent]]

    def start_offsets(self) -> np.ndarray:
        rng = np.random.default_rng([self.seed, _START])
        return rng.uniform(0.0, float(self.spec.get("start_spread_s", 0.0)),
                           self.sessions)

    def arrivals(self) -> Iterator[Tuple[float, int]]:
        """``(seconds after set-up, session)`` of each session's first
        workflow, in time order; endless for an open loop."""
        if self.closed:
            offsets = self.start_offsets()
            for s in np.argsort(offsets, kind="stable"):
                yield float(offsets[s]), int(s)
            return
        arr = self.spec["arrivals"]
        group = arr.get("group", {"dist": "const", "value": 1})
        rng = np.random.default_rng([self.seed, _ARRIVAL])
        t, session = 0.0, 0
        while True:
            t += float(draw(rng, arr["gap_s"]))
            for _ in range(int(draw(rng, group))):
                yield t, session
                session += 1

    def next_script(self, session: int) -> Script:
        """The session's next workflow (its own streams, consumed in
        order, so timing cannot change what a session sends)."""
        if session not in self._rngs:
            self._rngs[session] = (
                np.random.default_rng([self.seed, _SESSION, session]),
                np.random.default_rng([self.seed, _TOKENS, session]))
            self._next[session] = 0
        rng, tok = self._rngs[session]
        index = self._next[session]
        self._next[session] += 1
        spec = self.spec
        task_len = int(draw(rng, spec["task_tokens"]))
        drawn = []
        for st in spec["stages"]:
            agents = sorted(st["agents"])
            p = np.array([st["agents"][a] for a in agents], float)
            agent = agents[int(rng.choice(len(agents), p=p / p.sum()))]
            turns = []
            for _ in range(int(draw(rng, st["turns"]))):
                out = int(draw(rng, st["output"]))
                n_tool = (int(draw(rng, st["tool_tokens"]))
                          if "tool_tokens" in st else None)
                lat = (float(draw(rng, st["tool_latency_s"]))
                       if "tool_latency_s" in st else 0.0)
                turns.append([out, n_tool, lat])
            drawn.append((agent, turns))
        think = float(draw(rng, spec["think_s"])) if self.closed else None
        self._fit(drawn, task_len)
        task = tok.integers(0, self.vocab, task_len).astype(np.int32)
        stages = [Stage(agent, [Turn(out, None if n is None else
                                     tok.integers(0, self.vocab, n).astype(
                                         np.int32), lat)
                                for out, n, lat in turns])
                  for agent, turns in drawn]
        return Script(session, index, task, stages, think)

    def _fit(self, drawn, task_len: int) -> None:
        """Shorten tool results, last first, to keep every call's prompt
        and answer within ``max_context``."""
        limit = self.spec.get("max_context")
        if limit is None or not self.history:
            return
        sys_len = max(len(self.system_tokens(a)) for a, _ in drawn)
        turns = [t for _, ts in drawn for t in ts]
        total = sys_len + task_len + sum(t[0] + (t[1] or 0) for t in turns)
        for t in reversed(turns):
            if total <= limit:
                break
            cut = min(t[1] or 0, total - limit)
            if t[1] is not None:
                t[1] -= cut
            total -= cut

    def prompt_lengths(self) -> tuple:
        """(shortest, longest) prompt a call of this mix can send, system
        prompt included: the range set-up warms."""
        spec = self.spec
        sys_lens = [len(s) for s in self.system.values()]
        lo = min(sys_lens) + _lo(spec["task_tokens"])
        if not self.history:
            return lo, max(sys_lens) + _hi(spec["task_tokens"])
        hi = max(sys_lens) + _hi(spec["task_tokens"])
        for st in spec["stages"]:
            n = _hi(st["turns"])
            hi += n * (_hi(st["output"]) + (_hi(st["tool_tokens"])
                                            if "tool_tokens" in st else 0))
        return lo, min(hi, spec.get("max_context", hi))


def _lo(d: dict) -> int:
    return int(d["value"] if d["dist"] == "const" else d["lo"])


def _hi(d: dict) -> int:
    return int(d["value"] if d["dist"] == "const" else d["hi"])
