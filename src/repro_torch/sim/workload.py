"""Multi-agent application workloads (§2.1) + arrival trace generation.

The three benchmark applications (Fig. 2) are encoded declaratively; the
per-agent output-length distributions are lognormals whose parameters are
matched to the inter-agent ratios reported in Figs. 3 & 5 (e.g. the QA
Router's ~20-token routing decisions vs. the Humanities agent's long-form
answers — up to ~25x latency spread).  Dataset "groups" (G+M / M+W / S+S
etc.) perturb those parameters the way the paper's datasets do (§7.2,
e.g. SocialIQA shortens HumanitiesAgent outputs).

Arrivals follow a Gamma-renewal process with CV > 1 (bursty), matching
the shape of the production trace the paper samples [Splitwise, ISCA'24],
scaled to a target request rate.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List

import numpy as np


@dataclasses.dataclass(frozen=True)
class AgentProfile:
    name: str
    out_mu: float                  # lognormal params of output length
    out_sigma: float
    prompt_mu: float = 5.0         # lognormal of prompt length (~150 tok)
    prompt_sigma: float = 0.4
    system_prompt_len: int = 0     # tokens of the agent's fixed preamble —
    #                                identical across calls, so engines with
    #                                prefix caching serve them from shared KV

    def sample_output_len(self, rng: np.random.Generator) -> int:
        return max(2, int(rng.lognormal(self.out_mu, self.out_sigma)))

    def sample_prompt_len(self, rng: np.random.Generator) -> int:
        unique = max(8, int(rng.lognormal(self.prompt_mu, self.prompt_sigma)))
        return self.system_prompt_len + unique


@dataclasses.dataclass(frozen=True)
class AppSpec:
    """Declarative workflow: route(agent, rng, hops) -> downstream agents."""
    name: str
    agents: Dict[str, AgentProfile]
    entry: str
    route: Callable[[str, np.random.Generator, int], List[str]]
    kind: str = ""                                 # branching|sequential|feedback


# --------------------------------------------------------------------------- #
# Question Answer — dynamic branching (Fig. 2a)
# --------------------------------------------------------------------------- #
def _qa(group: str) -> AppSpec:
    # group tweaks: S+S -> shorter humanities outputs (SocialIQA, §7.2)
    hum_mu = {"G+M": math.log(380), "M+W": math.log(340), "S+S": math.log(150)}[group]
    math_mu = {"G+M": math.log(230), "M+W": math.log(260), "S+S": math.log(200)}[group]
    agents = {
        "Router": AgentProfile("Router", math.log(16), 0.35),
        "MathAgent": AgentProfile("MathAgent", math_mu, 0.55),
        "HumanitiesAgent": AgentProfile("HumanitiesAgent", hum_mu, 0.6),
    }

    def route(agent, rng, hops):
        if agent == "Router":
            return ["MathAgent"] if rng.random() < 0.5 else ["HumanitiesAgent"]
        return []

    return AppSpec(f"QA[{group}]", agents, "Router", route, "branching")


# --------------------------------------------------------------------------- #
# Report Generate — sequential (Fig. 2b)
# --------------------------------------------------------------------------- #
def _rg(group: str) -> AppSpec:
    res_mu = {"TQ": math.log(420), "NCD": math.log(330), "NQ": math.log(300)}[group]
    wri_mu = {"TQ": math.log(540), "NCD": math.log(460), "NQ": math.log(420)}[group]
    agents = {
        "ResearchAgent": AgentProfile("ResearchAgent", res_mu, 0.45),
        "WriterAgent": AgentProfile("WriterAgent", wri_mu, 0.4, prompt_mu=6.0),
    }

    def route(agent, rng, hops):
        return ["WriterAgent"] if agent == "ResearchAgent" else []

    return AppSpec(f"RG[{group}]", agents, "ResearchAgent", route, "sequential")


# --------------------------------------------------------------------------- #
# Code Generate — dynamic feedback (Fig. 2c)
# --------------------------------------------------------------------------- #
def _cg(group: str) -> AppSpec:
    eng_mu = {"HE": math.log(520), "MBPP": math.log(380), "APPS": math.log(640)}[group]
    retry_p = {"HE": 0.30, "MBPP": 0.25, "APPS": 0.45}[group]
    agents = {
        "ProductManager": AgentProfile("ProductManager", math.log(260), 0.4),
        "Architect": AgentProfile("Architect", math.log(340), 0.45),
        "ProjectManager": AgentProfile("ProjectManager", math.log(170), 0.4),
        "Engineer": AgentProfile("Engineer", eng_mu, 0.5, prompt_mu=6.2),
        "QAEngineer": AgentProfile("QAEngineer", math.log(290), 0.45, prompt_mu=6.0),
    }
    chain = {"ProductManager": "Architect", "Architect": "ProjectManager",
             "ProjectManager": "Engineer", "Engineer": "QAEngineer"}

    def route(agent, rng, hops):
        if agent in chain:
            return [chain[agent]]
        if agent == "QAEngineer":
            # evaluation failed -> feed back to the Engineer (bounded loop)
            if hops < 12 and rng.random() < retry_p:
                return ["Engineer"]
        return []

    return AppSpec(f"CG[{group}]", agents, "ProductManager", route, "feedback")


# dataset groups per the paper (§2.1.3): Group1/2/3 per app
QA_GROUPS = ("G+M", "M+W", "S+S")
RG_GROUPS = ("TQ", "NCD", "NQ")
CG_GROUPS = ("HE", "MBPP", "APPS")


def make_app(app: str, group: str) -> AppSpec:
    return {"QA": _qa, "RG": _rg, "CG": _cg}[app](group)


def with_shared_prefixes(app: AppSpec, system_prompt_len: int) -> AppSpec:
    """Variant of ``app`` whose every agent carries a fixed
    ``system_prompt_len``-token preamble (the shared-prefix reuse
    scenario: same agent prompt resent on every call)."""
    agents = {n: dataclasses.replace(p, system_prompt_len=system_prompt_len)
              for n, p in app.agents.items()}
    return dataclasses.replace(app, agents=agents)


def colocated_apps() -> List[AppSpec]:
    """§7.3 co-location workload: QA[G+M] + RG[TQ] + CG[HE]."""
    return [make_app("QA", "G+M"), make_app("RG", "TQ"), make_app("CG", "HE")]


# --------------------------------------------------------------------------- #
# arrivals
# --------------------------------------------------------------------------- #
def arrival_times(rng: np.random.Generator, rate: float, duration: float,
                  cv: float = 1.6) -> np.ndarray:
    """Bursty Gamma-renewal arrivals at `rate` req/s for `duration` s.

    cv > 1 mimics the heavy-tailed inter-arrival distribution of the
    production trace [41] that the paper proportionally samples."""
    shape = 1.0 / (cv ** 2)
    scale = 1.0 / (rate * shape)
    n = int(rate * duration * 2) + 16
    gaps = rng.gamma(shape, scale, n)
    t = np.cumsum(gaps)
    return t[t < duration]
