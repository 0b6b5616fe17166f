from repro_torch.sim.cost_model import COST_MODELS, LLAMA2_13B, LLAMA3_8B, CostModel
from repro_torch.sim.simulator import SimConfig, SimInstance, SimResults, Simulation, run_policy
from repro_torch.sim.workload import (
    AgentProfile,
    AppSpec,
    arrival_times,
    colocated_apps,
    make_app,
    with_shared_prefixes,
)

__all__ = ["COST_MODELS", "LLAMA2_13B", "LLAMA3_8B", "CostModel", "SimConfig",
           "SimInstance", "SimResults", "Simulation", "run_policy",
           "AgentProfile", "AppSpec", "arrival_times", "colocated_apps", "make_app",
           "with_shared_prefixes"]
