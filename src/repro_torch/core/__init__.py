# Kairos core — the paper's primary contribution: workflow orchestrator,
# workflow-aware priority scheduler, memory-aware time-slot dispatcher.
from repro_torch.core.balancer import LoadBalancer
from repro_torch.core.dispatcher import (
    BestFitOracleDispatcher,
    InstanceModel,
    RoundRobinDispatcher,
    TimeSlotDispatcher,
)
from repro_torch.core.distributions import (
    ConvergenceTracker,
    DistributionProfiler,
    EmpiricalDistribution,
    wasserstein_1d,
)
from repro_torch.core.memory_model import MemoryRamp, make_ramp
from repro_torch.core.orchestrator import ArchMemoryTraits, HardwareProfile, Orchestrator
from repro_torch.core.priority import PriorityTable, agent_priorities, classical_mds_1d
from repro_torch.core.scheduler import (
    FCFSScheduler,
    KairosScheduler,
    OracleScheduler,
    SchedulerPolicy,
    TopoScheduler,
)
from repro_torch.core.workflow import WorkflowAnalyzer, WorkflowGraph

__all__ = [
    "LoadBalancer", "BestFitOracleDispatcher", "InstanceModel",
    "RoundRobinDispatcher", "TimeSlotDispatcher", "ConvergenceTracker",
    "DistributionProfiler", "EmpiricalDistribution", "wasserstein_1d",
    "MemoryRamp", "make_ramp", "ArchMemoryTraits", "HardwareProfile",
    "Orchestrator", "PriorityTable", "agent_priorities", "classical_mds_1d",
    "FCFSScheduler", "KairosScheduler", "OracleScheduler", "SchedulerPolicy",
    "TopoScheduler", "WorkflowAnalyzer", "WorkflowGraph",
]
