"""Workload generators: trace synthesis shared by sim and real cluster."""
from repro_torch.workloads.traces import Trace, TraceConfig, generate_trace

__all__ = ["Trace", "TraceConfig", "generate_trace"]
