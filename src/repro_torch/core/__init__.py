"""Kairos core: request priority policies (the rest of ``repro.core``
joins in a later slice)."""
from repro_torch.core.scheduler import (
    FCFSScheduler,
    KairosScheduler,
    OracleScheduler,
    SchedulerPolicy,
    TopoScheduler,
)

__all__ = ["FCFSScheduler", "KairosScheduler", "OracleScheduler",
           "SchedulerPolicy", "TopoScheduler"]
