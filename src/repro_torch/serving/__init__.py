from repro_torch.serving.autoscaler import (
    Autoscaler,
    AutoscalerConfig,
    ClusterSignals,
    InstanceSignal,
    signals_from_cluster,
)
from repro_torch.serving.batch_scheduler import (
    BatchScheduler,
    IterationBatch,
    IterationPlan,
    KeyPrefixMatcher,
    PrefillChunk,
    SchedStats,
    Segment,
    TokenPrefixMatcher,
    flatten_plan,
    pad_bucket,
)
from repro_torch.serving.config import ROLES, SIM_FIELD_MAP, ServingConfig
from repro_torch.serving.engine import (
    LLMEngine,
    PagedModelRunner,
    TokenBuffer,
    TokenRef,
    serve_follower,
)
from repro_torch.serving.cluster import ServingCluster
from repro_torch.serving.faults import (
    FAULT_KINDS,
    DispatchEffects,
    FaultInjector,
    FaultPlan,
    FaultSpec,
    InstanceCrashed,
    TransferFault,
)
from repro_torch.serving.handoff import (
    HandoffError,
    decode_targets,
    drive_handoffs,
    handoff,
)
from repro_torch.serving.kv_cache import BlockManager, NoFreeBlocks
from repro_torch.serving.migration import (
    MigrationError,
    RequestSnapshot,
    migrate,
    migrate_many,
    restore_request,
    snapshot_request,
)
from repro_torch.serving.prefix_cache import PrefixCache, PrefixCacheStats
from repro_torch.serving.recovery import (
    LoadShedder,
    RecoveryManager,
    RecoveryRecord,
)
from repro_torch.serving.request import (
    CompletionRecord,
    Request,
    RequestPhase,
    RequestState,
    reset_request_ids,
)
from repro_torch.serving.tensor_parallel import (
    MeshSlice,
    make_serving_slices,
    shard_params,
)

__all__ = ["BatchScheduler", "IterationBatch", "IterationPlan",
           "KeyPrefixMatcher", "PrefillChunk", "SchedStats", "Segment",
           "TokenPrefixMatcher", "flatten_plan", "pad_bucket",
           "LLMEngine", "PagedModelRunner", "ServingCluster",
           "TokenBuffer", "TokenRef", "BlockManager", "NoFreeBlocks",
           "PrefixCache", "PrefixCacheStats",
           "CompletionRecord", "Request", "RequestPhase", "RequestState",
           "reset_request_ids",
           "ServingConfig", "SIM_FIELD_MAP", "ROLES",
           "Autoscaler", "AutoscalerConfig", "ClusterSignals",
           "InstanceSignal", "signals_from_cluster",
           "MigrationError", "RequestSnapshot", "migrate", "migrate_many",
           "restore_request", "snapshot_request",
           "HandoffError", "handoff", "decode_targets", "drive_handoffs",
           "FAULT_KINDS", "DispatchEffects", "FaultInjector", "FaultPlan",
           "FaultSpec", "InstanceCrashed", "TransferFault",
           "LoadShedder", "RecoveryManager", "RecoveryRecord",
           "MeshSlice", "make_serving_slices", "serve_follower",
           "shard_params"]
