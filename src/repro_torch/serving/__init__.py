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
from repro_torch.serving.engine import (
    LLMEngine,
    PagedModelRunner,
    TokenBuffer,
    TokenRef,
)
from repro_torch.serving.kv_cache import BlockManager, NoFreeBlocks
from repro_torch.serving.prefix_cache import PrefixCache, PrefixCacheStats
from repro_torch.serving.request import (
    CompletionRecord,
    Request,
    RequestPhase,
    RequestState,
    reset_request_ids,
)

__all__ = ["BatchScheduler", "IterationBatch", "IterationPlan",
           "KeyPrefixMatcher", "PrefillChunk", "SchedStats", "Segment",
           "TokenPrefixMatcher", "flatten_plan", "pad_bucket",
           "LLMEngine", "PagedModelRunner", "TokenBuffer", "TokenRef",
           "BlockManager", "NoFreeBlocks", "PrefixCache", "PrefixCacheStats",
           "CompletionRecord", "Request", "RequestPhase", "RequestState",
           "reset_request_ids"]
