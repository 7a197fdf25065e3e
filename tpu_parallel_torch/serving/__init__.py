"""Continuous-batching serving: the port of ``tpu_parallel/serving``.

Iteration-level scheduling over a fixed-slot or block-paged pool of KV
caches, with the bucketed / batched / chunked prefill, prefix reuse, and
per-step, fused and unified ragged ticks (one CUDA graph replay per tick
on the card).  The radix / host / disk KV tiers and speculative decoding
are not ported yet.
"""

from tpu_parallel_torch.serving.cache_pool import (
    BlockAllocator,
    CachePool,
    PagedCachePool,
    clear_rows,
    copy_prefix_rows,
    extract_rows,
    insert_rows,
    scatter_rows,
)
from tpu_parallel_torch.serving.engine import (
    NON_FINITE_TOKEN,
    ServingEngine,
    default_prefill_buckets,
    sample_tokens,
)
from tpu_parallel_torch.serving.metrics import ServingMetrics, percentile
from tpu_parallel_torch.serving.prefix_cache import PrefixCache
from tpu_parallel_torch.serving.request import (
    CANCELLED,
    EXPIRED,
    FAIL_INTEGRITY,
    FAILED,
    FINISHED,
    QUEUED,
    REJECT_CAPACITY,
    REJECT_CLIENT_LIMIT,
    REJECT_DRAINING,
    REJECT_QUEUE_FULL,
    REJECT_SHED,
    REJECT_TOKEN_BUDGET,
    REJECTED,
    RUNNING,
    Request,
    RequestOutput,
    SamplingParams,
    StreamEvent,
)
from tpu_parallel_torch.serving.scheduler import (
    FIFOScheduler,
    SchedulerConfig,
    SubmitResult,
)

__all__ = [
    "BlockAllocator",
    "CachePool",
    "PagedCachePool",
    "NON_FINITE_TOKEN",
    "FAIL_INTEGRITY",
    "insert_rows",
    "scatter_rows",
    "extract_rows",
    "clear_rows",
    "copy_prefix_rows",
    "ServingEngine",
    "default_prefill_buckets",
    "sample_tokens",
    "ServingMetrics",
    "percentile",
    "PrefixCache",
    "Request",
    "RequestOutput",
    "SamplingParams",
    "StreamEvent",
    "QUEUED",
    "RUNNING",
    "FINISHED",
    "REJECTED",
    "EXPIRED",
    "CANCELLED",
    "FAILED",
    "REJECT_QUEUE_FULL",
    "REJECT_DRAINING",
    "REJECT_CAPACITY",
    "REJECT_TOKEN_BUDGET",
    "REJECT_CLIENT_LIMIT",
    "REJECT_SHED",
    "FIFOScheduler",
    "SchedulerConfig",
    "SubmitResult",
]
