"""Continuous-batching serving: the port of ``tpu_parallel/serving``.

Iteration-level scheduling over a fixed-slot or block-paged pool of KV
caches, with the bucketed / batched / chunked prefill, prefix reuse, and
per-step, fused and unified ragged ticks (one CUDA graph replay per tick
on the card); the hierarchical KV memory (radix prefix tree, host and disk
tiers) and prefix export / import through the ``KVW1`` wire format, whose
bytes match the JAX package's; and exact speculative (draft-verify)
decoding with host or on-device n-gram drafting.
"""

from tpu_parallel_torch.serving.cache_pool import (
    BlockAllocator,
    CachePool,
    KVIntegrityError,
    PagedCachePool,
    block_checksums,
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
from tpu_parallel_torch.serving.kv_hierarchy import (
    MIGRATION_STATUSES,
    KVPrefixExport,
    RadixPrefixCache,
)
from tpu_parallel_torch.serving.kv_wire import (
    WIRE_REASONS,
    WireFormatError,
    decode_export,
    decode_exports,
    encode_export,
    encode_exports,
    read_export_file,
    write_export_file,
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
from tpu_parallel_torch.serving.spec_decode import (
    Drafter,
    NGramDrafter,
    adapt_draft_len,
    generate_speculative,
    greedy_verify,
    rejection_verify,
    verify_tokens,
)

__all__ = [
    "BlockAllocator",
    "CachePool",
    "KVIntegrityError",
    "NON_FINITE_TOKEN",
    "FAIL_INTEGRITY",
    "PagedCachePool",
    "block_checksums",
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
    "RadixPrefixCache",
    "KVPrefixExport",
    "MIGRATION_STATUSES",
    "WireFormatError",
    "WIRE_REASONS",
    "encode_export",
    "decode_export",
    "encode_exports",
    "decode_exports",
    "write_export_file",
    "read_export_file",
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
    "Drafter",
    "NGramDrafter",
    "adapt_draft_len",
    "generate_speculative",
    "greedy_verify",
    "rejection_verify",
    "verify_tokens",
]
