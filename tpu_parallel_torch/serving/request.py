"""Request/result types for the continuous-batching serving engine.

A :class:`Request` is one user generation call: a prompt, per-request
sampling knobs, a stopping contract (``max_new_tokens`` and an optional
EOS id), and an optional streaming callback.  The engine wraps every
submitted request in a :class:`RequestOutput` — the mutable record that
accumulates tokens and timing as the request moves through QUEUED ->
RUNNING -> FINISHED (or is REJECTED / EXPIRED by the scheduler).

Incremental delivery: every engine tick yields :class:`StreamEvent`s, one
per token produced that tick; ``Request.on_token`` (when set) receives the
same events synchronously as they are produced.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, List, Optional, Sequence

_request_counter = itertools.count()


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling knobs — the same contract as
    :func:`tpu_parallel_torch.models.generate.generate`: ``temperature == 0`` is
    greedy; ``top_k``/``top_p`` compose by intersection after the
    temperature scale, and the argmax token always survives the nucleus
    cut.  Unlike the static path these are per-REQUEST: two requests with
    different knobs decode in the same engine tick (the sampler is
    vectorized over traced per-slot knob arrays, so no recompile per
    combination)."""

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 0.0


# request lifecycle states
QUEUED = "queued"  # accepted, waiting for a free slot
RUNNING = "running"  # occupies a cache slot, decoding
FINISHED = "finished"  # completed (see finish_reason)
REJECTED = "rejected"  # refused at submission (queue full / capacity)
EXPIRED = "expired"  # timed out in the queue (scheduler max_wait)
CANCELLED = "cancelled"  # cancelled mid-flight (deadline / client cancel)
FAILED = "failed"  # the cluster gave up (retry limit, no live replica)

# typed rejection reasons — machine-readable ``finish_reason`` values a
# front end can switch on (human detail, when any, rides in
# ``RequestOutput.detail``).  The engine and the cluster frontend use the
# SAME vocabulary so a client sees identical reporting regardless of
# which layer refused.
REJECT_QUEUE_FULL = "queue_full"  # scheduler admission control
REJECT_DRAINING = "draining"  # drain gate: no new work accepted
REJECT_CAPACITY = "capacity"  # prompt + budget exceed seq_len
REJECT_TOKEN_BUDGET = "token_budget"  # cluster-wide token backpressure
REJECT_CLIENT_LIMIT = "client_limit"  # per-client concurrency cap
# overload shedding (cluster autopilot): a NEW lowest-effective-priority
# submission rejected — or a queued request whose deadline is provably
# unmeetable cancelled — while the fleet is past its SLO targets.  Shed
# early and loudly beats missing every deadline silently.
REJECT_SHED = "shed"
# device-side integrity sentinel (engine ``sample_tokens``): a request's
# logits went non-finite (NaN/Inf — corrupted weights, a numerics bug,
# bad hardware).  The request FAILS typed instead of streaming garbage
# tokens, and the replica escalates to DEGRADED health.
FAIL_INTEGRITY = "integrity"


@dataclasses.dataclass
class Request:
    """One generation request.

    ``prompt`` is a token-id sequence (list/tuple/1-D array).  ``prompt``
    plus ``max_new_tokens`` must fit the model's ``seq_len`` — the same
    capacity contract as the static ``generate()`` path, because each cache
    slot is one ``seq_len``-long row of the pool.
    """

    prompt: Sequence[int]
    max_new_tokens: int = 32
    sampling: SamplingParams = dataclasses.field(default_factory=SamplingParams)
    eos_token_id: Optional[int] = None
    request_id: Optional[str] = None
    # speculative decoding: None inherits the engine's draft_tokens
    # setting, 0 disables drafting for THIS request (it still shares
    # verify ticks, as a one-token block), >0 caps the request's draft
    # length (clamped to the engine's compiled width).  Output stays
    # exact either way — the knob trades wasted verify positions against
    # multi-token ticks per request.
    draft_tokens: Optional[int] = None
    # cluster-frontend fields (tpu_parallel/cluster/ — the engine itself
    # ignores all three): per-client concurrency caps key off client_id;
    # priority reorders frontend admission (higher first, aged so lower
    # classes never starve); deadline is a per-request completion budget
    # in SECONDS FROM ARRIVAL — past it the frontend cancels the request
    # wherever it is, including in-engine work.
    client_id: Optional[str] = None
    priority: int = 0
    deadline: Optional[float] = None
    # daemon-layer idempotence key (tpu_parallel/daemon/): a client
    # retrying an acknowledged submission — across network failures or
    # a daemon crash+recovery — reuses its dedupe token and gets the
    # SAME request record back instead of a duplicate admission.  The
    # engine and cluster frontend carry it untouched.
    dedupe_token: Optional[str] = None
    # called synchronously with each StreamEvent for this request
    on_token: Optional[Callable[["StreamEvent"], None]] = None

    def __post_init__(self):
        if self.request_id is None:
            self.request_id = f"req-{next(_request_counter)}"
        if len(self.prompt) < 1:
            raise ValueError("empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError(f"max_new_tokens={self.max_new_tokens} < 1")
        if self.draft_tokens is not None and self.draft_tokens < 0:
            raise ValueError(f"draft_tokens={self.draft_tokens} < 0")


@dataclasses.dataclass(frozen=True)
class StreamEvent:
    """One incrementally-delivered token — or a terminal notification.

    Queue expiry and cancellation deliver a tokenless terminal event
    (``token == -1``, ``index == -1``, ``finish_reason`` naming the cause)
    so stream consumers learn the request died; every other event carries
    a real token.
    """

    request_id: str
    token: int
    index: int  # 0-based position among the request's generated tokens
    finished: bool = False
    # "eos" | "length" | "max_wait" | "cancelled" | "deadline" |
    # "retry_limit" | "no_replica" when finished
    finish_reason: Optional[str] = None


@dataclasses.dataclass
class RequestOutput:
    """The engine's mutable per-request record (returned by
    ``ServingEngine.add_request``; also the scheduler's queue entry)."""

    request: Request
    status: str = QUEUED
    tokens: List[int] = dataclasses.field(default_factory=list)
    finish_reason: Optional[str] = None
    # human-readable detail behind a TYPED finish_reason (e.g. the exact
    # capacity arithmetic behind "capacity") — never switch on this
    detail: Optional[str] = None
    # timing (engine clock; None until the event happens)
    arrival_time: Optional[float] = None
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    token_times: List[float] = dataclasses.field(default_factory=list)

    @property
    def done(self) -> bool:
        return self.status in (FINISHED, REJECTED, EXPIRED, CANCELLED, FAILED)

    @property
    def ttft(self) -> Optional[float]:
        """Time-to-first-token (seconds), None until the first token."""
        if self.first_token_time is None or self.arrival_time is None:
            return None
        return self.first_token_time - self.arrival_time

    def inter_token_latencies(self) -> List[float]:
        """Gaps between consecutive token deliveries (seconds)."""
        return [
            b - a for a, b in zip(self.token_times, self.token_times[1:])
        ]
