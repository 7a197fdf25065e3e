"""Iteration-level admission scheduling for the serving engine.

Orca-style continuous batching separates two decisions the static path
fuses: WHEN a request joins the batch (admission — here) and WHEN it
leaves (retirement — per-slot EOS/length checks in the engine).  The
scheduler owns the first: a FIFO queue with three policy knobs —

- ``max_queue``: admission control.  A full queue REJECTS new requests at
  submission instead of growing without bound (the backpressure signal a
  front-end needs).
- ``max_prefills_per_tick``: prefill/decode interleaving.  Each prefill
  runs a full prompt forward between decode ticks, stalling every running
  request's next token; capping admissions per tick bounds that
  head-of-line latency hit (1 = smoothest inter-token latency, higher =
  faster queue drain).  With the engine's bucketed prefill the whole
  admission set runs as ONE batched call, so higher values also amortize
  per-call overhead instead of multiplying it.
- ``max_wait``: queue timeout.  Requests that cannot reach a slot within
  ``max_wait`` seconds EXPIRE (dropped with status ``expired``) rather
  than serving a reply the client already abandoned.

Time is injectable: ``clock`` (default ``time.monotonic``) supplies "now"
whenever a caller does not pass it explicitly, so queue-timeout tests run
deterministically on a fake clock instead of sleeping.

Telemetry: given a ``registry``
(:class:`~tpu_parallel_torch.obs.registry.MetricRegistry` — the engine wires
its own in), every ``schedule()`` call publishes the
``serving_queue_age_seconds`` gauge (how long the OLDEST queued request
has waited — the head-of-line latency a new arrival is behind) and
observes each admitted request's queue wait into the
``serving_queue_wait_seconds`` histogram.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, List, Optional

from tpu_parallel_torch.serving.request import (
    EXPIRED,
    QUEUED,
    REJECT_DRAINING,
    REJECT_QUEUE_FULL,
    RequestOutput,
)


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    max_queue: Optional[int] = None  # None = unbounded queue
    max_prefills_per_tick: int = 1
    max_wait: Optional[float] = None  # seconds; None = wait forever


class SubmitResult:
    """Typed admission verdict: truthy on accept, falsy on reject with a
    machine-readable ``reason`` (``REJECT_QUEUE_FULL`` / ``REJECT_DRAINING``).

    Callers — the engine surfacing ``RequestOutput.finish_reason``, the
    cluster frontend deciding whether to try another replica — see WHY
    admission refused, not just that it did.  Usable like a bool
    (``if not submit(...)``).
    """

    __slots__ = ("reason",)

    ACCEPTED: "SubmitResult"

    def __init__(self, reason: Optional[str] = None):
        self.reason = reason

    def __bool__(self) -> bool:
        return self.reason is None

    def __repr__(self) -> str:
        return (
            "SubmitResult(accepted)"
            if self.reason is None
            else f"SubmitResult(rejected: {self.reason})"
        )


SubmitResult.ACCEPTED = SubmitResult()


class FIFOScheduler:
    """First-come-first-served admission with the policy knobs above.

    The engine calls ``submit`` at ``add_request`` time, then once per
    tick: ``expire(now)`` to drop timed-out entries, and
    ``schedule(n_free, now)`` to pop the tick's admissions.  ``now``
    defaults to the scheduler's own ``clock`` when omitted.
    """

    def __init__(
        self,
        config: Optional[SchedulerConfig] = None,
        clock: Callable[[], float] = time.monotonic,
        registry=None,
    ):
        self.config = config or SchedulerConfig()
        if self.config.max_prefills_per_tick < 1:
            raise ValueError(
                f"max_prefills_per_tick="
                f"{self.config.max_prefills_per_tick} < 1"
            )
        self.clock = clock
        self.registry = registry
        self._queue: deque = deque()
        # drain gate: True refuses NEW submissions (typed REJECT_DRAINING)
        # while already-queued entries keep admitting — set by
        # ``begin_drain()`` for graceful shutdown / replica retirement
        self.draining = False

    @property
    def depth(self) -> int:
        return len(self._queue)

    @property
    def pending_prefill_tokens(self) -> int:
        """Total prompt tokens waiting in the queue — the prefill work a
        new admission is behind (the cluster router's least-loaded signal,
        alongside queue depth and active slots)."""
        return sum(len(out.request.prompt) for out in self._queue)

    def queued(self) -> List[RequestOutput]:
        """Snapshot of the queue in FIFO order (no mutation)."""
        return list(self._queue)

    def oldest_age(self, now: Optional[float] = None) -> float:
        """Seconds the head-of-queue request has waited (0.0 when empty
        or the head has no arrival time)."""
        if not self._queue:
            return 0.0
        arrival = self._queue[0].arrival_time
        if arrival is None:
            return 0.0
        if now is None:
            now = self.clock()
        return max(0.0, now - arrival)

    def _observe(self, now: float, admitted: List[RequestOutput]) -> None:
        """Publish the queue-age gauge + admitted queue waits (no-op
        without a registry)."""
        if self.registry is None:
            return
        self.registry.gauge("serving_queue_age_seconds").set(
            self.oldest_age(now)
        )
        wait = self.registry.histogram("serving_queue_wait_seconds")
        for out in admitted:
            if out.arrival_time is not None:
                wait.observe(max(0.0, now - out.arrival_time))

    def submit(self, out: RequestOutput, requeue: bool = False) -> SubmitResult:
        """Enqueue; a falsy :class:`SubmitResult` carrying the typed reason
        when admission control refuses (queue full / draining).

        ``requeue=True`` marks accepted work being RELOCATED (the cluster
        frontend re-routing a draining or dead replica's queue) rather than
        new work — it bypasses the drain gate, never the queue bound.
        """
        cfg = self.config
        if self.draining and not requeue:
            return SubmitResult(REJECT_DRAINING)
        if cfg.max_queue is not None and len(self._queue) >= cfg.max_queue:
            return SubmitResult(REJECT_QUEUE_FULL)
        out.status = QUEUED
        self._queue.append(out)
        return SubmitResult.ACCEPTED

    def retune(
        self,
        max_prefills_per_tick: Optional[int] = None,
        max_queue: Optional[int] = None,
    ) -> SchedulerConfig:
        """Adjust admission policy knobs on a LIVE scheduler — the
        cluster autopilot's retuning hook.  Only the named knobs change
        (``max_queue`` cannot be retuned back to unbounded: None means
        "leave it alone"); the same validation as construction applies.
        Queued entries are untouched — a tightened ``max_queue`` below
        the current depth simply refuses new work until the queue drains
        under it.  Returns the new (frozen) config."""
        cfg = self.config
        if max_prefills_per_tick is not None:
            if max_prefills_per_tick < 1:
                raise ValueError(
                    f"max_prefills_per_tick={max_prefills_per_tick} < 1"
                )
            cfg = dataclasses.replace(
                cfg, max_prefills_per_tick=max_prefills_per_tick
            )
        if max_queue is not None:
            if max_queue < 0:
                raise ValueError(f"max_queue={max_queue} < 0")
            cfg = dataclasses.replace(cfg, max_queue=max_queue)
        self.config = cfg
        return cfg

    def begin_drain(self) -> None:
        """Close the admission gate: subsequent ``submit()`` calls reject
        with ``REJECT_DRAINING``; queued entries still schedule."""
        self.draining = True

    def take_queued(self) -> List[RequestOutput]:
        """Remove and return EVERY queued entry (FIFO order, status left
        QUEUED) — the drain/failover path that re-routes a replica's
        queued remainder to its peers."""
        taken = list(self._queue)
        self._queue.clear()
        return taken

    def remove(self, request_id: str) -> Optional[RequestOutput]:
        """Pull one queued entry by request id (cancellation before the
        request ever reached a slot); None when not queued here."""
        for out in self._queue:
            if out.request.request_id == request_id:
                self._queue.remove(out)
                return out
        return None

    def expire(self, now: Optional[float] = None) -> List[RequestOutput]:
        """Drop queued entries older than ``max_wait``; returns them."""
        if self.config.max_wait is None:
            return []
        if now is None:
            now = self.clock()
        expired = []
        kept = deque()
        for out in self._queue:
            arrival = out.arrival_time if out.arrival_time is not None else now
            waited = now - arrival
            if waited > self.config.max_wait:
                out.status = EXPIRED
                expired.append(out)
            else:
                kept.append(out)
        self._queue = kept
        return expired

    def schedule(
        self,
        n_free: int,
        now: Optional[float] = None,
        bucket_key: Optional[Callable[[RequestOutput], object]] = None,
        can_admit: Optional[Callable[[RequestOutput], bool]] = None,
    ) -> List[RequestOutput]:
        """Pop up to ``min(n_free, max_prefills_per_tick)`` admissions.

        ``now`` feeds the telemetry (queue-age gauge, admitted queue
        waits); FIFO ordering itself ignores it — priority policies
        would not.  ``can_admit`` (the paged engine's estimated-blocks
        gate) vetoes individual admissions beyond the free-slot count:
        a vetoed HEAD blocks the whole tick (head-of-line, FIFO-fair —
        blocks free up as running requests retire), a vetoed non-head
        candidate is kept in place while later same-bucket entries may
        still admit.  ``bucket_key`` (the engine's bucketed-prefill
        grouping) constrains
        the tick's admissions to ONE batchable group: the FIFO head always
        admits, and the rest of the budget fills with later queued entries
        sharing the head's key — those jump ahead of earlier entries in
        OTHER buckets (bounded unfairness: a request can be overtaken only
        while the head of the queue, which admits this tick regardless,
        shares a bucket with someone behind it).  The engine runs the
        returned set as one padded batched prefill call.  Chunked
        prompts are a group like any other, but WHICH group depends on
        the engine's tick model: the per-phase engine keys them
        uniquely (one chunk start per tick — each start is its own
        batch-1 dispatch), while the unified ragged tick keys them all
        ``("chunk",)`` so several long prompts claim slots in one tick
        and ride the same fixed-shape chunk-phase dispatch.
        """
        if now is None:
            now = self.clock()
        n = min(n_free, self.config.max_prefills_per_tick)
        if n <= 0 or not self._queue:
            self._observe(now, [])
            return []
        if bucket_key is None:
            admitted = []
            while n > 0 and self._queue:
                if can_admit is not None and not can_admit(self._queue[0]):
                    break  # head-of-line: wait for blocks to free up
                admitted.append(self._queue.popleft())
                n -= 1
            self._observe(now, admitted)
            return admitted
        if can_admit is not None and not can_admit(self._queue[0]):
            self._observe(now, [])
            return []
        head = self._queue.popleft()
        admitted, key = [head], bucket_key(head)
        kept = deque()
        for out in self._queue:
            if (
                len(admitted) < n
                and bucket_key(out) == key
                and (can_admit is None or can_admit(out))
            ):
                admitted.append(out)
            else:
                kept.append(out)
        self._queue = kept
        self._observe(now, admitted)
        return admitted
