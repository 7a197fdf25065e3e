"""The cluster frontend: one submit/step/drain surface over N replicas.

This is the piece that turns a pile of :class:`~tpu_parallel_torch.serving.
engine.ServingEngine` replicas into something a service can sit behind.
``submit()`` is the cluster's ONE admission gate; everything past it is
accepted work the frontend is responsible for finishing — on whichever
replica, after however many failures:

- **Admission control** (all typed, same ``finish_reason`` vocabulary as
  the engine): global token-budget backpressure (``token_budget`` — the
  sum of every open request's ``prompt + max_new_tokens`` reservation is
  capped, the scale-out generalization of the scheduler's ``max_queue``),
  per-client concurrency caps (``client_limit``), capacity (``capacity``)
  and the drain gate (``draining``).
- **Priority with aging**: dispatch order is effective priority =
  ``priority + waited / aging_seconds`` — higher classes go first, but
  every pending request gains one priority class per ``aging_seconds``
  waited, so a starving low-priority request provably overtakes any
  fixed-priority flood (the no-starvation test pins this).
- **Deadlines**: a request past ``deadline`` seconds from arrival is
  cancelled WHEREVER it is — pending here, queued in a replica, or
  holding a cache slot mid-decode (``ServingEngine.cancel`` releases the
  slot) — with a tokenless terminal event, because a reply the client
  stopped waiting for is pure wasted compute.
- **Fault-tolerant lifecycle**: a replica death (fault plan or real
  exception) orphans its queued AND running requests; each is re-routed
  with the dead replica excluded and its prompt FORCED-PREFIXED with the
  tokens already streamed (``prompt + delivered``), so the retry re-
  prefills exactly the context the dead replica had and greedy output is
  bitwise identical to a never-failed run — the stream just continues.
  Tokens are never re-streamed and never lost.  ``retry_limit`` bounds
  the replay of a request that keeps landing on dying replicas
  (``failed``/``retry_limit``), and a cluster dead BEYOND RECOVERY fails
  pending work loudly (``no_replica``) instead of queueing forever —
  while any restart is pending, pending work holds here instead, so a
  full-fleet flap doesn't fail every request.
- **Self-healing** (docs/12_cluster.md draws the state machine): a
  progress WATCHDOG marks a replica that has work but delivers nothing
  for ``watchdog_ticks`` cluster ticks DEGRADED, and after
  ``watchdog_kill_ticks`` declares it DEAD with its work orphaned
  through the normal forced-prefix replay — stalls are detected from
  observed behavior, never from the injection side.  Dead replicas with
  an ``engine_factory`` are rebuilt under a :class:`~tpu_parallel_torch.
  cluster.replica.RestartPolicy` circuit breaker: exponential backoff
  on the injectable clock (BACKOFF), then a half-open PROBATION window
  (bounded concurrent requests; ``probation_ticks`` clean ticks promote
  to HEALTHY; a probation death trips the breaker and doubles the
  backoff) until the budget (``max_restarts``) runs out.
- **Graceful drain**: ``drain()`` closes the admission gate, pulls every
  replica's QUEUED remainder back and re-routes it across live replicas
  (the queue stuck behind one busy engine redistributes), then ticks
  until all in-flight work finishes.  Every cache slot comes back free —
  the acceptance suite asserts slot counts and table alignment.

Observability: the frontend owns its own ``cluster_*`` metric namespace
(per-replica load/health gauges labeled by replica, typed rejection and
dispatch-reject counters, retry/requeue/cancel counters, a route-
imbalance histogram, TTFT/E2E latency histograms) and traces routing
decisions, deaths, retries and drains on a dedicated ``router`` tracer
track alongside the engines' per-slot tracks.  Engine registries stay
per-replica — their unlabeled ``serving_*`` series would collide across
replicas in one store.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Callable, Dict, List, Optional, Sequence, Union

from tpu_parallel_torch.cluster.autopilot import (
    Autopilot,
    AutopilotPolicy,
)
from tpu_parallel_torch.cluster.replica import (
    BACKOFF,
    DEAD,
    DEGRADED,
    HEALTHY,
    PROBATION,
    RETIRED,
    ReplicaDead,
    ReplicaHandle,
    RestartPolicy,
)
from tpu_parallel_torch.cluster.migration import (
    MIGRATE_IMPORTED,
    MIGRATION_STATUSES,
    capture_kv,
    install_kv,
    warm_start,
)
from tpu_parallel_torch.cluster.router import (
    PrefixAffinityRouter,
    Router,
    make_router,
)
from tpu_parallel_torch.cluster.swap import (
    SWAP_REFUSED_DRAINING,
    SWAP_REFUSED_FINGERPRINT,
    SWAP_REFUSED_IN_PROGRESS,
    SWAP_REFUSED_SHAPE,
    SWAP_REFUSED_VERSION,
    SWAP_TRACK,
    SwapController,
    SwapPolicy,
)
from tpu_parallel_torch.obs.registry import MetricRegistry
from tpu_parallel_torch.obs.tracer import NULL_TRACER, Tracer
from tpu_parallel_torch.serving.engine import ServingEngine, validate_same_shapes
from tpu_parallel_torch.serving.request import (
    CANCELLED,
    EXPIRED,
    FAILED,
    FINISHED,
    REJECT_CAPACITY,
    REJECT_CLIENT_LIMIT,
    REJECT_DRAINING,
    REJECT_SHED,
    REJECT_TOKEN_BUDGET,
    REJECTED,
    RUNNING,
    Request,
    RequestOutput,
    StreamEvent,
)

_HEALTH_CODE = {
    HEALTHY: 0.0,
    DEGRADED: 1.0,
    DEAD: 2.0,
    BACKOFF: 3.0,
    PROBATION: 4.0,
    RETIRED: 5.0,
}
# circuit-breaker state per replica: 0 = closed (serving), 1 = half-open
# (probation trickle), 2 = open (no traffic flows — dead / waiting out
# backoff / retired by the autopilot, which is benign but equally closed
# to traffic)
_BREAKER_CODE = {
    HEALTHY: 0.0,
    DEGRADED: 0.0,
    PROBATION: 1.0,
    BACKOFF: 2.0,
    DEAD: 2.0,
    RETIRED: 2.0,
}


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """Admission-control and retry policy knobs.

    - ``max_inflight_tokens``: global token-budget backpressure — the sum
      of ``len(prompt) + max_new_tokens`` over every OPEN request (from
      accept to terminal) may not exceed this; beyond it ``submit``
      rejects typed ``token_budget``.  None = unbounded.
    - ``max_per_client``: per-``client_id`` cap on open requests
      (requests without a ``client_id`` are uncapped).
    - ``aging_seconds``: a pending request gains one effective priority
      class per this many seconds waited — the anti-starvation dial
      (must be > 0; infinity-like values approximate strict priority).
    - ``retry_limit``: replica-death replays allowed per request before
      it fails with ``retry_limit``.
    - ``dispatch_queue_depth``: how deep a replica's engine queue the
      frontend will dispatch into (None = the replica's slot count).
      This is LATE BINDING, and priority depends on it: a request handed
      to an engine joins a FIFO the frontend can no longer reorder, so
      the frontend keeps just enough queued per replica to refill every
      slot and holds the rest HERE, where effective priority (with
      aging) re-sorts the backlog every tick.
    - ``watchdog_ticks`` / ``watchdog_kill_ticks``: the progress
      watchdog.  A replica that ``has_work()`` but makes NO observable
      progress (no stream events, no prefill advance) for
      ``watchdog_ticks`` consecutive cluster ticks is marked DEGRADED
      (drained of new routing while anything healthy exists); at
      ``watchdog_kill_ticks`` it is declared DEAD and its work replays
      elsewhere through the forced-prefix path — stall DETECTION from
      behavior alone, with zero help from the injection side.  None
      disables that threshold.  Progress clears the counter and restores
      a DEGRADED replica to HEALTHY.
    - ``restart``: the :class:`~tpu_parallel_torch.cluster.replica.
      RestartPolicy` circuit breaker (None = dead replicas stay dead).
      Only replicas carrying an ``engine_factory`` are ever restarted;
      backoff timing flows through the frontend's injectable clock.
    - ``warm_start_blocks``: KV blocks to pre-seed into a scale-up
      newcomer's prefix cache from the hottest radix chains of a live
      donor (``cluster/migration.py``; 0 disables).  A no-op unless the
      engines run the radix KV hierarchy — a cold cache is slow, not
      wrong, so warm start is always best-effort.
    """

    max_inflight_tokens: Optional[int] = None
    max_per_client: Optional[int] = None
    aging_seconds: float = 10.0
    retry_limit: int = 3
    dispatch_queue_depth: Optional[int] = None
    watchdog_ticks: Optional[int] = 10
    watchdog_kill_ticks: Optional[int] = 40
    restart: Optional[RestartPolicy] = dataclasses.field(
        default_factory=RestartPolicy
    )
    warm_start_blocks: int = 16

    def __post_init__(self):
        if self.aging_seconds <= 0:
            raise ValueError(f"aging_seconds={self.aging_seconds} <= 0")
        if self.retry_limit < 0:
            raise ValueError(f"retry_limit={self.retry_limit} < 0")
        if self.dispatch_queue_depth is not None and (
            self.dispatch_queue_depth < 1
        ):
            raise ValueError(
                f"dispatch_queue_depth={self.dispatch_queue_depth} < 1"
            )
        if self.watchdog_ticks is not None and self.watchdog_ticks < 1:
            raise ValueError(f"watchdog_ticks={self.watchdog_ticks} < 1")
        if self.watchdog_kill_ticks is not None:
            if self.watchdog_kill_ticks < 1:
                raise ValueError(
                    f"watchdog_kill_ticks={self.watchdog_kill_ticks} < 1"
                )
            if (
                self.watchdog_ticks is not None
                and self.watchdog_kill_ticks <= self.watchdog_ticks
            ):
                raise ValueError(
                    f"watchdog_kill_ticks={self.watchdog_kill_ticks} must "
                    f"exceed watchdog_ticks={self.watchdog_ticks} — a "
                    "replica must degrade before it is killed"
                )


@dataclasses.dataclass
class ClusterOutput(RequestOutput):
    """The client-visible record: a :class:`RequestOutput` whose tokens
    accumulate ACROSS replica attempts, plus the attempt history."""

    replicas: List[int] = dataclasses.field(default_factory=list)
    retries: int = 0


class _Recovery:
    """Frontend-internal self-healing state for one replica: the
    watchdog's stall counter, the circuit breaker's failure/attempt
    tallies, the pending restart deadline, and probation progress."""

    __slots__ = (
        "stall_ticks", "failures", "attempts", "clean_ticks",
        "restart_at", "probation",
    )

    def __init__(self):
        self.stall_ticks = 0  # consecutive no-progress ticks with work
        self.failures = 0  # consecutive deaths since the last promotion
        self.attempts = 0  # lifetime restart attempts (breaker budget)
        self.clean_ticks = 0  # exception-free ticks this probation
        self.restart_at: Optional[float] = None  # frontend-clock deadline
        self.probation = False  # currently half-open


class _ClientState:
    """Frontend-internal bookkeeping for one accepted request."""

    __slots__ = (
        "out", "seq", "budget", "excluded", "handle", "engine_rid", "base",
        "pinned_version", "kv_export",
    )

    def __init__(self, out: ClusterOutput, seq: int, budget: int):
        self.out = out
        self.seq = seq
        self.budget = budget  # reserved tokens (prompt + max_new)
        self.excluded: set = set()  # replica ids this request must avoid
        self.handle: Optional[ReplicaHandle] = None  # current attempt
        self.engine_rid: Optional[str] = None
        self.base = 0  # tokens delivered before the current attempt
        # the weight version that produced this request's FIRST token: a
        # stream must not straddle weight versions, so replays prefer
        # same-version replicas while any exist (rolling-swap hygiene)
        self.pinned_version: Optional[str] = None
        # KV blocks captured from the last relocation's source replica
        # (cluster/migration.py): installed into the next placement's
        # engine so the forced-prefix replay HITS instead of recomputing;
        # one-shot, cleared at the install attempt
        self.kv_export = None


class Frontend:
    """Replicated serving frontend (see the module docstring).

    ``replicas`` is a sequence of :class:`ReplicaHandle` (or bare
    :class:`ServingEngine`, wrapped with ids 0..N-1 and no fault plan).
    ``router`` is a policy name (``rr`` / ``least`` / ``prefix``) or a
    ready :class:`Router`; the prefix policy reads its bucket alignment
    from replica 0's engine.  ``clock`` is injectable — every timestamp
    in the frontend flows through it (no cluster/serving module reads
    wall time directly).
    """

    def __init__(
        self,
        replicas: Sequence[Union[ReplicaHandle, ServingEngine]],
        router: Union[str, Router] = "least",
        config: Optional[FrontendConfig] = None,
        clock: Callable[[], float] = time.monotonic,
        tracer: Optional[Tracer] = None,
        registry: Optional[MetricRegistry] = None,
    ):
        if not replicas:
            raise ValueError("Frontend needs at least one replica")
        handles: List[ReplicaHandle] = []
        for i, rep in enumerate(replicas):
            if isinstance(rep, ReplicaHandle):
                handles.append(rep)
            else:
                handles.append(ReplicaHandle(i, rep))
        ids = [h.replica_id for h in handles]
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate replica ids {ids}")
        self.replicas = sorted(handles, key=lambda h: h.replica_id)
        self.config = config or FrontendConfig()
        self.clock = clock
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.registry = registry if registry is not None else MetricRegistry()
        if isinstance(router, str):
            buckets = self.replicas[0].engine.prefill_buckets
            router = make_router(router, ids, buckets=buckets)
        self.router = router
        self.draining = False
        self._seq = itertools.count()
        self._pending: List[_ClientState] = []
        self._by_attempt: Dict[str, _ClientState] = {}
        self._reserved = 0  # open token-budget reservations
        self._events: List[StreamEvent] = []
        r = self.registry
        self._submitted = r.counter("cluster_submitted_total")
        self._finished = r.counter("cluster_finished_total")
        self._retries = r.counter("cluster_retries_total")
        self._requeued = r.counter("cluster_requeued_total")
        self._cancelled = r.counter("cluster_cancelled_total")
        # the ONE deadline-shed counter: every typed ``deadline``
        # terminal — tick-top sweep or pre-dispatch check alike — goes
        # through _shed_deadline and lands here exactly once
        self._deadline_sheds = r.counter("cluster_deadline_sheds_total")
        self._failed = r.counter("cluster_failed_total")
        self._deaths = r.counter("cluster_replica_deaths_total")
        self._watchdog_degraded = r.counter(
            "cluster_watchdog_degraded_total"
        )
        self._watchdog_kills = r.counter("cluster_watchdog_kills_total")
        self._restarts = r.counter("cluster_restarts_total")
        self._restart_failures = r.counter("cluster_restart_failures_total")
        self._promotions = r.counter("cluster_probation_promotions_total")
        self._demotions = r.counter("cluster_probation_demotions_total")
        self._recovery: Dict[int, _Recovery] = {
            h.replica_id: _Recovery() for h in self.replicas
        }
        self._imbalance = r.histogram("cluster_route_imbalance")
        self._ttft = r.histogram("cluster_ttft_seconds")
        self._e2e = r.histogram("cluster_e2e_seconds")
        self._by_id: Dict[int, ReplicaHandle] = {
            h.replica_id: h for h in self.replicas
        }
        # rolling weight hot-swap (cluster/swap.py): the in-flight (or
        # last finished) rollout, the fleet's post-swap standard weights
        # (restarting replicas rebind to them), and version ordinals for
        # the per-replica cluster_swap_version gauge
        self._swap: Optional[SwapController] = None
        self._fleet_weights: Optional[tuple] = None
        self._version_ordinals: Dict[str, int] = {"initial": 0}
        self._swap_seq = itertools.count(1)
        # SLO autopilot (cluster/autopilot.py): the closed overload-
        # control loop, plus the replicas it has scaled down (kept for
        # observability — a retired handle owns no work and never ticks)
        self._autopilot: Optional[Autopilot] = None
        self.retired: List[ReplicaHandle] = []
        # monotone id source for scale-ups: never reuse an id — not even
        # a retiree's, whose terminal gauge row and trace history a new
        # engine must not inherit
        self._next_replica_id = max(self._by_id) + 1
        # write-ahead journal hook (tpu_parallel_torch/daemon/): when set, the
        # frontend notifies it at the durability-relevant points —
        # accepted submissions, terminal events, drain begin, swap
        # begin, autopilot actions — so a daemon shell can journal every
        # state change it must survive.  None costs nothing.
        self._journal: Optional[Callable[[str, dict], None]] = None
        self._journal_ap_seen = 0  # autopilot actions already notified

    # -- journal hook ------------------------------------------------------

    def set_journal(self, sink: Optional[Callable[[str, dict], None]]) -> None:
        """Attach (or clear) the write-ahead journal hook: ``sink(kind,
        payload)`` fires at submit-accept / terminal / drain-begin /
        swap-begin and once per autopilot action.  The daemon shell is
        the intended consumer; the frontend never depends on it."""
        self._journal = sink

    def _journal_note(self, kind: str, **payload) -> None:
        if self._journal is not None:
            self._journal(kind, payload)

    # -- admission ---------------------------------------------------------

    @property
    def seq_len(self) -> int:
        return self.replicas[0].engine.model.config.seq_len

    def _open_states(self) -> List[_ClientState]:
        return self._pending + list(self._by_attempt.values())

    def submit(self, request: Request) -> ClusterOutput:
        """The cluster's admission gate.  Returns the live record; a
        REJECTED status carries the typed reason (``draining`` /
        ``capacity`` / ``client_limit`` / ``token_budget``)."""
        now = self.clock()
        out = ClusterOutput(request=request, arrival_time=now)
        self._submitted.inc()

        def reject(reason: str, detail: Optional[str] = None):
            out.status = REJECTED
            out.finish_reason = reason
            out.detail = detail
            self.registry.counter(
                "cluster_rejected_total", reason=reason
            ).inc()
            if self.tracer.enabled:
                self.tracer.instant(
                    "reject", track="router",
                    request_id=request.request_id, reason=reason,
                )
            return out

        if self.draining:
            return reject(REJECT_DRAINING)
        need = len(request.prompt) + request.max_new_tokens
        if need > self.seq_len:
            return reject(
                REJECT_CAPACITY,
                detail=(
                    f"prompt ({len(request.prompt)}) + max_new_tokens "
                    f"({request.max_new_tokens}) exceeds seq_len "
                    f"({self.seq_len})"
                ),
            )
        cfg = self.config
        if cfg.max_per_client is not None and request.client_id is not None:
            open_for_client = sum(
                1
                for st in self._open_states()
                if st.out.request.client_id == request.client_id
            )
            if open_for_client >= cfg.max_per_client:
                return reject(REJECT_CLIENT_LIMIT)
        if (
            cfg.max_inflight_tokens is not None
            and self._reserved + need > cfg.max_inflight_tokens
        ):
            return reject(REJECT_TOKEN_BUDGET)
        if self._autopilot is not None:
            # overload shedding: while the autopilot is past its SLO
            # targets, NEW lowest-effective-priority submissions are
            # refused typed (bounded by the policy's shed fraction)
            veto = self._autopilot.admission_veto(request, now)
            if veto is not None:
                return reject(REJECT_SHED)
        self._reserved += need
        self._pending.append(_ClientState(out, next(self._seq), need))
        self._journal_note(
            "submit_accepted", request_id=request.request_id,
            reserved_tokens=need,
        )
        return out

    # -- the tick ----------------------------------------------------------

    def step(self) -> List[StreamEvent]:
        """One cluster tick: fire due restarts, enforce deadlines,
        dispatch pending work through the router, tick every live
        replica (deaths collected and their work re-routed THIS tick,
        the progress watchdog fed from each replica's observed output),
        publish per-replica telemetry.  Returns the tick's cluster-level
        StreamEvents (client request ids, cluster token indices)."""
        now = self.clock()
        self._events = []
        self._service_restarts(now)
        if self._swap is not None and self._swap.active:
            # the rolling swap advances BEFORE dispatch so exclusions,
            # rebinds and canary promotions shape this tick's placement
            self._swap.tick(now)
        if self._autopilot is not None:
            # the autopilot senses and actuates before dispatch too, so
            # shed state, fleet size and retuned budgets shape this tick
            self._autopilot.tick(now)
            if self._journal is not None:
                acts = self._autopilot.actions
                for act in acts[self._journal_ap_seen:]:
                    self._journal_note(
                        "autopilot_action", kind=act.kind,
                        reason=act.reason, tick=act.tick,
                        detail=dict(act.detail),
                    )
                self._journal_ap_seen = len(acts)
        self._enforce_deadlines(now)
        self._dispatch(now)
        for handle in self.replicas:
            if handle.health in (DEAD, BACKOFF):
                continue
            # progress is judged from OBSERVED behavior only: stream
            # events out, or prefill work consumed (a mid-chunk tick
            # delivers no token yet clearly advances)
            had_work = handle.has_work()
            prefill_before = handle.pending_prefill_tokens
            try:
                events = handle.step()
            except ReplicaDead:
                self._on_death(handle)
                continue
            progressed = bool(events) or (
                handle.pending_prefill_tokens < prefill_before
            )
            if handle.health == PROBATION:
                self._probation_tick(handle, had_work, progressed)
            self._watchdog(handle, had_work, progressed)
        # re-place retries and bounced attempts without losing a tick
        self._dispatch(self.clock())
        # loud failure ONLY with the whole fleet dead beyond recovery: a
        # replica in backoff/probation (or rescheduled for restart) means
        # capacity is coming back, so pending work HOLDS in the frontend
        # queue instead of failing a full-fleet flap's every request
        if all(h.health == DEAD for h in self.replicas):
            for st in list(self._pending):
                self._pending.remove(st)
                self._finalize(st, FAILED, "no_replica", self.clock())
                self._failed.inc()
                self._emit_terminal(st, "no_replica")
        self._publish()
        events, self._events = self._events, []
        return events

    # -- self-healing ------------------------------------------------------

    def _handle(self, replica_id: int) -> ReplicaHandle:
        return self._by_id[replica_id]

    def _restartable(self, handle: ReplicaHandle) -> bool:
        """Whether the circuit breaker could ever revive this replica —
        a restart policy exists, the handle carries a factory, and the
        lifetime attempt budget is not exhausted."""
        policy = self.config.restart
        return (
            policy is not None
            and handle.engine_factory is not None
            and self._recovery[handle.replica_id].attempts
            < policy.max_restarts
        )

    def _service_restarts(self, now: float) -> None:
        """Fire every due restart: rebuild the engine through the
        handle's factory and enter PROBATION.  A factory failure counts
        against the breaker budget and doubles the backoff; an exhausted
        budget leaves the replica DEAD (breaker open for good)."""
        policy = self.config.restart
        if policy is None:
            return
        for handle in self.replicas:
            if handle.health != BACKOFF:
                continue
            rec = self._recovery[handle.replica_id]
            if rec.restart_at is None or now < rec.restart_at:
                continue
            rec.restart_at = None
            rec.attempts += 1
            try:
                handle.restart()
            except Exception as exc:
                self._restart_failures.inc()
                rec.failures += 1
                if self.tracer.enabled:
                    self.tracer.instant(
                        "restart_failed", track="router",
                        replica=handle.replica_id, error=repr(exc),
                    )
                if rec.attempts < policy.max_restarts:
                    rec.restart_at = now + policy.delay(rec.failures)
                else:
                    handle.health = DEAD  # breaker open for good
                continue
            # version reconciliation: the factory rebuilds with the
            # weights the cluster was BORN with, but a completed hot
            # swap made a newer set the fleet standard — rebind the
            # fresh (idle) engine before it takes probation traffic, so
            # a post-swap restart can never resurrect the old version
            if self._fleet_weights is not None:
                ver, params = self._fleet_weights
                if handle.weights_version != ver:
                    handle.engine.rebind_params(params, version=ver)
                    if self.tracer.enabled:
                        self.tracer.instant(
                            "swap_rebind_on_restart", track=SWAP_TRACK,
                            replica=handle.replica_id, version=ver,
                        )
            rec.clean_ticks = 0
            rec.stall_ticks = 0
            rec.probation = True
            self._restarts.inc()
            if self.tracer.enabled:
                self.tracer.instant(
                    "restart", track="router", replica=handle.replica_id,
                    attempt=rec.attempts,
                )
            # the fresh engine owes nothing to old exclusions: requests
            # orphaned by the PREVIOUS incarnation may run here again
            # (without this, a 1-replica cluster could never self-heal)
            for st in self._open_states():
                st.excluded.discard(handle.replica_id)

    def _probation_tick(
        self, handle: ReplicaHandle, had_work: bool, progressed: bool
    ) -> None:
        policy = self.config.restart
        rec = self._recovery[handle.replica_id]
        if had_work and not progressed:
            # a stall-suspect tick proves nothing: freeze the clean
            # count and let the watchdog judge the replica — a wedged
            # restart must never be promoted (which would also reset
            # the breaker's failure count and defeat backoff escalation)
            return
        rec.clean_ticks += 1
        if self._swap is not None and self._swap.gates_probation(handle):
            # the swap canary (and any replica awaiting rollback) is
            # promoted by the SwapPolicy, not the generic probation
            # clock — clean ticks still accrue for the canary gate
            return
        if policy is not None and rec.clean_ticks >= policy.probation_ticks:
            handle.health = HEALTHY
            rec.probation = False
            rec.failures = 0  # proved itself: earn back fast restarts
            self._promotions.inc()
            if self.tracer.enabled:
                self.tracer.instant(
                    "probation_promote", track="router",
                    replica=handle.replica_id,
                    clean_ticks=rec.clean_ticks,
                )

    def _watchdog(
        self, handle: ReplicaHandle, had_work: bool, progressed: bool
    ) -> None:
        """Observed-progress stall detection: a replica with work that
        produced nothing this tick accrues stall ticks; enough of them
        degrade it (drained of new routing) and then kill it (work
        orphaned through the normal death path).  Any progress clears
        the counter and restores a DEGRADED replica."""
        cfg = self.config
        if cfg.watchdog_ticks is None and cfg.watchdog_kill_ticks is None:
            return
        rec = self._recovery[handle.replica_id]
        if progressed or not had_work:
            rec.stall_ticks = 0
            if handle.health == DEGRADED:
                handle.health = HEALTHY
                if self.tracer.enabled:
                    self.tracer.instant(
                        "watchdog_recovered", track="router",
                        replica=handle.replica_id,
                    )
            return
        rec.stall_ticks += 1
        kill = cfg.watchdog_kill_ticks
        warn = cfg.watchdog_ticks
        if kill is not None and rec.stall_ticks >= kill:
            self._watchdog_kills.inc()
            if self.tracer.enabled:
                self.tracer.instant(
                    "watchdog_kill", track="router",
                    replica=handle.replica_id,
                    stalled_ticks=rec.stall_ticks,
                )
            handle.kill(
                f"watchdog: no progress for {rec.stall_ticks} ticks"
            )
            self._on_death(handle)
        elif (
            warn is not None
            and rec.stall_ticks >= warn
            and handle.health == HEALTHY
        ):
            handle.health = DEGRADED
            self._watchdog_degraded.inc()
            if self.tracer.enabled:
                self.tracer.instant(
                    "watchdog_degraded", track="router",
                    replica=handle.replica_id,
                    stalled_ticks=rec.stall_ticks,
                )

    def has_work(self) -> bool:
        return bool(self._pending) or bool(self._by_attempt)

    def run(self, max_ticks: Optional[int] = None) -> List[StreamEvent]:
        """Tick until every accepted request is terminal (or ``max_ticks``)."""
        events: List[StreamEvent] = []
        ticks = 0
        while self.has_work() and (max_ticks is None or ticks < max_ticks):
            events.extend(self.step())
            ticks += 1
        return events

    def drain(self, max_ticks: Optional[int] = None) -> List[StreamEvent]:
        """Graceful shutdown: stop admitting (typed ``draining``
        rejections), gate every live engine, pull the engines' queued
        remainders back and re-route them across live replicas, then run
        to completion.  On return every accepted request is terminal and
        every replica's cache pool is fully released."""
        self.draining = True
        self._journal_note("drain_begin")
        span = (
            self.tracer.span("drain", track="router")
            if self.tracer.enabled
            else None
        )
        for handle in self.replicas:
            if handle.health in (DEAD, BACKOFF):
                continue
            handle.engine.begin_drain()
        for handle in self.replicas:
            if handle.health in (DEAD, BACKOFF):
                continue
            self._pull_back_queued(handle)
        events = self.run(max_ticks)
        if span is not None:
            span.finish(requeued=int(self._requeued.value))
        return events

    # -- rolling weight hot-swap -------------------------------------------

    def begin_swap(
        self,
        checkpoint_dir: Optional[str] = None,
        step: Optional[int] = None,
        *,
        params=None,
        version: Optional[str] = None,
        policy: Optional[SwapPolicy] = None,
    ) -> dict:
        """Start a zero-downtime rolling weight swap (cluster/swap.py —
        the module docstring and docs/12 describe the state machine).

        Pass either a ``checkpoint_dir`` (+ optional ``step``) written by
        :func:`~tpu_parallel_torch.checkpoint.io.save_serving_weights` — the
        manifest supplies the version and the load is fingerprint-
        verified — or an in-memory ``params`` tree with a ``version``
        string.  Returns the swap status dict (see :meth:`swap_status`);
        a REFUSED swap carries the typed reason in ``verdict``:
        ``draining`` (mid-drain fleets don't take new weights),
        ``swap_in_progress`` (one rollout at a time),
        ``fingerprint_mismatch`` (checkpoint failed its manifest audit),
        ``shape_mismatch`` (not a same-shape weight set) or
        ``version_in_service`` (the version id is already live — a
        rollback could never tell old from new).
        """

        def refuse(reason: str, detail: Optional[str] = None) -> dict:
            self.registry.counter(
                "cluster_swap_refused_total", reason=reason
            ).inc()
            if self.tracer.enabled:
                self.tracer.instant(
                    "swap_refused", track=SWAP_TRACK, reason=reason,
                )
            return {"state": "refused", "verdict": reason, "detail": detail}

        if self.draining:
            return refuse(SWAP_REFUSED_DRAINING)
        if self._swap is not None and self._swap.active:
            return refuse(SWAP_REFUSED_IN_PROGRESS)
        if checkpoint_dir is not None:
            from tpu_parallel_torch.checkpoint.io import (
                WeightsCorrupt,
                load_serving_weights,
            )
            from tpu_parallel_torch.models.convert import params_from_jax

            try:
                tree, manifest = load_serving_weights(
                    checkpoint_dir, step=step,
                )
            except WeightsCorrupt as exc:
                return refuse(SWAP_REFUSED_FINGERPRINT, detail=str(exc))
            # a serving weight set is the JAX layout's tree (its digest is
            # JAX's): the served state dict takes the model's names, and
            # each tensor the served one's dtype and device
            engine = self.replicas[0].engine
            served = engine.params
            try:
                params = {
                    name: t.to(
                        dtype=served[name].dtype, device=served[name].device
                    )
                    for name, t in params_from_jax(
                        tree, engine.model.config
                    ).items()
                }
            except (KeyError, ValueError) as exc:
                return refuse(SWAP_REFUSED_SHAPE, detail=str(exc))
            if version is None:
                version = manifest.version
        if params is None:
            raise ValueError(
                "begin_swap needs params=... or a checkpoint_dir"
            )
        if version is None:
            version = f"swap-{next(self._swap_seq)}"
        if any(h.weights_version == version for h in self.replicas):
            return refuse(
                SWAP_REFUSED_VERSION,
                detail=f"version {version!r} is already serving",
            )
        try:
            validate_same_shapes(self.replicas[0].engine.params, params)
        except ValueError as exc:
            return refuse(SWAP_REFUSED_SHAPE, detail=str(exc))
        self._version_ordinals.setdefault(
            version, len(self._version_ordinals)
        )
        self._swap = SwapController(
            self, params, version, policy or SwapPolicy()
        )
        self._journal_note(
            "swap_begin", version=version, replicas=len(self.replicas)
        )
        if self.tracer.enabled:
            self.tracer.instant(
                "swap_begin", track=SWAP_TRACK, version=version,
                replicas=len(self.replicas),
            )
        return self._swap.status_dict()

    def swap_status(self) -> dict:
        """The current (or last finished) rollout's typed status:
        ``state`` (``idle`` / ``rolling`` / ``rolling_back`` /
        ``completed`` / ``rolled_back``), the typed ``verdict``
        (``completed``, or the rollback reason — ``canary_death`` /
        ``slo_ttft`` / ``slo_e2e`` / ``logit_fingerprint``), per-replica
        phases and weight versions, and the canary-vs-baseline latency
        window means."""
        if self._swap is None:
            return {
                "state": "idle",
                "verdict": None,
                "replica_versions": {
                    h.replica_id: h.weights_version for h in self.replicas
                },
            }
        return self._swap.status_dict()

    # -- SLO autopilot (cluster/autopilot.py) -------------------------------

    def enable_autopilot(
        self,
        policy: Optional[AutopilotPolicy] = None,
        engine_factory=None,
        role_controller=None,
    ) -> Autopilot:
        """Arm the closed-loop overload controller: once per ``step()``
        it senses the queue-age/TTFT windows and actuates bounded shed /
        scale / retune moves (the module docstring of ``cluster/
        autopilot.py`` is the full story).  ``engine_factory`` builds
        the engines scale-up adds (default: the first replica's own
        factory).  Returns the controller; ``autopilot_status()`` and
        ``summary()`` expose its state.

        The default policy (``policy=None``) is SHED-ONLY, anchored to
        the current fleet: ``max_replicas == min_replicas == len(
        replicas)`` and scale-down disabled — arming the controller for
        graceful degradation must never quietly resize a fleet the
        operator sized by hand.  Scaling is opt-in via an explicit
        policy.  ``role_controller`` (a FleetRouter, or anything with
        its role surface) arms the re-role lever — None leaves the
        fleet's prefill:decode ratio alone."""
        if self._autopilot is not None:
            raise RuntimeError("autopilot already enabled")
        if policy is None:
            policy = AutopilotPolicy(
                max_replicas=len(self.replicas),
                min_replicas=len(self.replicas),
                scale_down_idle_ticks=None,
            )
        self._autopilot = Autopilot(
            self, policy, engine_factory, role_controller=role_controller,
        )
        return self._autopilot

    def autopilot_status(self) -> dict:
        """The controller's typed state (``{"enabled": False}`` when no
        autopilot is armed)."""
        if self._autopilot is None:
            return {"enabled": False}
        return self._autopilot.status()

    def _add_replica(self, engine_factory) -> ReplicaHandle:
        """Scale-up actuator: build a fresh engine, wrap it under the
        next free replica id, and enter it through the SAME half-open
        probation gate a restarted replica uses — a new replica proves
        itself on a bounded trickle before taking full traffic.  After
        a completed swap the newcomer is rebound to the fleet-standard
        weights first, so scale-up can never resurrect an old version."""
        rid = self._next_replica_id
        self._next_replica_id += 1
        handle = ReplicaHandle(
            rid, engine_factory(), engine_factory=engine_factory
        )
        if self._fleet_weights is not None:
            ver, params = self._fleet_weights
            if handle.weights_version != ver:
                handle.engine.rebind_params(params, version=ver)
        rec = _Recovery()
        if self.config.restart is not None:
            handle.health = PROBATION
            rec.probation = True
        else:
            # no RestartPolicy = no probation machinery to promote out
            # of — enter HEALTHY rather than strand the newcomer
            # half-open forever (it could then never idle-retire either)
            handle.health = HEALTHY
        if self.config.warm_start_blocks > 0:
            # pre-seed the newcomer's prefix cache from the hottest
            # radix chains of the busiest live donor: rebalanced traffic
            # then hits immediately instead of re-prefilling every hot
            # tenant header (no-op without the radix hierarchy)
            donor, best = None, 0
            for h in self.replicas:
                if h.health in (DEAD, BACKOFF):
                    continue
                radix = getattr(h.engine, "_radix", None)
                if radix is not None and radix.device_blocks > best:
                    donor, best = h, radix.device_blocks
            if donor is not None:
                handle.kv_warm_blocks = warm_start(
                    donor, handle, self.config.warm_start_blocks
                )
                if handle.kv_warm_blocks:
                    self.registry.counter(
                        "cluster_kv_warm_start_blocks_total"
                    ).inc(handle.kv_warm_blocks)
                    if self.tracer.enabled:
                        self.tracer.instant(
                            "kv_warm_start", track="router", replica=rid,
                            donor=donor.replica_id,
                            blocks=handle.kv_warm_blocks,
                        )
        self.replicas.append(handle)
        self.replicas.sort(key=lambda h: h.replica_id)
        self._by_id[rid] = handle
        self._recovery[rid] = rec
        if isinstance(self.router, PrefixAffinityRouter):
            self.router.add_replica(rid)
        self.registry.counter("cluster_scale_ups_total").inc()
        if self.tracer.enabled:
            self.tracer.instant(
                "scale_up", track="router", replica=rid,
                replicas=len(self.replicas),
            )
        return handle

    def _retire_replica(self, handle: ReplicaHandle) -> None:
        """Scale-down actuator: retire one IDLE replica through the
        existing drain machinery — the engine's gate closes, the (empty)
        queued remainder relocates, and the handle leaves the fleet for
        the ``retired`` list.  Nothing orphans and nothing replays: the
        idle precondition is the whole point of ``scale_down_idle_ticks``."""
        self._pull_back_queued(handle)  # belt and braces: idle = empty
        handle.retire()
        rid = handle.replica_id
        self.replicas = [h for h in self.replicas if h.replica_id != rid]
        self._by_id.pop(rid, None)
        self._recovery.pop(rid, None)
        self.retired.append(handle)
        if isinstance(self.router, PrefixAffinityRouter):
            self.router.remove_replica(rid)
        # final gauge row: the retired replica stops publishing, so pin
        # its last health/load values to the terminal state
        lab = {"replica": rid}
        self.registry.gauge("cluster_replica_health", **lab).set(
            _HEALTH_CODE[RETIRED]
        )
        self.registry.gauge("cluster_breaker_state", **lab).set(
            _BREAKER_CODE[RETIRED]
        )
        self.registry.gauge("cluster_replica_load", **lab).set(0.0)
        self.registry.counter("cluster_scale_downs_total").inc()
        if self.tracer.enabled:
            self.tracer.instant(
                "scale_down", track="router", replica=rid,
                replicas=len(self.replicas),
            )

    def _capture_relocation_kv(
        self, st: "_ClientState", handle: ReplicaHandle, engine_rid: str
    ) -> None:
        """Capture an attempt's written KV blocks from a LIVE source
        replica before a relocation cancels its slot (the cancel frees
        the blocks) — the export half of cross-replica KV migration.
        Best effort: None leaves the replay on the proven recompute
        path.  Crash replay never reaches here by design — a dead
        engine's state must not be read."""
        export = capture_kv(handle, engine_rid)
        if export is None:
            return
        st.kv_export = export
        self.registry.counter("cluster_kv_exports_total").inc()
        if self.tracer.enabled:
            self.tracer.instant(
                "kv_export", track="router",
                request_id=st.out.request.request_id,
                replica=handle.replica_id, blocks=export.n_blocks,
            )

    def _pull_back_queued(self, handle: ReplicaHandle) -> int:
        """Pull ``handle``'s engine-queued remainder back into the
        frontend backlog — the ONE relocation-of-queued-work move drain
        and the swap rollout's exclusion/revert phases all share (queued
        work has no replica or weight-version stake yet).  Returns how
        many requests moved."""
        moved = 0
        for eout in handle.take_queued():
            st = self._by_attempt.pop(eout.request.request_id, None)
            self.tracer.release_trace(eout.request.request_id)
            if st is None or st.out.done:
                continue
            st.handle = None
            st.engine_rid = None
            self._requeued.inc()
            self._pending.append(st)
            moved += 1
        return moved

    def cancel(self, request_id: str, reason: str = "cancelled") -> bool:
        """Client-initiated cancellation by CLUSTER request id — pending,
        queued-in-replica, or mid-decode alike.  False if unknown/done."""
        for st in self._open_states():
            if st.out.request.request_id == request_id and not st.out.done:
                self._cancel_state(st, reason, self.clock())
                return True
        return False

    def export_request_kv(self, request_id: str):
        """Export ONE live request's written KV prefix from whichever
        replica currently decodes it (by CLUSTER request id) — the donor
        half of the fleet's prefill→decode handoff.  Only the frontend
        can translate the client id into the attempt-scoped engine id
        (``rid@attempt``), so this is the one seam the daemon shell gets.
        None when the request is unknown, finished, still pending, or
        its engine holds no full exportable block."""
        for st in self._by_attempt.values():
            if st.out.request.request_id != request_id or st.out.done:
                continue
            if st.handle is None or st.engine_rid is None:
                return None
            exporter = getattr(st.handle.engine, "export_prefix", None)
            if exporter is None:
                return None
            return exporter(st.engine_rid)
        return None

    # -- dispatch ----------------------------------------------------------

    def _dispatch_depth(self, handle: ReplicaHandle) -> int:
        """Per-replica dispatch bound (see ``dispatch_queue_depth``)."""
        if self.config.dispatch_queue_depth is not None:
            return self.config.dispatch_queue_depth
        return handle.engine.pool.n_slots

    def _probation_headroom(self, handle: ReplicaHandle) -> bool:
        """A half-open replica takes at most ``probation_requests``
        concurrent open requests — enough traffic to prove the rebuilt
        engine, little enough that a relapse orphans almost nothing."""
        if handle.health != PROBATION:
            return True
        policy = self.config.restart
        if policy is None:
            return True
        return handle.open_requests < policy.probation_requests

    def _effective_priority(self, st: _ClientState, now: float) -> float:
        arrival = st.out.arrival_time
        waited = max(0.0, now - arrival) if arrival is not None else 0.0
        return st.out.request.priority + waited / self.config.aging_seconds

    def _dispatch(self, now: float) -> None:
        if not self._pending:
            return
        order = sorted(
            self._pending,
            key=lambda st: (-self._effective_priority(st, now), st.seq),
        )
        leftover = []
        for st in order:
            # pre-dispatch deadline shed: a request whose deadline
            # expired while it waited here must not be handed to an
            # engine — the prefill would be pure waste, and the engine
            # would only hand it back for the in-flight cancel next
            # tick.  (The tick-top _enforce_deadlines pass runs on the
            # tick's FIRST clock read; the post-step re-dispatch reads a
            # fresh clock, so a deadline can expire between the two.)
            deadline = st.out.request.deadline
            if (
                deadline is not None
                and st.out.arrival_time is not None
                and now - st.out.arrival_time > deadline
            ):
                self._shed_deadline(st, now)
                continue
            if not self._try_place(st, now):
                leftover.append(st)
        self._pending = leftover

    def _try_place(self, st: _ClientState, now: float) -> bool:
        """Route one pending request: the policy picks among routable
        candidates (healthy preferred over degraded, exclusions and
        non-accepting replicas filtered), synchronous engine rejections
        (queue_full) exclude that replica FOR THIS PASS and re-route.
        False leaves the request pending for the next tick."""
        req = st.out.request
        tried: set = set()
        swap = self._swap
        while True:
            cands = [
                h
                for h in self.replicas
                if h.routable
                and h.queue_depth < self._dispatch_depth(h)
                and h.replica_id not in st.excluded
                and h.replica_id not in tried
                and self._probation_headroom(h)
                # rolling swap: the current target is drained of NEW
                # placement; during a rollback every replica still on
                # the abandoned version is off limits
                and not h.swap_excluded
                and (swap is None or not swap.blocked(h))
            ]
            if st.pinned_version is not None:
                # a stream must finish on the weight version that
                # started it: prefer same-version replicas, fall back
                # only when none exist anywhere (counted at the actual
                # dispatch below, once per placement, not per pass)
                same = [
                    h for h in cands
                    if h.weights_version == st.pinned_version
                ]
                if same:
                    cands = same
            # healthy first; a PROBATION replica takes its half-open
            # trickle alongside them (that's how it proves itself);
            # DEGRADED only when nothing else is placeable
            preferred = [
                h for h in cands if h.health in (HEALTHY, PROBATION)
            ]
            cands = preferred or cands
            pick = self.router.route(req.prompt, cands)
            if pick is None:
                return False
            loads = [h.load() for h in cands]
            self._imbalance.observe(pick.load() - min(loads))
            ereq = self._attempt_request(st)
            # engine spans carry the ATTEMPT id (rid@N), not the cluster
            # rid the daemon bound its trace under — alias the attempt
            # to the same context BEFORE the engine admission records
            # its queue span, and release wherever the attempt retires
            ctx = self.tracer.trace_of(req.request_id)
            if ctx is not None:
                self.tracer.bind_trace(ereq.request_id, ctx)
            # requeue=True: frontend-accepted work being PLACED is not a
            # new admission from the engine's point of view — the drain
            # gate guards direct engine submissions, the frontend's gate
            # already guarded this one
            eout = pick.submit(
                ereq, requeue=True, arrival_time=st.out.arrival_time
            )
            if eout.done:  # synchronous engine rejection (queue_full)
                self.tracer.release_trace(ereq.request_id)
                self.registry.counter(
                    "cluster_dispatch_rejects_total",
                    reason=eout.finish_reason or "unknown",
                ).inc()
                if self.tracer.enabled:
                    self.tracer.instant(
                        "dispatch_reject", track="router",
                        request_id=req.request_id,
                        replica=pick.replica_id,
                        reason=eout.finish_reason,
                    )
                tried.add(pick.replica_id)
                continue
            if isinstance(self.router, PrefixAffinityRouter):
                # the router counts overload fallbacks it decides itself;
                # spills it never SAW — the hash-owner filtered out of
                # the candidate list by the dispatch bound, an exclusion
                # or death — are counted here, so the fallback gauge is
                # meaningful under the frontend's pre-filtering too
                owner = self.router.owner(req.prompt)
                if owner != pick.replica_id and owner not in {
                    c.replica_id for c in cands
                }:
                    self.router.fallbacks += 1
            if (
                st.pinned_version is not None
                and st.out.tokens
                and pick.weights_version != st.pinned_version
            ):
                # the one case a stream crosses weight versions: a
                # mid-stream replay found NO replica on its pinned
                # version — counted per actual placement
                self.registry.counter(
                    "cluster_swap_version_fallbacks_total"
                ).inc()
            st.handle = pick
            st.engine_rid = ereq.request_id
            st.out.replicas.append(pick.replica_id)
            self._by_attempt[ereq.request_id] = st
            if st.kv_export is not None:
                # relocated KV rides along: land the captured blocks in
                # the target's prefix cache BEFORE the engine's admission
                # tick, so the forced-prefix replay hits and ships blocks
                # instead of recomputing; every verdict is typed and
                # counted — recompute survives only as observable fallback
                verdict = install_kv(pick, st.kv_export)
                self.registry.counter(
                    "cluster_kv_migrations_total", status=verdict
                ).inc()
                if verdict == MIGRATE_IMPORTED:
                    self.registry.counter(
                        "cluster_kv_migrated_blocks_total"
                    ).inc(st.kv_export.n_blocks)
                if self.tracer.enabled:
                    self.tracer.instant(
                        "kv_migrate", track="router",
                        request_id=req.request_id,
                        replica=pick.replica_id, status=verdict,
                        blocks=st.kv_export.n_blocks,
                    )
                st.kv_export = None
            self.registry.counter(
                "cluster_dispatched_total", replica=pick.replica_id
            ).inc()
            if self.tracer.enabled:
                self.tracer.instant(
                    "route", track="router", request_id=req.request_id,
                    replica=pick.replica_id, policy=self.router.name,
                    attempt=len(st.out.replicas),
                )
            return True

    def _attempt_request(self, st: _ClientState) -> Request:
        """Build the engine-level request for the next attempt: the
        prompt is FORCED-PREFIXED with every token already delivered, so
        a replay re-prefills exactly the context the previous replica
        held and the stream continues bit-for-bit (greedy) where it
        stopped.  The attempt's budget is the REMAINDER, so engine-side
        length retirement equals cluster-side length retirement."""
        req = st.out.request
        st.base = len(st.out.tokens)
        return Request(
            prompt=list(req.prompt) + list(st.out.tokens),
            max_new_tokens=req.max_new_tokens - st.base,
            sampling=req.sampling,
            eos_token_id=req.eos_token_id,
            request_id=f"{req.request_id}@{len(st.out.replicas)}",
            draft_tokens=req.draft_tokens,
            on_token=self._make_on_token(st),
        )

    def _make_on_token(self, st: _ClientState):
        def on_token(ev: StreamEvent) -> None:
            if st.out.done:
                return  # frontend already finalized (cancel/deadline)
            if ev.token < 0:
                # attempt-level terminal notification without a token
                # (engine queue expiry): the attempt died before
                # producing.  Each bounce COUNTS AGAINST retry_limit —
                # the retry preserves the original arrival, so on an
                # engine whose max_wait the request has already blown it
                # would expire again every tick, forever.  Past the
                # limit the request terminates EXPIRED instead of
                # livelocking run()/drain().
                if st.handle is None:
                    return
                self._by_attempt.pop(st.engine_rid, None)
                if st.engine_rid is not None:
                    self.tracer.release_trace(st.engine_rid)
                st.handle = None
                st.engine_rid = None
                st.out.retries += 1
                self._retries.inc()
                if st.out.retries > self.config.retry_limit:
                    self._finalize(st, EXPIRED, "max_wait", self.clock())
                    self._emit_terminal(st, "max_wait")
                    return
                self._requeued.inc()
                self._pending.append(st)
                return
            now = self.clock()
            index = st.base + ev.index
            if st.out.first_token_time is None:
                st.out.first_token_time = now
            if st.pinned_version is None and st.handle is not None:
                # first token: the stream is now committed to this
                # weight version (replays prefer same-version replicas)
                st.pinned_version = st.handle.weights_version
            st.out.status = RUNNING
            st.out.tokens.append(ev.token)
            st.out.token_times.append(now)
            cev = StreamEvent(
                request_id=st.out.request.request_id,
                token=ev.token,
                index=index,
                finished=ev.finished,
                finish_reason=ev.finish_reason,
            )
            if ev.finished:
                if self._swap is not None and self._swap.active:
                    # canary-window accounting + spot-check candidate
                    # capture (needs st.handle, so before _finalize)
                    self._swap.note_finish(st, now)
                self._finalize(st, FINISHED, ev.finish_reason, now)
                self._finished.inc()
                if st.out.ttft is not None:
                    self._ttft.observe(st.out.ttft)
                self._e2e.observe(now - st.out.arrival_time)
            self._events.append(cev)
            if st.out.request.on_token is not None:
                st.out.request.on_token(cev)

        return on_token

    # -- failure / cancellation -------------------------------------------

    def _on_death(self, handle: ReplicaHandle) -> None:
        """A replica died mid-tick (engine exception, fault plan, or
        watchdog kill — they all count against the same retry budget):
        exclude it for every orphaned request and replay each
        (forced-prefix) elsewhere; requests out of retries fail loudly.
        Each orphan is also FORGOTTEN from the handle's ledger — the
        replay is now the frontend's responsibility, and a later restart
        of this replica must not find stale orphans to double-replay.
        Finally the circuit breaker decides whether a restart is
        scheduled (BACKOFF) or the replica stays DEAD."""
        now = self.clock()
        self._deaths.inc()
        if self.tracer.enabled:
            self.tracer.instant(
                "replica_death", track="router", replica=handle.replica_id,
                orphans=len(handle.orphans()),
            )
        for eout in handle.orphans():
            handle.forget(eout.request.request_id)
            st = self._by_attempt.pop(eout.request.request_id, None)
            self.tracer.release_trace(eout.request.request_id)
            if st is None or st.out.done:
                continue
            st.excluded.add(handle.replica_id)
            st.handle = None
            st.engine_rid = None
            st.out.retries += 1
            self._retries.inc()
            if st.out.retries > self.config.retry_limit:
                self._finalize(st, FAILED, "retry_limit", now)
                self._failed.inc()
                self._emit_terminal(st, "retry_limit")
                continue
            if self.tracer.enabled:
                self.tracer.instant(
                    "retry", track="router",
                    request_id=st.out.request.request_id,
                    from_replica=handle.replica_id,
                    delivered=len(st.out.tokens),
                )
            self._pending.append(st)
        # circuit breaker: consecutive failures stretch the backoff; a
        # death during probation is the classic breaker trip (the replica
        # failed its audition) and doubles the next wait
        rec = self._recovery[handle.replica_id]
        rec.failures += 1
        rec.clean_ticks = 0
        rec.stall_ticks = 0
        if rec.probation:
            rec.probation = False
            self._demotions.inc()
            if self.tracer.enabled:
                self.tracer.instant(
                    "probation_demote", track="router",
                    replica=handle.replica_id,
                )
        policy = self.config.restart
        if self._restartable(handle):
            delay = policy.delay(rec.failures)
            handle.health = BACKOFF
            rec.restart_at = now + delay
            if self.tracer.enabled:
                self.tracer.instant(
                    "restart_scheduled", track="router",
                    replica=handle.replica_id, delay=delay,
                    failures=rec.failures,
                )
        if self._swap is not None and self._swap.active:
            # the rollout reacts AFTER the breaker decided: a dead
            # canary triggers rollback, a dead target defers, a dead
            # promoted replica re-queues (its restart resurrects the
            # old weights and must be swapped again)
            self._swap.on_death(handle.replica_id)

    def _enforce_deadlines(self, now: float) -> None:
        for st in self._open_states():
            deadline = st.out.request.deadline
            if deadline is None or st.out.done:
                continue
            if now - st.out.arrival_time > deadline:
                self._shed_deadline(st, now)

    def _shed_deadline(self, st: _ClientState, now: float) -> None:
        """The ONE deadline-expiry terminal: both sweeps — the tick-top
        ``_enforce_deadlines`` pass and the pre-dispatch check (whose
        fresh clock read can observe an expiry BETWEEN the two passes) —
        shed through here, so every deadline miss is one typed
        ``deadline`` cancel counted once on one counter, wherever in the
        tick it was caught."""
        self._deadline_sheds.inc()
        self._cancel_state(st, "deadline", now)

    def _cancel_state(self, st: _ClientState, reason: str, now: float) -> None:
        """Cancel wherever the request is.  Finalizes the cluster record
        FIRST so the engine's own cancel notification no-ops in the
        attempt callback, then releases any in-engine work (slot freed)."""
        handle, engine_rid = st.handle, st.engine_rid
        if st in self._pending:
            self._pending.remove(st)
        self._finalize(st, CANCELLED, reason, now)
        if handle is not None and handle.health not in (DEAD, BACKOFF):
            handle.engine.cancel(engine_rid, reason=reason)
            handle.forget(engine_rid)
        self._cancelled.inc()
        if self.tracer.enabled:
            self.tracer.instant(
                "cancel", track="router",
                request_id=st.out.request.request_id, reason=reason,
            )
        self._emit_terminal(st, reason)

    def _finalize(
        self, st: _ClientState, status: str, reason: Optional[str], now: float
    ) -> None:
        st.out.status = status
        st.out.finish_reason = reason
        st.out.finish_time = now
        if st.engine_rid is not None:
            self._by_attempt.pop(st.engine_rid, None)
            self.tracer.release_trace(st.engine_rid)
        st.handle = None
        st.engine_rid = None
        self._reserved -= st.budget
        self._journal_note(
            "terminal", request_id=st.out.request.request_id,
            status=status, reason=reason, n_tokens=len(st.out.tokens),
        )

    def _emit_terminal(self, st: _ClientState, reason: str) -> None:
        event = StreamEvent(
            request_id=st.out.request.request_id,
            token=-1,
            index=-1,
            finished=True,
            finish_reason=reason,
        )
        self._events.append(event)
        if st.out.request.on_token is not None:
            st.out.request.on_token(event)

    # -- telemetry ---------------------------------------------------------

    def _publish(self) -> None:
        r = self.registry
        for h in self.replicas:
            lab = {"replica": h.replica_id}
            r.gauge("cluster_replica_health", **lab).set(
                _HEALTH_CODE[h.health]
            )
            r.gauge("cluster_breaker_state", **lab).set(
                _BREAKER_CODE[h.health]
            )
            r.gauge("cluster_replica_restarts", **lab).set(h.restarts)
            r.gauge("cluster_swap_version", **lab).set(
                self._version_ordinals.setdefault(
                    h.weights_version, len(self._version_ordinals)
                )
            )
            r.gauge("cluster_replica_load", **lab).set(
                0.0 if h.health in (DEAD, BACKOFF) else h.load()
            )
            r.gauge("cluster_replica_queue_depth", **lab).set(h.queue_depth)
            r.gauge("cluster_replica_active_slots", **lab).set(h.active_slots)
        r.gauge("cluster_inflight_tokens").set(self._reserved)
        r.gauge("cluster_pending_requests").set(len(self._pending))
        if isinstance(self.router, PrefixAffinityRouter):
            r.gauge("cluster_affinity_fallbacks").set(self.router.fallbacks)

    def recovery_summary(self) -> Dict[int, dict]:
        """Per-replica self-healing state for tooling and the chaos
        harness: breaker attempts/budget, consecutive failures, whether a
        restart is pending, and probation progress."""
        policy = self.config.restart
        out = {}
        for h in self.replicas:
            rec = self._recovery[h.replica_id]
            out[h.replica_id] = {
                "health": h.health,
                "restarts": h.restarts,
                "attempts": rec.attempts,
                "budget_left": (
                    0 if policy is None or h.engine_factory is None
                    else max(0, policy.max_restarts - rec.attempts)
                ),
                "failures": rec.failures,
                "restart_pending": rec.restart_at is not None,
                "restart_at": rec.restart_at,
                "probation": rec.probation,
                "clean_ticks": rec.clean_ticks,
                "stall_ticks": rec.stall_ticks,
            }
        return out

    def prefix_hit_rate(self) -> Optional[float]:
        """Aggregate prefix-cache hit rate across every replica whose
        engine runs a prefix cache (None when none do or nothing probed) —
        the number prefix-affinity routing exists to maximize."""
        hits = misses = 0
        for h in self.replicas:
            pc = h.engine._prefix
            if pc is not None:
                hits += pc.hits
                misses += pc.misses
        probes = hits + misses
        if probes == 0:
            return None
        return hits / probes

    def summary(self) -> dict:
        hit_rate = self.prefix_hit_rate()
        return {
            "replicas": [h.summary() for h in self.replicas],
            "router": self.router.name,
            "submitted": int(self._submitted.value),
            "finished": int(self._finished.value),
            "retries": int(self._retries.value),
            "requeued": int(self._requeued.value),
            "cancelled": int(self._cancelled.value),
            "deadline_sheds": int(self._deadline_sheds.value),
            "failed": int(self._failed.value),
            "replica_deaths": int(self._deaths.value),
            "watchdog_degraded": int(self._watchdog_degraded.value),
            "watchdog_kills": int(self._watchdog_kills.value),
            "restarts": int(self._restarts.value),
            "restart_failures": int(self._restart_failures.value),
            "probation_promotions": int(self._promotions.value),
            "probation_demotions": int(self._demotions.value),
            "swap_state": self.swap_status()["state"],
            "swaps": int(
                self.registry.counter("cluster_swaps_total").value
            ),
            "swap_rollbacks": int(
                self.registry.counter(
                    "cluster_swap_rollbacks_total"
                ).value
            ),
            "autopilot": (
                None if self._autopilot is None
                else {
                    "shedding": self._autopilot.shedding,
                    "shed_rejects": int(
                        self._autopilot._shed_rejects.value
                    ),
                    "shed_cancels": int(
                        self._autopilot._shed_cancels.value
                    ),
                    "actions": len(self._autopilot.actions),
                }
            ),
            "scale_ups": int(
                self.registry.counter("cluster_scale_ups_total").value
            ),
            "scale_downs": int(
                self.registry.counter("cluster_scale_downs_total").value
            ),
            "inflight_tokens": self._reserved,
            "kv_exports": int(
                self.registry.counter("cluster_kv_exports_total").value
            ),
            "kv_migrations": {
                status: int(
                    self.registry.counter(
                        "cluster_kv_migrations_total", status=status
                    ).value
                )
                for status in MIGRATION_STATUSES
            },
            "kv_migrated_blocks": int(
                self.registry.counter(
                    "cluster_kv_migrated_blocks_total"
                ).value
            ),
            "kv_warm_start_blocks": int(
                self.registry.counter(
                    "cluster_kv_warm_start_blocks_total"
                ).value
            ),
            "prefix_hit_rate": (
                None if hit_rate is None else round(hit_rate, 4)
            ),
            "ttft_ms_p50": _ms(self._ttft.percentile(50)),
            "ttft_ms_p95": _ms(self._ttft.percentile(95)),
            "e2e_ms_p95": _ms(self._e2e.percentile(95)),
        }


def _ms(x: Optional[float]) -> Optional[float]:
    return None if x is None else round(x * 1000.0, 3)
