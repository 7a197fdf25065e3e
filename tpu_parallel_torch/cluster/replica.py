"""One serving replica as the cluster sees it: an engine plus health.

A production cluster never talks to a :class:`~tpu_parallel_torch.serving.engine.
ServingEngine` directly — it talks to a :class:`ReplicaHandle`, which adds
the things scale-out needs on top of the engine's tick loop:

- **Health state** (the full lifecycle is ``healthy`` / ``degraded`` /
  ``dead`` / ``backoff`` / ``probation`` — docs/12_cluster.md draws the
  machine): routers skip dead and backing-off replicas outright and
  deprioritize degraded (stalled) ones; the frontend retries a dead
  replica's in-flight work elsewhere.  ANY exception escaping
  ``engine.step()`` marks the replica dead — a replica that throws
  mid-tick has an engine in an unknown state, and the only safe move is
  to stop routing to it and replay its work.  DEGRADED is set by the
  frontend's progress WATCHDOG (observed no-progress), never by fault
  injection itself — detection is decoupled from injection.
- **Restart** (:meth:`restart` + :class:`RestartPolicy`): a dead replica
  whose handle carries an ``engine_factory`` can be rebuilt from the
  shared model/params.  The frontend schedules the rebuild with
  exponential backoff (``backoff`` state) and re-enters the fresh engine
  through a half-open ``probation`` state before trusting it with full
  traffic again — the circuit-breaker shape.
- **Load accounting**: queue depth + active slots + estimated pending
  prefill tokens, combined into one comparable ``load()`` scalar (the
  least-loaded router's sort key).  Everything is host-side bookkeeping
  the engine already tracks — reading load never touches the device.
- **Fault injection** (:class:`FaultPlan`): deterministic crash / stall /
  crash-loop / admission-reject faults keyed on the replica's own tick
  count, so failover tests replay EXACTLY (crash on tick 7 is crash on
  tick 7, every run).  A ``FaultPlan`` is how the acceptance suite proves
  the bitwise-exactness-under-failure story without flaky process
  killing.  Injection only causes BEHAVIOR (a raised exception, a no-op
  tick, a closed admission gate); it never edits health — the watchdog
  and the frontend's death handling own every health transition.

The handle also keeps the replica-local request ledger (every submitted,
not-yet-terminal engine :class:`RequestOutput`): when the replica dies,
``orphans()`` is precisely the work the frontend must re-route (and then
``forget()``, so a restarted replica can never double-replay them).
"""

from __future__ import annotations

import dataclasses
import random
from typing import Callable, Dict, List, Optional

from tpu_parallel_torch.serving.engine import ServingEngine
from tpu_parallel_torch.serving.request import Request, RequestOutput

# replica health states (the lifecycle ring: healthy -> degraded ->
# dead -> backoff -> probation -> healthy; docs/12_cluster.md)
HEALTHY = "healthy"  # routable
DEGRADED = "degraded"  # stalled/slow: routable only when nothing healthy is
DEAD = "dead"  # never routable; in-flight work must be replayed elsewhere
BACKOFF = "backoff"  # dead with a restart scheduled; never routable
PROBATION = "probation"  # restarted, half-open: routable under a request cap
RETIRED = "retired"  # scaled down (autopilot): removed from the fleet, idle

# ``load()`` weight of one pending prefill token relative to one queued
# request / one active slot: a slot decodes one token per tick while a
# queued prompt costs its whole length in prefill work, so tokens are
# discounted to rough slot-tick equivalents (64 prompt tokens ~ one
# request's worth of near-term work).  The constant only needs to rank
# replicas consistently, not model latency.
PREFILL_TOKEN_WEIGHT = 1.0 / 64.0


def xla_like_error(tick: int) -> Exception:
    """An ``exception_factory`` shaped like a real accelerator failure
    (the RuntimeError class XLA raises on device loss / deadline)."""
    return RuntimeError(
        f"XLA:TPU RESOURCE_EXHAUSTED: device halted at tick {tick} "
        "(simulated)"
    )


def logic_error(tick: int) -> Exception:
    """An ``exception_factory`` shaped like a host-side bug — a distinct
    exception TYPE from :func:`xla_like_error`, so tests can pin that the
    death path preserves the cause regardless of what escaped."""
    return ValueError(f"corrupt slot bookkeeping at tick {tick} (simulated)")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Deterministic fault schedule keyed on the replica's OWN tick count
    (the number of ``step()`` calls it has served — LIFETIME ticks keep
    counting across restarts; ``crash_every`` keys on INCARNATION ticks,
    the count since the last restart).

    - ``crash_at_tick``: the first step at/after this index raises
      :class:`ReplicaDead` instead of running — the engine is abandoned
      mid-flight exactly as a process kill would leave it.  One-shot: a
      restarted replica does not re-crash on the same schedule (use
      ``crash_every`` for a crash-loop).
    - ``crash_every``: the flapping shape — EVERY incarnation crashes on
      its ``crash_every``-th step, so a replica with a restart budget
      enters a crash-loop until the frontend's circuit breaker gives up.
    - ``exception_factory``: called with the crashing tick to build the
      exception the "engine" died of (e.g. :func:`xla_like_error` vs
      :func:`logic_error`); None raises a plain :class:`ReplicaDead`.
      Excluded from equality — schedules compare by their timing.
    - ``stall_at_tick`` + ``stall_ticks``: steps in
      ``[stall_at_tick, stall_at_tick + stall_ticks)`` do nothing (no
      engine tick, no events) — the GC-pause / preemption shape.  The
      stall does NOT touch health: detecting it from observed
      no-progress is the frontend watchdog's job.
    - ``reject_at_tick`` + ``reject_ticks``: during that tick window the
      replica refuses NEW admissions (``accepting`` is False) while
      in-flight work proceeds — the overload-shedding shape.
    - ``swap_at_tick``: an OPERATOR event, not a fault: the chaos/bench
      harness reading the plan calls ``Frontend.begin_swap`` when the
      fleet reaches this tick (``swap@T``), so seeded storms exercise a
      rolling weight swap colliding with crashes and stalls.  The plan
      itself never triggers it — like every other entry it only
      describes the schedule; the harness owns the behavior.
    """

    crash_at_tick: Optional[int] = None
    stall_at_tick: Optional[int] = None
    stall_ticks: int = 0
    reject_at_tick: Optional[int] = None
    reject_ticks: int = 0
    crash_every: Optional[int] = None
    swap_at_tick: Optional[int] = None
    exception_factory: Optional[Callable[[int], Exception]] = (
        dataclasses.field(default=None, compare=False)
    )

    def crash_scheduled(self, tick: int) -> bool:
        """The one-shot crash window opened (the handle tracks firing)."""
        return self.crash_at_tick is not None and tick >= self.crash_at_tick

    def flap_scheduled(self, incarnation_tick: int) -> bool:
        """This incarnation reached its crash-loop step."""
        return (
            self.crash_every is not None
            and incarnation_tick + 1 >= self.crash_every
        )

    def stalled(self, tick: int) -> bool:
        return (
            self.stall_at_tick is not None
            and self.stall_at_tick <= tick < self.stall_at_tick + self.stall_ticks
        )

    def rejecting(self, tick: int) -> bool:
        return (
            self.reject_at_tick is not None
            and self.reject_at_tick
            <= tick
            < self.reject_at_tick + self.reject_ticks
        )

    @classmethod
    def from_seed(
        cls,
        rnd: "random.Random",
        ticks: int,
        kinds: Optional[tuple] = None,
    ) -> "FaultPlan":
        """Draw a randomized-but-reproducible schedule over a ``ticks``
        horizon from a seeded :class:`random.Random` — the chaos
        harness's constructor.  ``kinds`` pins which fault shapes appear
        (subset of ``crash`` / ``stall`` / ``flap`` / ``reject``); None
        draws a random subset.  Same rng state => identical plan
        (``test_fault_plan_from_seed_deterministic``).

        A drawn stall always ENDS before a drawn crash begins, so the
        stall is observable (a crashed replica can't stall).  Determinism
        is per (rng state, ticks, kinds) triple: each kind's draws only
        happen when that kind is selected, so plans ARE expected to
        differ across different ``kinds`` combinations from one seed.
        """
        if ticks < 8:
            raise ValueError(f"ticks={ticks} < 8: no room for a schedule")
        if kinds is None:
            pool = ("crash", "stall", "flap", "reject")
            kinds = tuple(k for k in pool if rnd.random() < 0.5)
        unknown = set(kinds) - {"crash", "stall", "flap", "reject", "swap"}
        if unknown:
            raise ValueError(f"unknown fault kinds {sorted(unknown)}")
        kw: dict = {}
        if "swap" in kinds:
            # early enough that the rollout collides with the storm, late
            # enough that traffic and faults are already in motion
            kw["swap_at_tick"] = rnd.randrange(3, max(4, ticks // 2))
        if "stall" in kinds:
            kw["stall_at_tick"] = rnd.randrange(2, max(3, ticks // 3))
            kw["stall_ticks"] = rnd.randrange(2, 6)
        if "reject" in kinds:
            kw["reject_at_tick"] = rnd.randrange(1, max(2, ticks // 2))
            kw["reject_ticks"] = rnd.randrange(1, 8)
        if "crash" in kinds:
            # crash strictly after any stall window so the stall is seen
            floor = kw.get("stall_at_tick", 0) + kw.get("stall_ticks", 0) + 2
            kw["crash_at_tick"] = floor + rnd.randrange(
                0, max(2, ticks // 2)
            )
        if "flap" in kinds:
            kw["crash_every"] = rnd.randrange(6, max(7, ticks // 2))
        if ("crash" in kinds or "flap" in kinds) and rnd.random() < 0.5:
            kw["exception_factory"] = (
                xla_like_error if rnd.random() < 0.5 else logic_error
            )
        return cls(**kw)


@dataclasses.dataclass(frozen=True)
class RestartPolicy:
    """How (and how hard) the frontend tries to revive dead replicas —
    the circuit-breaker knobs (docs/12_cluster.md draws the lifecycle).

    - ``max_restarts``: lifetime restart attempts per replica.  Past it
      the breaker stays OPEN: the replica is dead forever (the
      breaker-less behavior).
    - ``backoff_seconds`` * ``backoff_factor`` ** (consecutive failures
      - 1), capped at ``max_backoff_seconds``: the delay between a death
      and the restart attempt, measured on the frontend's INJECTABLE
      clock.  Consecutive
      failures reset on a probation promotion — a replica that proved
      itself healthy earns back a fast restart.
    - ``probation_ticks``: clean cluster ticks a restarted replica must
      serve half-open before promotion to HEALTHY.  A tick only counts
      as clean if it is exception-free AND not stall-suspect (a replica
      with work that shows no observable progress earns nothing — a
      wedged restart is the watchdog's to kill, never promoted).
    - ``probation_requests``: max CONCURRENT open requests routable to a
      probation replica — the half-open trickle that proves the engine
      without betting real traffic on it.
    """

    max_restarts: int = 3
    backoff_seconds: float = 1.0
    backoff_factor: float = 2.0
    max_backoff_seconds: float = 60.0
    probation_ticks: int = 8
    probation_requests: int = 1

    def __post_init__(self):
        if self.max_restarts < 0:
            raise ValueError(f"max_restarts={self.max_restarts} < 0")
        if self.backoff_seconds < 0:
            raise ValueError(f"backoff_seconds={self.backoff_seconds} < 0")
        if self.backoff_factor < 1.0:
            raise ValueError(f"backoff_factor={self.backoff_factor} < 1")
        if self.probation_ticks < 1:
            raise ValueError(f"probation_ticks={self.probation_ticks} < 1")
        if self.probation_requests < 1:
            raise ValueError(
                f"probation_requests={self.probation_requests} < 1"
            )

    def delay(self, failures: int) -> float:
        """Backoff before the next restart after ``failures`` consecutive
        failures (>= 1): exponential, capped."""
        exponent = max(0, failures - 1)
        return min(
            self.backoff_seconds * self.backoff_factor ** exponent,
            self.max_backoff_seconds,
        )


class ReplicaDead(RuntimeError):
    """Raised by ``ReplicaHandle.step()`` when the replica dies — by
    FaultPlan schedule or by a real exception escaping the engine tick.
    The frontend catches it, collects ``orphans()``, and re-routes."""

    def __init__(self, replica_id: int, cause: Optional[str] = None):
        super().__init__(
            f"replica {replica_id} died"
            + (f" ({cause})" if cause else "")
        )
        self.replica_id = replica_id


class ReplicaHandle:
    """Cluster-side wrapper of one :class:`ServingEngine`.

    ``submit()``/``step()`` mirror the engine surface but maintain the
    health state, the tick counters the :class:`FaultPlan` keys off, and
    the not-yet-terminal request ledger that ``orphans()`` reports after
    a death.  The handle never constructs engines EXCEPT through the
    caller-supplied ``engine_factory`` — the caller owns model and params
    placement (same process here; the design point is that nothing in
    the cluster layer assumes it), and a factory is the caller saying
    "this is how you rebuild me".  Without one, a dead replica stays
    dead (the pre-self-healing behavior).
    """

    def __init__(
        self,
        replica_id: int,
        engine: ServingEngine,
        fault_plan: Optional[FaultPlan] = None,
        engine_factory: Optional[Callable[[], ServingEngine]] = None,
    ):
        self.replica_id = replica_id
        self.engine = engine
        self.fault_plan = fault_plan
        self.engine_factory = engine_factory
        self.health = HEALTHY
        # rolling weight swap: True while this replica is the rollout's
        # current target being drained of traffic — the frontend's
        # dispatch filter skips it for NEW placement while in-flight work
        # finishes on the old weights (cluster/swap.py owns the flag)
        self.swap_excluded = False
        self.ticks = 0  # lifetime step() calls, NEVER reset
        self.incarnation_ticks = 0  # step() calls since the last restart
        self.restarts = 0  # successful restarts served so far
        self._crash_fired = False  # one-shot crash_at_tick bookkeeping
        self.cause_of_death: Optional[str] = None  # set by kill()
        # KV blocks warm-started into this replica's prefix cache at
        # scale-up (cluster/migration.py; 0 = cold or no radix cache)
        self.kv_warm_blocks = 0
        # engine integrity_trips watermark: a tick that trips the
        # NaN/Inf sentinel escalates this replica to DEGRADED health
        self._integrity_seen = 0
        # engine request_id -> live engine RequestOutput; pruned as
        # requests reach a terminal state
        self._ledger: Dict[str, RequestOutput] = {}

    # -- load signals ------------------------------------------------------

    @property
    def queue_depth(self) -> int:
        return self.engine.scheduler.depth

    @property
    def active_slots(self) -> int:
        return self.engine.in_flight

    @property
    def pending_prefill_tokens(self) -> int:
        return self.engine.pending_prefill_tokens

    @property
    def weights_version(self) -> str:
        """The served weight set's identity (``"initial"`` until a hot
        swap rebinds it) — what the rolling-swap status and the
        ``cluster_swap_version`` gauge report."""
        return getattr(self.engine, "weights_version", "initial")

    @property
    def open_requests(self) -> int:
        """Submitted, not-yet-terminal requests on this replica — the
        probation concurrency cap's denominator."""
        self._prune()
        return len(self._ledger)

    def load(self) -> float:
        """One comparable scalar: queued requests + occupied slots +
        discounted pending prefill tokens (see ``PREFILL_TOKEN_WEIGHT``).
        A dead or backing-off replica reports infinite load so any
        ranking consumer that forgets to filter by health still never
        picks it."""
        if self.health in (DEAD, BACKOFF, RETIRED):
            return float("inf")
        return (
            self.queue_depth
            + self.active_slots
            + self.pending_prefill_tokens * PREFILL_TOKEN_WEIGHT
        )

    @property
    def routable(self) -> bool:
        """Placeable for frontend dispatch: alive (healthy, degraded or
        on probation) and not inside a FaultPlan admission-reject
        window.  Deliberately IGNORES the engine's drain gate — frontend
        dispatch relocates already-accepted work (``requeue=True``),
        which the gate waves through; a draining cluster must still be
        able to land its re-routed queue remainders.  The probation
        request cap is the FRONTEND's filter (it owns the policy), not
        this property's."""
        if self.health in (DEAD, BACKOFF, RETIRED):
            return False
        if self.fault_plan is not None and self.fault_plan.rejecting(
            self.ticks
        ):
            return False
        return True

    @property
    def accepting(self) -> bool:
        """Accepting NEW admissions: routable AND not drain-gated."""
        return self.routable and not self.engine.draining

    # -- work --------------------------------------------------------------

    def submit(
        self,
        request: Request,
        requeue: bool = False,
        arrival_time: Optional[float] = None,
    ) -> RequestOutput:
        """Hand one request to the replica's engine; tracks it in the
        ledger unless the engine rejected it synchronously."""
        if self.health in (DEAD, BACKOFF):
            raise ReplicaDead(
                self.replica_id, f"submit to {self.health} replica"
            )
        out = self.engine.add_request(
            request, requeue=requeue, arrival_time=arrival_time
        )
        if not out.done:
            self._ledger[request.request_id] = out
        return out

    def step(self) -> list:
        """One engine tick under the fault plan.  Raises
        :class:`ReplicaDead` on a scheduled crash or any engine exception
        (health flips to DEAD first, so the raiser's view and a later
        reader's view agree); returns the tick's StreamEvents, or [] for
        a stalled tick.  A stall produces BEHAVIOR only (no events, no
        engine tick) — whether that makes the replica DEGRADED is the
        frontend watchdog's call, from observation."""
        if self.health in (DEAD, BACKOFF):
            raise ReplicaDead(
                self.replica_id, f"step on {self.health} replica"
            )
        tick = self.ticks
        itick = self.incarnation_ticks
        self.ticks += 1
        self.incarnation_ticks += 1
        fp = self.fault_plan
        if fp is not None:
            cause = None
            if not self._crash_fired and fp.crash_scheduled(tick):
                self._crash_fired = True
                cause = f"fault plan, tick {tick}"
            elif fp.flap_scheduled(itick):
                cause = (
                    f"fault plan crash-loop, incarnation tick {itick}"
                )
            if cause is not None:
                self.health = DEAD
                if fp.exception_factory is not None:
                    exc = fp.exception_factory(tick)
                    raise ReplicaDead(
                        self.replica_id, repr(exc)
                    ) from exc
                raise ReplicaDead(self.replica_id, cause)
            if fp.stalled(tick):
                return []
        try:
            events = self.engine.step()
        except Exception as exc:  # engine state unknown: replica is gone
            self.health = DEAD
            raise ReplicaDead(self.replica_id, repr(exc)) from exc
        trips = getattr(self.engine, "integrity_trips", 0)
        if trips > self._integrity_seen:
            # the NaN/Inf sentinel tripped this tick: the affected
            # request already FAILED typed; the replica escalates to
            # DEGRADED so routers deprioritize an engine producing
            # non-finite logits (the watchdog restores HEALTHY if
            # subsequent work progresses cleanly — an escalation, not
            # a death sentence)
            self._integrity_seen = trips
            if self.health == HEALTHY:
                self.health = DEGRADED
        self._prune()
        return events

    def retire(self) -> None:
        """Scale-down retirement (the autopilot's shrink actuator): the
        engine's drain gate closes and health becomes RETIRED — a
        terminal state distinct from DEAD (nothing failed; no orphans,
        no restart, no breaker involvement).  The caller (the frontend)
        guarantees the idle precondition: a retiring replica holds no
        queued or in-flight work, so its cache pool is already fully
        released."""
        if self.has_work():
            raise RuntimeError(
                f"retire replica {self.replica_id} with work in flight "
                f"({self.engine.in_flight} slots, "
                f"{self.queue_depth} queued) — only idle replicas retire"
            )
        self.engine.begin_drain()
        self.health = RETIRED

    def kill(self, cause: str) -> None:
        """Declare this replica dead WITHOUT an exception — the watchdog
        path: the engine may even be fine (a false positive), but from
        the cluster's point of view a replica that stopped delivering is
        gone; its work replays elsewhere and the engine is abandoned (or
        rebuilt via :meth:`restart`)."""
        self.health = DEAD
        self.cause_of_death = cause

    def restart(self) -> None:
        """Rebuild the engine through ``engine_factory`` and re-enter
        half-open: health becomes PROBATION, the incarnation tick counter
        resets (so ``crash_every`` keys on the new life), and the ledger
        clears — every orphan was already replayed by the frontend, so a
        stale ledger would only double-replay them.  A factory exception
        propagates with the handle UNTOUCHED (still restartable); the
        frontend counts it as a failed attempt and backs off harder."""
        if self.engine_factory is None:
            raise RuntimeError(
                f"replica {self.replica_id} has no engine_factory — "
                "cannot restart"
            )
        engine = self.engine_factory()  # may raise: handle stays as-is
        self.engine = engine
        self._ledger.clear()
        self._integrity_seen = 0  # the fresh engine's counter restarts
        self.incarnation_ticks = 0
        self.restarts += 1
        self.health = PROBATION
        # a rebuilt engine is a fresh traffic target — any stale swap
        # exclusion died with the old incarnation (the swap controller
        # re-queues the replica as a target if its rollout still runs)
        self.swap_excluded = False

    def has_work(self) -> bool:
        return (
            self.health not in (DEAD, BACKOFF, RETIRED)
            and self.engine.has_work()
        )

    def _prune(self) -> None:
        done = [rid for rid, out in self._ledger.items() if out.done]
        for rid in done:
            del self._ledger[rid]

    def orphans(self) -> List[RequestOutput]:
        """Every tracked request that had NOT reached a terminal state —
        queued or holding a slot — in submission order.  After a death
        this is exactly the work the frontend replays elsewhere (tokens
        already delivered ride along on each RequestOutput, so the replay
        can force-prefix them)."""
        self._prune()
        return list(self._ledger.values())

    def forget(self, request_id: str) -> None:
        """Drop one request from the ledger (the frontend pulled it back
        for re-routing — e.g. a drain's queued remainder)."""
        self._ledger.pop(request_id, None)

    def export_kv(self, engine_rid: str):
        """Best-effort KV export of a live attempt's written prefix (the
        cross-replica migration capture — ``cluster/migration.py``).
        None whenever nothing can or should be read: a dead/backing-off
        replica's engine is in an unknown state, a fixed-slot engine has
        no block pool, and any exception during the export degrades to
        the proven recompute path rather than failing the relocation."""
        if self.health in (DEAD, BACKOFF):
            return None
        try:
            return self.engine.export_prefix(engine_rid)
        except Exception:
            return None  # capture is an optimization, never a new fault

    def take_queued(self) -> List[RequestOutput]:
        """Pull the engine's queued remainder (FIFO order) out of this
        replica for re-routing, dropping each from the ledger."""
        taken = self.engine.scheduler.take_queued()
        for out in taken:
            self.forget(out.request.request_id)
        return taken

    def summary(self) -> dict:
        dark = self.health in (DEAD, BACKOFF, RETIRED)
        return {
            "replica": self.replica_id,
            "health": self.health,
            "weights_version": self.weights_version,
            "ticks": self.ticks,
            "restarts": self.restarts,
            "queue_depth": self.queue_depth,
            "active_slots": self.active_slots,
            "pending_prefill_tokens": self.pending_prefill_tokens,
            "load": None if dark else round(self.load(), 3),
        }
