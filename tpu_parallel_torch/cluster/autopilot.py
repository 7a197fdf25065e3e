"""SLO autopilot: closed-loop overload control for the serving cluster.

The self-healing fleet survives crashes and the rolling swap
ships new weights under load, but neither defends against the
failure mode production fleets hit daily: SUSTAINED offered load above
capacity.  Without a controller the frontend backlog grows without
bound, priority aging re-sorts a queue that can never drain, and every
deadline misses at once — silently.  This module is the graceful-
degradation layer: an :class:`Autopilot` driven once per
``Frontend.step()`` on the injectable clock, sensing the latency and
queue-age signals the observability stack already publishes and
actuating three BOUNDED levers:

**Sense** (every tick, windowed over ``AutopilotPolicy.window_ticks``):
the cluster queue age (frontend backlog head age, maxed with every live
replica's ``serving_queue_age_seconds``-equivalent scheduler read), a
windowed TTFT p95 (:class:`~tpu_parallel_torch.obs.registry.PercentileWindow`
delta over the frontend's cumulative ``cluster_ttft_seconds``
histogram), per-replica load/health, and the running shed/deadline
tallies.  Breach = windowed queue-age p95 or TTFT p95 past the policy
targets.

**Decide** (explicit hysteresis, so the controller cannot flap): a
breach must hold for ``breach_ticks`` consecutive ticks before SHEDDING
engages, and the fleet must run clean for ``clear_ticks`` consecutive
ticks before it disengages — entry is fast (seconds of overload hurt),
exit is deliberate (a half-drained queue re-breaches instantly).  Scale
and rebalance actions carry their own cooldowns on top.

**Actuate**:

- *Shed* — while shedding, NEW lowest-effective-priority submissions
  are rejected with the typed ``shed`` finish reason (the same
  vocabulary the engine and frontend already share), and queued
  requests whose deadline is provably unmeetable
  (``waited + min_service_estimate > deadline``) are cancelled with the
  same reason before they waste a prefill.  Both draws are bounded by
  ``max_shed_fraction`` of the window's submissions — shedding is a
  bounded, loud, lowest-priority-first slice, never a rout.
- *Scale* — sustained breach grows the fleet through ``engine_factory``
  up to ``max_replicas``; a new replica enters service through the
  EXISTING half-open probation gate (it must prove itself before taking
  full traffic) and — post-swap — is rebound to the fleet-standard
  weights first.  A replica idle for ``scale_down_idle_ticks``
  consecutive ticks retires through the drain path (idle by
  construction, so nothing relocates) down to ``min_replicas``.
  Scaling NEVER interleaves with a rolling weight swap: while
  ``cluster/swap.py`` is mid-rollout the actuator refuses with the
  typed ``swap_in_progress`` reason instead of racing the rollout's
  replica bookkeeping.
- *Retune* — the admission ``token_budget`` (``FrontendConfig.
  max_inflight_tokens``) tightens toward its configured floor under
  sustained breach and relaxes back toward its ceiling when clear, and
  every live scheduler's chunked-prefill tick share
  (``max_prefills_per_tick``) rises to its ceiling to drain the queue
  faster (falling back when clear) — both within hard policy bounds.
  When one replica's load exceeds ``imbalance_factor`` x the fleet mean
  the prefix-affinity ring rebalances: the hot replica's ring weight
  halves (its hottest keys slide to ring successors), restored
  stepwise once the fleet is balanced again.

Every decision is a typed :class:`AutopilotAction` appended to the
action log, traced as an instant on the dedicated ``autopilot`` track,
and counted in the ``cluster_autopilot_*`` registry namespace — and the
whole controller is a PURE function of (metric windows, clock, policy):
no wall time, no
randomness, so the same trace under the same policy replays the same
action log bit for bit (pinned by the determinism test).
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from tpu_parallel_torch.cluster.replica import (
    BACKOFF,
    DEAD,
    HEALTHY,
    ReplicaHandle,
)
from tpu_parallel_torch.cluster.router import PrefixAffinityRouter
from tpu_parallel_torch.obs.registry import PercentileWindow
from tpu_parallel_torch.serving.request import REJECT_SHED

# typed AutopilotAction kinds
AP_SHED_ON = "shed_on"  # hysteresis entered the shedding state
AP_SHED_OFF = "shed_off"  # hysteresis left the shedding state
AP_SHED_CANCEL = "shed_cancel"  # unmeetable queued requests cancelled
AP_SCALE_UP = "scale_up"  # replica added (enters via probation)
AP_SCALE_DOWN = "scale_down"  # idle replica retired via drain
AP_RETUNE_BUDGET = "retune_budget"  # admission token budget adjusted
AP_RETUNE_PREFILL = "retune_prefill"  # prefill tick share adjusted
AP_REBALANCE = "rebalance"  # prefix-affinity ring weight shifted
AP_REFUSED = "refused"  # an actuation was due but typed-refused

AP_REROLE = "rerole"  # a fleet daemon's prefill/decode role flipped

# typed refusal reasons (AutopilotAction.reason on AP_REFUSED)
AP_REFUSED_SWAP = "swap_in_progress"  # no interleaving with cluster/swap.py
AP_REFUSED_MAX_REPLICAS = "max_replicas"
AP_REFUSED_NO_FACTORY = "no_engine_factory"
AP_REFUSED_NO_ROLE_CONTROLLER = "no_role_controller"
AP_REFUSED_NO_IDLE_PEER = "no_idle_peer"

AUTOPILOT_TRACK = "autopilot"  # the tracer track every instant lands on


def cluster_queue_age(frontend, now: float) -> float:
    """The cluster's head-of-line age: the frontend backlog's oldest
    pending arrival, maxed with every live replica's scheduler queue age
    (the same signal ``serving_queue_age_seconds`` publishes per
    engine).  Module-level so the autopilot's sense and the serve_bench
    no-autopilot leg read the IDENTICAL definition — the bench's
    leg-vs-leg comparison would silently rot on a copy."""
    age = 0.0
    for st in frontend._pending:
        arrival = st.out.arrival_time
        if arrival is not None:
            age = max(age, now - arrival)
    for h in frontend.replicas:
        if h.health in (DEAD, BACKOFF):
            continue
        age = max(age, h.engine.scheduler.oldest_age(now))
    return age


@dataclasses.dataclass(frozen=True)
class AutopilotAction:
    """One typed controller decision: what fired, when (tick + injectable
    clock), why, and the numbers behind it.  The action log (``Autopilot.
    actions``) is the determinism surface — same trace, same seed, same
    policy => identical log."""

    tick: int
    at: float  # injectable-clock time
    kind: str  # AP_* above
    reason: str  # breach signal / refusal reason / release cause
    detail: Tuple[Tuple[str, object], ...] = ()  # sorted key/value pairs

    @staticmethod
    def make(tick: int, at: float, kind: str, reason: str,
             **detail) -> "AutopilotAction":
        return AutopilotAction(
            tick=tick, at=at, kind=kind, reason=reason,
            detail=tuple(sorted(detail.items())),
        )


@dataclasses.dataclass(frozen=True)
class AutopilotPolicy:
    """The autopilot's knobs (docs/12_cluster.md draws the loop).

    Sense / hysteresis:

    - ``queue_age_target``: seconds — breach when the windowed p95 of
      the cluster queue-age sample exceeds it.
    - ``ttft_target``: seconds — breach when the windowed TTFT p95
      exceeds it (None = queue age alone drives the loop).
    - ``window_ticks``: the sensing/decision window; the shed budget
      and metric windows re-anchor every this many ticks.
    - ``breach_ticks`` / ``clear_ticks``: consecutive breach ticks to
      ENTER shedding, consecutive clear ticks to EXIT — deliberately
      asymmetric (fast in, slow out) so a half-drained queue cannot
      flap the controller.

    Shed:

    - ``max_shed_fraction``: hard bound on (shed rejections + shed
      cancellations) per window, as a fraction of the window's
      submissions.  The graceful-degradation contract: a bounded,
      lowest-priority slice is refused early and loudly.
    - ``min_service_seconds`` + ``service_seconds_per_token``: the
      provably-unmeetable estimate — a queued request is shed-cancelled
      when ``waited + min_service_seconds + max_new_tokens *
      service_seconds_per_token > deadline`` (zeros disable the
      proactive cancel; the dispatch-time check still drops requests
      whose deadline ALREADY passed, typed ``deadline``).

    Scale:

    - ``max_replicas`` / ``min_replicas``: fleet size bounds.
    - ``scale_cooldown_ticks``: minimum ticks between scale actions —
      a new replica must show up in the metrics before the controller
      is allowed another opinion.
    - ``scale_down_idle_ticks``: consecutive idle ticks before a
      replica retires (None disables scale-down).

    Retune:

    - ``token_budget_bounds``: (floor, ceiling) for the frontend's
      ``max_inflight_tokens`` (None disables budget retuning — an
      unbounded budget stays unbounded).  Retuning is anchored to the
      OPERATOR's setting: the first tighten records it as the baseline,
      relax steps back toward that baseline and stops — a cluster that
      never breached is never touched.
    - ``token_budget_step``: multiplicative step per window (0.25 =
      tighten/relax by 25%).
    - ``prefill_surge_share``: surge ceiling for every live scheduler's
      ``max_prefills_per_tick`` (None disables).  Under breach each
      scheduler surges to this value (one already set higher stays
      put); on relax it is restored to ITS OWN recorded pre-surge
      value — the operator's setting, not a policy constant.
    - ``imbalance_factor``: rebalance the prefix-affinity ring when
      max replica load > factor x fleet mean (None disables).
    - ``rebalance_cooldown_ticks`` and ``min_ring_weight`` bound how
      fast and how far a hot replica's ring share can shrink.

    Re-role (the FLEET's fourth lever, docs/14_fleet.md):

    - ``prefill_backlog_target`` / ``decode_itl_target``: seconds —
      when the windowed p95 of the fleet signals fed through
      ``observe_fleet`` breaches one of these for ``breach_ticks``
      consecutive ticks, the autopilot asks its ``role_controller``
      (a :class:`~tpu_parallel_torch.fleet.router.FleetRouter`) to re-role
      one idle mixed daemon toward the starved phase.  Both None (the
      default) disables the lever entirely.
    - ``role_cooldown_ticks``: minimum ticks between re-role actions
      (and between typed re-role refusals) — a flipped daemon must
      show up in the signals before the controller gets another
      opinion.
    """

    queue_age_target: float = 1.0
    ttft_target: Optional[float] = None
    window_ticks: int = 8
    breach_ticks: int = 2
    clear_ticks: int = 8
    max_shed_fraction: float = 0.25
    min_service_seconds: float = 0.0
    service_seconds_per_token: float = 0.0
    max_replicas: int = 1
    min_replicas: int = 1
    scale_cooldown_ticks: int = 16
    scale_down_idle_ticks: Optional[int] = 64
    token_budget_bounds: Optional[Tuple[int, int]] = None
    token_budget_step: float = 0.25
    prefill_surge_share: Optional[int] = None
    imbalance_factor: Optional[float] = None
    rebalance_cooldown_ticks: int = 32
    min_ring_weight: float = 0.25
    prefill_backlog_target: Optional[float] = None
    decode_itl_target: Optional[float] = None
    role_cooldown_ticks: int = 16

    def __post_init__(self):
        if self.queue_age_target <= 0:
            raise ValueError(
                f"queue_age_target={self.queue_age_target} <= 0"
            )
        if self.ttft_target is not None and self.ttft_target <= 0:
            raise ValueError(f"ttft_target={self.ttft_target} <= 0")
        if self.window_ticks < 1:
            raise ValueError(f"window_ticks={self.window_ticks} < 1")
        if self.breach_ticks < 1 or self.clear_ticks < 1:
            raise ValueError(
                f"breach_ticks={self.breach_ticks} / clear_ticks="
                f"{self.clear_ticks} must be >= 1"
            )
        if not 0.0 <= self.max_shed_fraction <= 1.0:
            raise ValueError(
                f"max_shed_fraction={self.max_shed_fraction} outside [0, 1]"
            )
        if self.min_service_seconds < 0 or self.service_seconds_per_token < 0:
            raise ValueError("service estimate terms must be >= 0")
        if self.min_replicas < 1:
            raise ValueError(f"min_replicas={self.min_replicas} < 1")
        if self.max_replicas < self.min_replicas:
            raise ValueError(
                f"max_replicas={self.max_replicas} < min_replicas="
                f"{self.min_replicas}"
            )
        if self.scale_cooldown_ticks < 1:
            raise ValueError(
                f"scale_cooldown_ticks={self.scale_cooldown_ticks} < 1"
            )
        if (
            self.scale_down_idle_ticks is not None
            and self.scale_down_idle_ticks < 1
        ):
            raise ValueError(
                f"scale_down_idle_ticks={self.scale_down_idle_ticks} < 1"
            )
        if self.token_budget_bounds is not None:
            lo, hi = self.token_budget_bounds
            if lo < 1 or hi < lo:
                raise ValueError(
                    f"token_budget_bounds={self.token_budget_bounds} "
                    "must be 1 <= lo <= hi"
                )
        if self.prefill_surge_share is not None and self.prefill_surge_share < 1:
            raise ValueError(
                f"prefill_surge_share={self.prefill_surge_share} < 1"
            )
        if not 0.0 < self.token_budget_step < 1.0:
            raise ValueError(
                f"token_budget_step={self.token_budget_step} outside (0, 1)"
            )
        if self.imbalance_factor is not None and self.imbalance_factor <= 1.0:
            raise ValueError(
                f"imbalance_factor={self.imbalance_factor} must be > 1 "
                "(a factor <= 1 rebalances on noise)"
            )
        if self.rebalance_cooldown_ticks < 1:
            raise ValueError(
                f"rebalance_cooldown_ticks={self.rebalance_cooldown_ticks}"
                " < 1"
            )
        if not 0.0 < self.min_ring_weight <= 1.0:
            raise ValueError(
                f"min_ring_weight={self.min_ring_weight} outside (0, 1]"
            )
        if (
            self.prefill_backlog_target is not None
            and self.prefill_backlog_target <= 0
        ):
            raise ValueError(
                f"prefill_backlog_target={self.prefill_backlog_target} <= 0"
            )
        if self.decode_itl_target is not None and self.decode_itl_target <= 0:
            raise ValueError(
                f"decode_itl_target={self.decode_itl_target} <= 0"
            )
        if self.role_cooldown_ticks < 1:
            raise ValueError(
                f"role_cooldown_ticks={self.role_cooldown_ticks} < 1"
            )


class Autopilot:
    """One closed control loop over a :class:`~tpu_parallel_torch.cluster.
    frontend.Frontend` (built by ``Frontend.enable_autopilot``, ticked
    from ``Frontend.step()`` — see the module docstring)."""

    def __init__(
        self,
        frontend,
        policy: AutopilotPolicy,
        engine_factory: Optional[Callable[[], object]] = None,
        role_controller=None,
    ):
        self.fe = frontend
        self.policy = policy
        # the re-role lever's actuator: duck-typed to FleetRouter's
        # role surface (``role_counts()`` / ``pick_rerole(to_role)`` /
        # ``set_role(addr, role)``).  None = the lever refuses typed.
        self.role_controller = role_controller
        # scale-up builds engines through this factory; default to the
        # first replica's own (the caller said "this is how you build
        # one of me").  Without any factory, scale-up refuses typed.
        self.engine_factory = engine_factory or next(
            (
                h.engine_factory
                for h in frontend.replicas
                if h.engine_factory is not None
            ),
            None,
        )
        self.ticks = 0
        self.shedding = False
        self.actions: List[AutopilotAction] = []
        self._breach_streak = 0
        self._clear_streak = 0
        self._breach_reason = ""  # last breach signal (queue_age / ttft)
        # sensing windows
        self._qage_samples: deque = deque(maxlen=policy.window_ticks)
        self._ttft_win = PercentileWindow(frontend._ttft)
        # per-window shed budget: submissions counted from the frontend's
        # cumulative counter, sheds reset at every window boundary
        self._win_sub0 = frontend._submitted.value
        self._win_shed = 0
        # actuator cooldowns / balance bookkeeping
        self._last_scale_tick: Optional[int] = None
        self._last_refusal_tick: Optional[int] = None
        self._last_rebalance_tick: Optional[int] = None
        self._balanced_streak = 0
        self._idle_ticks: Dict[int, int] = {}
        # re-role sensing: fleet signals arrive via observe_fleet (the
        # router-side pump feeds them), windowed like queue age
        self._backlog_samples: deque = deque(maxlen=policy.window_ticks)
        self._itl_samples: deque = deque(maxlen=policy.window_ticks)
        self._role_breach_streak = 0
        self._role_breach_dir = ""  # "prefill_backlog" / "decode_itl"
        self._last_rerole_tick: Optional[int] = None
        self._last_role_refusal_tick: Optional[int] = None
        # per-tick shed floor (see admission_veto) and the retune
        # baselines — only settings the controller itself tightened are
        # ever relaxed, back to where the operator had them
        self._prio_floor: Optional[float] = None
        self._budget_tightened = False
        self._budget_baseline: Optional[int] = None  # None = unbounded
        self._prefill_baseline: Dict[int, int] = {}
        r = frontend.registry
        self._act_counter = lambda kind: r.counter(
            "cluster_autopilot_actions_total", kind=kind
        )
        self._shed_rejects = r.counter(
            "cluster_autopilot_shed_total", kind="reject"
        )
        self._shed_cancels = r.counter(
            "cluster_autopilot_shed_total", kind="cancel"
        )
        self._refusals = lambda reason: r.counter(
            "cluster_autopilot_refusals_total", reason=reason
        )
        self._g_shedding = r.gauge("cluster_autopilot_shedding")
        self._g_replicas = r.gauge("cluster_autopilot_replicas")
        self._g_qage = r.gauge("cluster_autopilot_queue_age_p95_seconds")
        self._g_budget = r.gauge("cluster_autopilot_token_budget")

    # -- sense ---------------------------------------------------------------

    def queue_age(self, now: float) -> float:
        """See :func:`cluster_queue_age` — the one shared definition."""
        return cluster_queue_age(self.fe, now)

    def _windowed_p95(self, samples: deque) -> float:
        ordered = sorted(samples)
        if not ordered:
            return 0.0
        rank = max(1, -(-95 * len(ordered) // 100))  # ceil(0.95 n)
        return ordered[rank - 1]

    def observe_fleet(
        self,
        prefill_backlog_seconds: Optional[float] = None,
        decode_itl_seconds: Optional[float] = None,
    ) -> None:
        """Feed one sample of the fleet's disaggregation signals: how
        long fresh submissions wait for a prefill slot, and the decode
        inter-token latency clients see.  The re-role lever senses the
        windowed p95 of whatever arrives here — no samples, no lever
        (a single-process cluster never feeds this)."""
        if prefill_backlog_seconds is not None:
            self._backlog_samples.append(float(prefill_backlog_seconds))
        if decode_itl_seconds is not None:
            self._itl_samples.append(float(decode_itl_seconds))

    def _breached(self) -> Optional[str]:
        """The breach signal this tick, or None when inside targets."""
        pol = self.policy
        qage95 = self._windowed_p95(self._qage_samples)
        self._g_qage.set(qage95)
        if qage95 > pol.queue_age_target:
            return "queue_age"
        if pol.ttft_target is not None:
            ttft95 = self._ttft_win.delta_percentile(95)
            if ttft95 is not None and ttft95 > pol.ttft_target:
                return "ttft"
        return None

    # -- decide / actuate ----------------------------------------------------

    def tick(self, now: float) -> None:
        """One control step (called from ``Frontend.step()`` before
        dispatch, so this tick's decisions shape this tick's placement)."""
        pol = self.policy
        self.ticks += 1
        if self.ticks % pol.window_ticks == 0:
            # window boundary: re-anchor the TTFT window and shed budget
            self._ttft_win = PercentileWindow(self.fe._ttft)
            self._win_sub0 = self.fe._submitted.value
            self._win_shed = 0
        self._qage_samples.append(self.queue_age(now))
        reason = self._breached()
        if reason is not None:
            self._breach_streak += 1
            self._clear_streak = 0
            self._breach_reason = reason
        else:
            self._clear_streak += 1
            self._breach_streak = 0
        if not self.shedding and self._breach_streak >= pol.breach_ticks:
            self.shedding = True
            self._record(now, AP_SHED_ON, self._breach_reason,
                         queue_age_p95=self._qage_p95())
        elif self.shedding and self._clear_streak >= pol.clear_ticks:
            self.shedding = False
            self._record(now, AP_SHED_OFF, "clear_window",
                         queue_age_p95=self._qage_p95())
        # the shed floor is computed ONCE per tick (admission_veto runs
        # per submission on the overload hot path — an O(backlog) scan
        # there would be quadratic exactly when it hurts; one tick of
        # staleness is within the controller's reaction time anyway)
        self._prio_floor = (
            min(
                (
                    self.fe._effective_priority(st, now)
                    for st in self.fe._open_states()
                    if not st.out.done and not st.out.tokens
                ),
                default=None,
            )
            if self.shedding
            else None
        )
        if self.shedding:
            self._shed_unmeetable(now)
        self._scale(now)
        self._retune(now)
        self._rebalance(now)
        self._rerole(now)
        self._g_shedding.set(1.0 if self.shedding else 0.0)
        self._g_replicas.set(len(self.fe.replicas))
        budget = self.fe.config.max_inflight_tokens
        if budget is not None:
            self._g_budget.set(budget)

    def _qage_p95(self) -> float:
        return round(self._windowed_p95(self._qage_samples), 6)

    def _record(self, now: float, kind: str, reason: str, **detail) -> None:
        action = AutopilotAction.make(self.ticks, now, kind, reason, **detail)
        self.actions.append(action)
        self._act_counter(kind).inc()
        if self.fe.tracer.enabled:
            self.fe.tracer.instant(
                kind, track=AUTOPILOT_TRACK, reason=reason,
                **dict(action.detail),
            )

    # -- shed ----------------------------------------------------------------

    def _shed_budget_left(self) -> bool:
        """Whether one more shed fits under ``max_shed_fraction`` of this
        window's submissions (the cumulative counter minus the window
        anchor — rejected submissions count as offered load)."""
        submitted = self.fe._submitted.value - self._win_sub0
        return (
            self._win_shed + 1
            <= self.policy.max_shed_fraction * submitted
        )

    def admission_veto(self, request, now: float) -> Optional[str]:
        """Consulted by ``Frontend.submit`` on every NEW submission:
        returns the typed ``shed`` reason when the request should be
        rejected, None to admit.  Only fires while shedding, only
        against the LOWEST effective priority (a new arrival sheds only
        when nothing pending ranks below it — higher classes sail
        through), and only within the window's shed budget."""
        if not self.shedding:
            return None
        # the arrival's effective priority is its class (zero wait); it
        # is "lowest" when no WAITING request — frontend backlog or
        # engine-queued, i.e. any open state yet to stream — ranks
        # strictly below it.  Nothing waiting anywhere means the breach
        # is already draining: admit.  The floor is the tick-start
        # snapshot (see tick()), not a per-submission scan.
        floor = self._prio_floor
        if floor is None or request.priority > floor:
            return None
        if not self._shed_budget_left():
            return None
        self._win_shed += 1
        self._shed_rejects.inc()
        return REJECT_SHED

    def _shed_unmeetable(self, now: float) -> None:
        """Proactively cancel queued requests whose deadline is provably
        unmeetable — a reply the client cannot receive in time is pure
        wasted prefill.  Bounded by the window shed budget; frontend
        backlog and engine-queued work alike (running requests are left
        to the ordinary deadline cancel — they may still finish)."""
        pol = self.policy
        if pol.min_service_seconds == 0 and pol.service_seconds_per_token == 0:
            return
        cancelled = []
        queued_by_handle: Dict[int, set] = {}  # per-tick snapshot cache
        for st in list(self.fe._open_states()):
            out = st.out
            deadline = out.request.deadline
            if deadline is None or out.done or out.tokens:
                continue
            if st.handle is not None and st.engine_rid is not None:
                # only engine-QUEUED attempts are sheddable; one holding
                # a slot is already being served
                rid = st.handle.replica_id
                queued_ids = queued_by_handle.get(rid)
                if queued_ids is None:
                    queued_ids = queued_by_handle[rid] = {
                        e.request.request_id
                        for e in st.handle.engine.scheduler.queued()
                    }
                if st.engine_rid not in queued_ids:
                    continue
            waited = (
                now - out.arrival_time
                if out.arrival_time is not None
                else 0.0
            )
            if waited > deadline:
                # ALREADY expired: that is the deadline path's cancel
                # (typed ``deadline``), not a shed — spending shed
                # budget on a request that was lost anyway would also
                # under-report real deadline misses
                continue
            estimate = (
                pol.min_service_seconds
                + out.request.max_new_tokens * pol.service_seconds_per_token
            )
            if waited + estimate <= deadline:
                continue
            if not self._shed_budget_left():
                break
            self._win_shed += 1
            self._shed_cancels.inc()
            self.fe._cancel_state(st, REJECT_SHED, now)
            cancelled.append(out.request.request_id)
        if cancelled:
            # the action carries the COUNT, not the ids: request ids
            # come from a process-global counter, and the action log is
            # the determinism surface (identical runs must produce
            # identical logs).  Per-request ids are already on the
            # tracer via _cancel_state's "cancel" instants.
            self._record(
                now, AP_SHED_CANCEL, "deadline_unmeetable",
                count=len(cancelled),
            )

    # -- scale ---------------------------------------------------------------

    def _scale_cooldown_ok(self) -> bool:
        last = self._last_scale_tick
        return last is None or (
            self.ticks - last >= self.policy.scale_cooldown_ticks
        )

    def _refuse_scale(self, now: float, reason: str, **detail) -> None:
        # one typed refusal per cooldown window, not one per tick — the
        # log records that scaling was due and why it could not run
        last = self._last_refusal_tick
        if last is not None and (
            self.ticks - last < self.policy.scale_cooldown_ticks
        ):
            return
        self._last_refusal_tick = self.ticks
        self._refusals(reason).inc()
        self._record(now, AP_REFUSED, reason, **detail)

    def _scale(self, now: float) -> None:
        pol = self.policy
        fe = self.fe
        swap_active = fe._swap is not None and fe._swap.active
        # -- up: sustained breach, room in the fleet, cooldown elapsed
        if self.shedding and self._breach_streak >= pol.breach_ticks:
            if self._scale_cooldown_ok():
                if len(fe.replicas) >= pol.max_replicas:
                    # a due scale-up with no headroom is worth a typed
                    # record too: shedding is now the only lever left
                    self._refuse_scale(
                        now, AP_REFUSED_MAX_REPLICAS, wanted=AP_SCALE_UP,
                    )
                elif swap_active:
                    self._refuse_scale(
                        now, AP_REFUSED_SWAP, wanted=AP_SCALE_UP,
                    )
                elif self.engine_factory is None:
                    self._refuse_scale(
                        now, AP_REFUSED_NO_FACTORY, wanted=AP_SCALE_UP,
                    )
                else:
                    handle = fe._add_replica(self.engine_factory)
                    self._last_scale_tick = self.ticks
                    self._record(
                        now, AP_SCALE_UP, self._breach_reason,
                        replica=handle.replica_id,
                        replicas=len(fe.replicas),
                        # KV blocks migrated into the newcomer's prefix
                        # cache at birth (cluster/migration.py warm
                        # start; 0 = cold or no radix hierarchy)
                        kv_warm_blocks=handle.kv_warm_blocks,
                    )
        # -- down: replicas idle long enough, fleet above the floor
        if pol.scale_down_idle_ticks is None:
            return
        live_idle = []
        for h in fe.replicas:
            idle = (
                h.health == HEALTHY
                and not h.has_work()
                and h.open_requests == 0
            )
            if idle:
                self._idle_ticks[h.replica_id] = (
                    self._idle_ticks.get(h.replica_id, 0) + 1
                )
                live_idle.append(h)
            else:
                self._idle_ticks[h.replica_id] = 0
        if self.shedding or self._breach_streak > 0:
            return
        ripe = [
            h for h in live_idle
            if self._idle_ticks[h.replica_id] >= pol.scale_down_idle_ticks
        ]
        if not ripe or len(fe.replicas) <= pol.min_replicas:
            return
        if not self._scale_cooldown_ok():
            return
        if swap_active:
            self._refuse_scale(now, AP_REFUSED_SWAP, wanted=AP_SCALE_DOWN)
            return
        # deterministic pick: the longest-idle replica, ties to the
        # HIGHEST id (scale-down unwinds scale-up, newest first)
        victim = max(
            ripe,
            key=lambda h: (self._idle_ticks[h.replica_id], h.replica_id),
        )
        fe._retire_replica(victim)
        self._idle_ticks.pop(victim.replica_id, None)
        self._last_scale_tick = self.ticks
        self._record(
            now, AP_SCALE_DOWN, "idle",
            replica=victim.replica_id, replicas=len(fe.replicas),
        )

    # -- retune --------------------------------------------------------------

    def _retune(self, now: float) -> None:
        """Window-edge admission retuning: tighten under sustained
        breach, relax when clear — always inside the policy bounds, and
        NEVER past the operator's own settings: the first tighten
        records the pre-autopilot baseline, relax steps back toward it
        and stops there (a cluster that never breached is never
        touched)."""
        pol = self.policy
        if self.ticks % pol.window_ticks != 0:
            return
        fe = self.fe
        tighten = self.shedding or self._breach_streak >= pol.breach_ticks
        relax = not self.shedding and self._clear_streak >= pol.window_ticks
        if pol.token_budget_bounds is not None and (tighten or relax):
            lo, hi = pol.token_budget_bounds
            cur_cfg = fe.config.max_inflight_tokens
            cur = hi if cur_cfg is None else cur_cfg
            new: Optional[int] = cur
            if tighten:
                if not self._budget_tightened:
                    # record the OPERATOR's setting — None (unbounded)
                    # included, so relax can fully restore it
                    self._budget_tightened = True
                    self._budget_baseline = cur_cfg
                # never RAISE admission while overloaded: an operator
                # budget already below the policy floor stays put
                new = min(
                    cur, max(lo, int(cur * (1.0 - pol.token_budget_step)))
                )
            elif self._budget_tightened:
                # relax only what WE tightened, stepping back up and
                # finally restoring the exact baseline (unbounded again
                # if that is what the operator ran)
                base_cap = (
                    hi if self._budget_baseline is None
                    else self._budget_baseline
                )
                stepped = min(hi, int(cur * (1.0 + pol.token_budget_step)))
                if stepped >= base_cap:
                    new = self._budget_baseline
                    self._budget_tightened = False
                else:
                    new = stepped
            if new != cur_cfg:
                fe.config = dataclasses.replace(
                    fe.config, max_inflight_tokens=new
                )
                self._record(
                    now, AP_RETUNE_BUDGET,
                    "tighten" if tighten else "relax",
                    token_budget=new, was=cur_cfg,
                )
        if pol.prefill_surge_share is not None and (tighten or relax):
            hi = pol.prefill_surge_share
            changed = []
            for h in fe.replicas:
                if h.health in (DEAD, BACKOFF):
                    continue
                sched = h.engine.scheduler
                cur = sched.config.max_prefills_per_tick
                if tighten:
                    # surge to the ceiling to drain the queue faster (a
                    # scheduler the operator set even higher stays put)
                    self._prefill_baseline.setdefault(h.replica_id, cur)
                    target = max(cur, hi)
                else:
                    # restore each scheduler to ITS recorded baseline
                    target = self._prefill_baseline.pop(
                        h.replica_id, cur
                    )
                if cur != target:
                    sched.retune(max_prefills_per_tick=target)
                    changed.append((h.replica_id, target))
            if changed:
                self._record(
                    now, AP_RETUNE_PREFILL,
                    "tighten" if tighten else "relax",
                    changes=tuple(changed),
                )

    # -- rebalance -----------------------------------------------------------

    def _rebalance(self, now: float) -> None:
        pol = self.policy
        fe = self.fe
        if pol.imbalance_factor is None:
            return
        router = fe.router
        if not isinstance(router, PrefixAffinityRouter):
            return
        live = [
            h for h in fe.replicas if h.health not in (DEAD, BACKOFF)
        ]
        if len(live) < 2:
            return
        loads = {h.replica_id: h.load() for h in live}
        mean = sum(loads.values()) / len(loads)
        hot_rid = max(loads, key=lambda rid: (loads[rid], rid))
        imbalanced = mean > 0 and loads[hot_rid] > pol.imbalance_factor * mean
        last = self._last_rebalance_tick
        cooled = last is None or (
            self.ticks - last >= pol.rebalance_cooldown_ticks
        )
        weights = router.weights
        if imbalanced:
            self._balanced_streak = 0
            if not cooled:
                return
            cur = weights.get(hot_rid, 1.0)
            new = max(pol.min_ring_weight, cur / 2.0)
            if new == cur or hot_rid not in weights:
                return
            router.set_weight(hot_rid, new)
            self._last_rebalance_tick = self.ticks
            self._record(
                now, AP_REBALANCE, "imbalance",
                replica=hot_rid, weight=new,
                load=round(loads[hot_rid], 3), fleet_mean=round(mean, 3),
            )
            return
        # balanced: after a full cooldown of balance, restore the most
        # depressed weight one doubling at a time
        self._balanced_streak += 1
        if self._balanced_streak < pol.rebalance_cooldown_ticks:
            return
        depressed = {
            rid: w for rid, w in weights.items()
            if w < 1.0 and rid in loads
        }
        if not depressed or not cooled:
            return
        rid = min(depressed, key=lambda r: (depressed[r], r))
        new = min(1.0, depressed[rid] * 2.0)
        router.set_weight(rid, new)
        self._last_rebalance_tick = self.ticks
        self._balanced_streak = 0
        self._record(
            now, AP_REBALANCE, "restore", replica=rid, weight=new,
        )

    # -- re-role (the fleet's prefill:decode ratio) --------------------------

    def _refuse_role(self, now: float, reason: str, **detail) -> None:
        # one typed refusal per role cooldown window, mirroring
        # _refuse_scale: the log records that a re-role was due and why
        # it could not run, without a refusal per tick
        last = self._last_role_refusal_tick
        if last is not None and (
            self.ticks - last < self.policy.role_cooldown_ticks
        ):
            return
        self._last_role_refusal_tick = self.ticks
        self._refusals(reason).inc()
        self._record(now, AP_REFUSED, reason, **detail)

    def _rerole(self, now: float) -> None:
        """The fourth lever: steer the fleet's prefill:decode role
        ratio.  A sustained prefill-backlog breach re-roles an idle
        mixed daemon to ``prefill``; a sustained decode-ITL breach
        re-roles one to ``decode`` — same breach-streak hysteresis and
        cooldown discipline as scaling, so the ratio cannot flap.  When
        both signals breach, decode ITL wins: it is the client-visible
        stream latency, and more decode capacity also drains the
        prefill queue's downstream."""
        pol = self.policy
        if (
            pol.prefill_backlog_target is None
            and pol.decode_itl_target is None
        ):
            return
        # local import: cluster must not import the fleet package at
        # module scope (fleet imports cluster primitives)
        from tpu_parallel_torch.fleet.roles import ROLE_DECODE, ROLE_PREFILL

        direction = None
        if pol.prefill_backlog_target is not None:
            backlog95 = self._windowed_p95(self._backlog_samples)
            if self._backlog_samples and (
                backlog95 > pol.prefill_backlog_target
            ):
                direction = ("prefill_backlog", ROLE_PREFILL, backlog95)
        if pol.decode_itl_target is not None:
            itl95 = self._windowed_p95(self._itl_samples)
            if self._itl_samples and itl95 > pol.decode_itl_target:
                direction = ("decode_itl", ROLE_DECODE, itl95)
        if direction is None:
            self._role_breach_streak = 0
            self._role_breach_dir = ""
            return
        reason, to_role, p95 = direction
        if reason != self._role_breach_dir:
            # a flipped breach direction restarts the streak — two
            # half-breaches in opposite directions must not actuate
            self._role_breach_dir = reason
            self._role_breach_streak = 1
        else:
            self._role_breach_streak += 1
        if self._role_breach_streak < pol.breach_ticks:
            return
        last = self._last_rerole_tick
        if last is not None and (
            self.ticks - last < pol.role_cooldown_ticks
        ):
            return
        rc = self.role_controller
        if rc is None:
            self._refuse_role(
                now, AP_REFUSED_NO_ROLE_CONTROLLER, wanted=AP_REROLE,
            )
            return
        addr = rc.pick_rerole(to_role)
        if addr is None or not rc.set_role(addr, to_role):
            # no idle mixed daemon to flip (all busy, none mixed, or
            # the candidate vanished between pick and set)
            self._refuse_role(
                now, AP_REFUSED_NO_IDLE_PEER, wanted=AP_REROLE,
                to_role=to_role,
            )
            return
        self._last_rerole_tick = self.ticks
        counts = rc.role_counts()
        self._record(
            now, AP_REROLE, reason, peer=addr, to_role=to_role,
            p95=round(p95, 6),
            **{f"role_{k}": v for k, v in sorted(counts.items())},
        )

    # -- status --------------------------------------------------------------

    def status(self) -> dict:
        """Typed controller state for tooling and ``Frontend.
        autopilot_status()``."""
        fe = self.fe
        return {
            "enabled": True,
            "ticks": self.ticks,
            "shedding": self.shedding,
            "breach_streak": self._breach_streak,
            "clear_streak": self._clear_streak,
            "breach_reason": self._breach_reason or None,
            "queue_age_p95": self._qage_p95(),
            "ttft_p95_window": self._ttft_win.delta_percentile(95),
            "replicas": len(fe.replicas),
            "retired": [h.replica_id for h in fe.retired],
            "token_budget": fe.config.max_inflight_tokens,
            "shed_rejects": int(self._shed_rejects.value),
            "shed_cancels": int(self._shed_cancels.value),
            "window_shed": self._win_shed,
            "ring_weights": (
                fe.router.weights
                if isinstance(fe.router, PrefixAffinityRouter)
                else None
            ),
            "role_breach_streak": self._role_breach_streak,
            "role_breach_dir": self._role_breach_dir or None,
            "role_counts": (
                self.role_controller.role_counts()
                if self.role_controller is not None
                else None
            ),
            "actions": len(self.actions),
        }
