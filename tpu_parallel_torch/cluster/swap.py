"""Zero-downtime rolling weight hot-swap with canary probation and
SLO-guarded automatic rollback.

Shipping a new model to a serving fleet WITHOUT draining it is a
first-class fleet operation: every production engine eventually needs a
checkpoint roll under load.  This module is the cluster's answer —
``Frontend.begin_swap()`` hands a new weight set to a
:class:`SwapController`, which rolls it across the fleet ONE replica at
a time through a five-phase state machine (docs/12_cluster.md draws it):

``EXCLUDED``
    The target is removed from NEW routing (the frontend's dispatch
    filter skips ``ReplicaHandle.swap_excluded``) and its queued
    remainder is pulled back into the frontend backlog, exactly like a
    drain.  In-flight requests keep decoding on the OLD weights — a
    request must never straddle two weight versions mid-stream.  After
    ``SwapPolicy.drain_ticks`` the stragglers are RELOCATED through the
    existing forced-prefix replay path (prompt + delivered tokens onto a
    same-version peer), so greedy output stays bitwise identical to a
    never-swapped run.  Each straggler's written KV blocks are exported
    from the still-live source first (``cluster/migration.py``), so the
    replay's prefill imports blocks instead of recomputing them —
    recompute survives only as a typed, counted fallback.
``SWAPPING``
    The idle engine rebinds to the new params
    (:meth:`~tpu_parallel_torch.serving.engine.ServingEngine.rebind_params`).
    Same names, shapes and dtypes, written in place — so every
    captured CUDA graph is REUSED; the swap never pays a recapture.  A
    COPY of the old params is stashed for rollback.
``CANARY``
    The replica re-enters service through the half-open PROBATION
    gate — at most ``probation_requests`` concurrent requests — acting
    as the new version's canary.  The controller watches it against a
    pre-swap baseline window (:class:`~tpu_parallel_torch.obs.registry.
    HistogramWindow` over the cluster TTFT/E2E histograms), runs a
    greedy logit-fingerprint spot check (one canary-served greedy
    request replayed offline through static ``generate()`` with the new
    weights — a corrupted rebind cannot hide behind healthy latency),
    and requires ``canary_ticks`` clean ticks, ``canary_requests``
    finished requests AND ``canary_seconds`` of injectable-clock time.
    A frozen clock therefore never promotes a canary — the whole
    lifecycle is deterministic and chaos-testable.
``PROMOTED``
    The canary passed: back to HEALTHY, rollout moves to the next
    replica.  When every replica is promoted (or skipped as dead beyond
    recovery) the swap COMPLETES and the new weights become the fleet
    standard — replicas restarting later are rebound to it before they
    re-enter probation, so a post-swap restart can never resurrect the
    old version.
``ROLLED_BACK``
    Any regression — canary death (crash or watchdog kill), TTFT/E2E
    mean beyond ``ttft_factor``/``e2e_factor`` × the pre-swap baseline,
    or a spot-check mismatch — halts the rollout and reverts EVERY
    replica holding the new version back to its stashed old params
    (same exclude → drain → rebind cycle, no canary: the old weights
    are proven).  While the rollback runs, replicas still on the new
    version are blocked from NEW routing, so no fresh request ever
    lands on the abandoned version; the fleet ends 100% on the old
    weights and ``swap_status()`` reports the typed verdict.

A replica that crashes mid-rollout resolves through the normal restart
circuit breaker: the rollout defers it (re-queued until the breaker
brings it back HEALTHY, skipped outright when the breaker is open for
good) and never deadlocks — pinned by the JAX package's chaos harness
(``swap@T`` storms) and ``tests/test_swap.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from tpu_parallel_torch.cluster.replica import (
    BACKOFF,
    DEAD,
    DEGRADED,
    HEALTHY,
    PROBATION,
    ReplicaHandle,
)
from tpu_parallel_torch.obs.registry import HistogramWindow

# per-replica swap phases (the docs/12 state machine)
SWAP_PENDING = "pending"  # queued for the rollout, untouched yet
SWAP_EXCLUDED = "excluded"  # drained of new routing, finishing on old
SWAP_SWAPPING = "swapping"  # idle, params rebinding (transient)
SWAP_CANARY = "canary"  # serving half-open on the new weights
SWAP_PROMOTED = "promoted"  # canary passed; serving the new version
SWAP_ROLLED_BACK = "rolled_back"  # reverted to the old version
SWAP_SKIPPED = "skipped"  # dead beyond recovery; rollout moved on

# controller states
SWAP_ROLLING = "rolling"
SWAP_ROLLING_BACK = "rolling_back"
SWAP_COMPLETED = "completed"
SWAP_STATE_ROLLED_BACK = "rolled_back"

# typed begin_swap refusals (swap_status()["verdict"] on refusal)
SWAP_REFUSED_DRAINING = "draining"
SWAP_REFUSED_IN_PROGRESS = "swap_in_progress"
SWAP_REFUSED_SHAPE = "shape_mismatch"
SWAP_REFUSED_FINGERPRINT = "fingerprint_mismatch"
SWAP_REFUSED_VERSION = "version_in_service"

# typed automatic-rollback verdicts
ROLLBACK_CANARY_DEATH = "canary_death"
ROLLBACK_SLO_TTFT = "slo_ttft"
ROLLBACK_SLO_E2E = "slo_e2e"
ROLLBACK_SPOT_CHECK = "logit_fingerprint"

SWAP_TRACK = "swap"  # the tracer track every swap instant lands on


@dataclasses.dataclass(frozen=True)
class SwapPolicy:
    """Rollout and canary-judgement knobs (docs/12_cluster.md table).

    - ``drain_ticks``: cluster ticks the EXCLUDED target gets to finish
      its in-flight work on the old weights before the stragglers are
      relocated via the forced-prefix replay path.  Generous values keep
      every interrupted stream on one weight version end to end.
    - ``canary_ticks``: minimum CLEAN probation ticks (exception-free,
      not stall-suspect — the same currency as ``probation_ticks``).
    - ``canary_seconds``: minimum time in canary on the frontend's
      INJECTABLE clock.  This is the determinism anchor: a frozen test
      clock can tick forever without promoting a canary.
    - ``canary_requests``: requests that must FINISH on the canary
      before promotion — a canary that served nothing proved nothing.
      Waived only when the CLUSTER is completely idle for a full clean
      window (``canary_ticks`` ticks with zero open work): an idle
      fleet cannot audition anything, and holding the rollout hostage
      to traffic that may never come would wedge every future swap.
    - ``ttft_factor`` / ``e2e_factor``: regression thresholds — the
      canary window's mean TTFT / E2E may not exceed the pre-swap
      baseline mean times this factor (evaluated once both windows hold
      enough samples; see ``baseline_min_requests``).
    - ``baseline_min_requests``: pre-swap observations required before
      the latency SLO is judged at all (an empty baseline judges
      nothing — the canary still needs its clean ticks, requests,
      window and spot check).
    - ``spot_check``: greedy logit-fingerprint audit — the first greedy
      request the canary finishes is replayed offline through static
      ``generate()`` with the NEW weights; any token mismatch means the
      engine is not actually serving the weights the operator shipped
      (corrupted load, wrong rebind) and triggers rollback.
    """

    drain_ticks: int = 16
    canary_ticks: int = 4
    canary_seconds: float = 0.25
    canary_requests: int = 1
    ttft_factor: float = 3.0
    e2e_factor: float = 3.0
    baseline_min_requests: int = 4
    spot_check: bool = True

    def __post_init__(self):
        if self.drain_ticks < 1:
            raise ValueError(f"drain_ticks={self.drain_ticks} < 1")
        if self.canary_ticks < 1:
            raise ValueError(f"canary_ticks={self.canary_ticks} < 1")
        if self.canary_seconds < 0:
            raise ValueError(f"canary_seconds={self.canary_seconds} < 0")
        if self.canary_requests < 1:
            raise ValueError(f"canary_requests={self.canary_requests} < 1")
        if self.ttft_factor <= 1.0 or self.e2e_factor <= 1.0:
            raise ValueError(
                f"ttft_factor={self.ttft_factor} / e2e_factor="
                f"{self.e2e_factor} must be > 1 (a factor <= 1 rolls "
                "back on noise)"
            )
        if self.baseline_min_requests < 1:
            raise ValueError(
                f"baseline_min_requests={self.baseline_min_requests} < 1"
            )


class SwapController:
    """One rolling weight swap in flight (built by ``Frontend.begin_swap``,
    ticked from ``Frontend.step()``).  See the module docstring for the
    state machine; all timing flows through the frontend's injectable
    clock and tick counts, so every trajectory is deterministic."""

    def __init__(self, frontend, to_params, to_version: str,
                 policy: SwapPolicy):
        self.fe = frontend
        self.policy = policy
        self.to_params = to_params
        self.to_version = to_version
        self.state = SWAP_ROLLING
        self.verdict: Optional[str] = None
        self.phase: Dict[int, str] = {
            h.replica_id: SWAP_PENDING for h in frontend.replicas
        }
        self.queue: List[int] = [h.replica_id for h in frontend.replicas]
        self.current: Optional[int] = None
        self.swapped: List[int] = []
        self.old_params: Dict[int, object] = {}
        self.from_versions: Dict[int, str] = {}
        self._drain_left = 0
        # canary bookkeeping
        self.canary: Optional[int] = None
        self._canary_entered = 0.0
        self.canary_finished = 0
        self._canary_idle = 0  # consecutive canary ticks with zero work
        self._spot_candidate = None  # (attempt_prompt, continuation)
        self._spot_checked = False
        # rollback bookkeeping
        self._revert_current: Optional[int] = None
        self._revert_drain_left = 0
        # pre-swap latency baseline: windows captured NOW over the
        # frontend's cumulative histograms — base_mean() is the "before"
        r = frontend.registry
        self._base_ttft = HistogramWindow(frontend._ttft)
        self._base_e2e = HistogramWindow(frontend._e2e)
        self._c_ttft = r.histogram("cluster_swap_canary_ttft_seconds")
        self._c_e2e = r.histogram("cluster_swap_canary_e2e_seconds")
        self._c_ttft_win = HistogramWindow(self._c_ttft)
        self._c_e2e_win = HistogramWindow(self._c_e2e)
        self._swaps = r.counter("cluster_swaps_total")
        self._rollbacks = r.counter("cluster_swap_rollbacks_total")
        self._rebinds = r.counter("cluster_swap_rebinds_total")
        self._replica_swaps = r.counter(
            "cluster_swap_replicas_swapped_total"
        )
        self._relocations = r.counter("cluster_swap_relocations_total")

    # -- public surface the frontend consults ------------------------------

    @property
    def active(self) -> bool:
        return self.state in (SWAP_ROLLING, SWAP_ROLLING_BACK)

    def blocked(self, handle: ReplicaHandle) -> bool:
        """True when NEW requests must not route to ``handle``: during a
        rollback every replica still holding the abandoned version is
        off limits — zero mixed-version routing for fresh work."""
        return (
            self.state == SWAP_ROLLING_BACK
            and handle.weights_version == self.to_version
        )

    def gates_probation(self, handle: ReplicaHandle) -> bool:
        """True when the frontend's generic probation promotion must
        defer to this controller: the canary is promoted by the canary
        policy alone, and a replica awaiting rollback must not be
        promoted into traffic it is about to lose."""
        if not self.active:
            return False
        return handle.replica_id == self.canary or self.blocked(handle)

    def status_dict(self) -> dict:
        fe = self.fe
        return {
            "state": self.state,
            "verdict": self.verdict,
            "to_version": self.to_version,
            "from_versions": dict(self.from_versions),
            "replica_phase": dict(self.phase),
            "replica_versions": {
                h.replica_id: h.weights_version for h in fe.replicas
            },
            "current": self.current,
            "canary": self.canary,
            "swapped": list(self.swapped),
            "canary_finished": self.canary_finished,
            "baseline_ttft_mean": self._base_ttft.base_mean(),
            "baseline_e2e_mean": self._base_e2e.base_mean(),
            "canary_ttft_mean": self._c_ttft_win.delta_mean(),
            "canary_e2e_mean": self._c_e2e_win.delta_mean(),
        }

    # -- frontend event hooks ----------------------------------------------

    def note_finish(self, st, now: float) -> None:
        """A cluster request finished; if its final attempt ran on the
        canary, fold its latency into the canary window and (greedy
        requests) arm the logit-fingerprint spot check."""
        if self.canary is None or st.handle is None:
            return
        if st.handle.replica_id != self.canary:
            return
        ttft = st.out.ttft
        if ttft is not None:
            self._c_ttft.observe(ttft)
        if st.out.arrival_time is not None:
            self._c_e2e.observe(now - st.out.arrival_time)
        self.canary_finished += 1
        if (
            self.policy.spot_check
            and self._spot_candidate is None
            and st.out.request.sampling.temperature == 0.0
            and len(st.out.tokens) > st.base
        ):
            # the canary ATTEMPT's context and continuation: replayed
            # offline with the new weights, greedy decode must agree
            # token for token
            attempt_prompt = (
                list(st.out.request.prompt) + list(st.out.tokens[: st.base])
            )
            self._spot_candidate = (
                attempt_prompt, list(st.out.tokens[st.base:]),
            )

    def on_death(self, replica_id: int) -> None:
        """A replica died (crash / watchdog kill — the frontend already
        replayed its orphans and consulted the breaker).  The rollout's
        reaction depends on who died."""
        if not self.active:
            return
        if replica_id == self.canary:
            # the canary failed its audition in the loudest possible way
            self.canary = None
            self.current = None
            self.phase[replica_id] = SWAP_ROLLED_BACK  # restart = old wts
            self._begin_rollback(ROLLBACK_CANARY_DEATH)
            return
        h = self.fe._handle(replica_id)
        if replica_id == self.current:
            # mid-exclusion/swap crash: the breaker owns the corpse; the
            # rollout defers the target and retries once it returns
            h.swap_excluded = False
            self.phase[replica_id] = SWAP_PENDING
            self.current = None
            if replica_id not in self.queue:
                self.queue.append(replica_id)
            if self.fe.tracer.enabled:
                self.fe.tracer.instant(
                    "swap_defer", track=SWAP_TRACK, replica=replica_id,
                )
            return
        if replica_id == self._revert_current:
            # a dead revert target reverts by construction: its restart
            # rebuilds from the factory's (old) weights
            h.swap_excluded = False
            self.phase[replica_id] = SWAP_ROLLED_BACK
            self._revert_current = None
            return
        if (
            self.state == SWAP_ROLLING
            and self.phase.get(replica_id) == SWAP_PROMOTED
        ):
            # a promoted replica's restart resurrects the OLD weights
            # (engine_factory predates the swap) — re-queue it so the
            # rollout swaps the fresh incarnation again
            if replica_id in self.swapped:
                self.swapped.remove(replica_id)
            self.phase[replica_id] = SWAP_PENDING
            if replica_id not in self.queue:
                self.queue.append(replica_id)

    # -- the tick -----------------------------------------------------------

    def tick(self, now: float) -> None:
        if self.state == SWAP_ROLLING:
            self._tick_forward(now)
        elif self.state == SWAP_ROLLING_BACK:
            self._tick_rollback(now)

    def _tick_forward(self, now: float) -> None:
        fe = self.fe
        if self.current is not None:
            h = fe._handle(self.current)
            if h.health in (DEAD, BACKOFF):
                # belt and braces: on_death defers synchronously, but a
                # health flip outside the death path must not wedge us
                self.on_death(self.current)
            else:
                ph = self.phase[self.current]
                if ph == SWAP_EXCLUDED:
                    if not h.engine.has_work():
                        self._swap_in(h, now)
                    else:
                        self._drain_left -= 1
                        if self._drain_left <= 0:
                            self._relocate_open(h)
                            self._swap_in(h, now)
                elif ph == SWAP_CANARY:
                    self._tick_canary(h, now)
            # a canary verdict may have flipped the state mid-tick
            # (rollback): only a still-ROLLING swap picks a next target
            if self.current is not None or self.state != SWAP_ROLLING:
                return
        self._pick_next_target(now)

    def _pick_next_target(self, now: float) -> None:
        fe = self.fe
        while self.queue:
            ready = next(
                (
                    rid
                    for rid in self.queue
                    if fe._handle(rid).health in (HEALTHY, DEGRADED)
                ),
                None,
            )
            if ready is not None:
                self.queue.remove(ready)
                self.current = ready
                self._begin_exclude(fe._handle(ready))
                return
            # nothing swappable right now: drop targets the breaker gave
            # up on (dead forever), wait for the rest (BACKOFF/PROBATION
            # resolve through the normal restart machinery)
            dropped = False
            for rid in list(self.queue):
                h = fe._handle(rid)
                if h.health == DEAD and not fe._restartable(h):
                    self.queue.remove(rid)
                    self.phase[rid] = SWAP_SKIPPED
                    dropped = True
                    if fe.tracer.enabled:
                        fe.tracer.instant(
                            "swap_skip", track=SWAP_TRACK, replica=rid,
                        )
            if not dropped:
                return  # targets pending recovery: retry next tick
        self._complete()

    def _begin_exclude(self, h: ReplicaHandle) -> None:
        fe = self.fe
        self.phase[h.replica_id] = SWAP_EXCLUDED
        h.swap_excluded = True
        self._drain_left = self.policy.drain_ticks
        # queued work has no version stake yet and must not wait out the
        # target's exclusion — same relocation move as drain()
        fe._pull_back_queued(h)
        if fe.tracer.enabled:
            fe.tracer.instant(
                "swap_exclude", track=SWAP_TRACK, replica=h.replica_id,
                in_flight=h.engine.in_flight,
            )

    def _relocate_open(self, h: ReplicaHandle) -> None:
        """Forced-prefix relocation of the target's remaining in-flight
        work: each open request is cancelled in the engine (slot freed)
        and requeued at the frontend, whose next dispatch replays it
        with ``prompt + delivered`` onto a peer — greedy output bitwise
        identical, nothing re-streamed, and NO retry counted (a swap is
        an operator action, not a fault).  The source engine is ALIVE
        here (unlike a crash), so each relocated request's written KV
        blocks are captured first (``cluster/migration.py``) and the
        replay's prefill becomes a block import instead of a recompute —
        the continuation stays bitwise identical either way."""
        fe = self.fe
        for eout in h.orphans():
            erid = eout.request.request_id
            h.forget(erid)
            st = fe._by_attempt.pop(erid, None)
            if st is None or st.out.done:
                continue
            # export BEFORE the cancel: the cancel releases the slot and
            # frees its blocks
            fe._capture_relocation_kv(st, h, erid)
            # detach BEFORE the engine cancel: the attempt's terminal
            # notification then no-ops in the frontend callback
            st.handle = None
            st.engine_rid = None
            h.engine.cancel(erid, reason="swap_relocate")
            fe._requeued.inc()
            self._relocations.inc()
            fe._pending.append(st)
            if fe.tracer.enabled:
                fe.tracer.instant(
                    "swap_relocate", track=SWAP_TRACK,
                    request_id=st.out.request.request_id,
                    replica=h.replica_id, delivered=len(st.out.tokens),
                )

    def _swap_in(self, h: ReplicaHandle, now: float) -> None:
        """The idle target rebinds to the new weights and re-enters
        service half-open as the canary."""
        fe = self.fe
        rid = h.replica_id
        self.phase[rid] = SWAP_SWAPPING
        if rid not in self.old_params:
            # a COPY: ``rebind_params`` writes into the model's own
            # tensors, so a stash aliasing them would "roll back" to the
            # new weights
            self.old_params[rid] = {
                k: v.detach().clone() for k, v in h.engine.params.items()
            }
            self.from_versions[rid] = h.weights_version
        h.engine.rebind_params(self.to_params, version=self.to_version)
        self._rebinds.inc()
        h.swap_excluded = False
        h.health = PROBATION
        rec = fe._recovery[rid]
        rec.probation = True
        rec.clean_ticks = 0
        rec.stall_ticks = 0
        self.phase[rid] = SWAP_CANARY
        self.canary = rid
        self._canary_entered = now
        self.canary_finished = 0
        self._canary_idle = 0
        self._spot_candidate = None
        self._spot_checked = False
        self._c_ttft_win = HistogramWindow(self._c_ttft)
        self._c_e2e_win = HistogramWindow(self._c_e2e)
        if fe.tracer.enabled:
            fe.tracer.instant(
                "swap_rebind", track=SWAP_TRACK, replica=rid,
                version=self.to_version,
            )

    def _tick_canary(self, h: ReplicaHandle, now: float) -> None:
        fe = self.fe
        rid = h.replica_id
        if h.health in (DEAD, BACKOFF):
            self.on_death(rid)
            return
        pol = self.policy
        # logit-fingerprint spot check: the canary's own greedy output
        # replayed offline with the weights the operator SHIPPED — a
        # scrambled load diverges here even when its latency looks fine
        if (
            pol.spot_check
            and self._spot_candidate is not None
            and not self._spot_checked
        ):
            if not self._run_spot_check(h):
                self._begin_rollback(ROLLBACK_SPOT_CHECK)
                return
            self._spot_checked = True
        # latency SLO vs the pre-swap baseline window
        if self._base_ttft.base_count() >= pol.baseline_min_requests:
            base = self._base_ttft.base_mean()
            cm = self._c_ttft_win.delta_mean()
            if (
                base is not None
                and cm is not None
                and self._c_ttft_win.delta_count() >= pol.canary_requests
                and cm > base * pol.ttft_factor
            ):
                self._begin_rollback(ROLLBACK_SLO_TTFT)
                return
        if self._base_e2e.base_count() >= pol.baseline_min_requests:
            base = self._base_e2e.base_mean()
            cm = self._c_e2e_win.delta_mean()
            if (
                base is not None
                and cm is not None
                and self._c_e2e_win.delta_count() >= pol.canary_requests
                and cm > base * pol.e2e_factor
            ):
                self._begin_rollback(ROLLBACK_SLO_E2E)
                return
        if fe.has_work():
            self._canary_idle = 0
        else:
            self._canary_idle += 1
        rec = fe._recovery[rid]
        if (
            rec.clean_ticks >= pol.canary_ticks
            and (now - self._canary_entered) >= pol.canary_seconds
            and (
                self.canary_finished >= pol.canary_requests
                # a completely idle cluster cannot audition a canary:
                # a full clean window with zero open work promotes on
                # ticks + time alone instead of wedging the rollout
                or self._canary_idle >= pol.canary_ticks
            )
            and not (
                pol.spot_check
                and self._spot_candidate is not None
                and not self._spot_checked
            )
        ):
            h.health = HEALTHY
            rec.probation = False
            rec.failures = 0
            self.phase[rid] = SWAP_PROMOTED
            self.swapped.append(rid)
            self._replica_swaps.inc()
            self.canary = None
            self.current = None
            if fe.tracer.enabled:
                fe.tracer.instant(
                    "swap_promote", track=SWAP_TRACK, replica=rid,
                    clean_ticks=rec.clean_ticks,
                    canary_finished=self.canary_finished,
                )

    def _run_spot_check(self, h: ReplicaHandle) -> bool:
        import torch

        from tpu_parallel_torch.models.generate import generate

        prompt, continuation = self._spot_candidate
        model = h.engine.model
        # the offline replay runs a twin holding the NEW weights, not the
        # canary's own model: the audit then also catches a rebind that
        # left the served tensors short of ``to_params``.  The port's
        # model has no paged variant (paging is the engine's), so the
        # twin is the served config; paged-vs-fixed greedy parity is
        # pinned by tests/test_torch_paged_kv.py
        twin = type(model)(model.config, device=model.device, seed=None)
        twin.load_state_dict(self.to_params)
        ref = generate(
            twin,
            torch.tensor([list(prompt)], dtype=torch.long, device=model.device),
            max_new_tokens=len(continuation),
        )[0].tolist()
        del twin
        ok = [int(t) for t in ref[: len(continuation)]] == [
            int(t) for t in continuation
        ]
        if self.fe.tracer.enabled:
            self.fe.tracer.instant(
                "swap_spot_check", track=SWAP_TRACK,
                replica=h.replica_id, tokens=len(continuation), ok=ok,
            )
        return ok

    # -- rollback -----------------------------------------------------------

    def _begin_rollback(self, reason: str) -> None:
        fe = self.fe
        self.state = SWAP_ROLLING_BACK
        self.verdict = reason
        self.canary = None
        self.current = None
        self._revert_current = None
        self._rollbacks.inc()
        if fe.tracer.enabled:
            fe.tracer.instant(
                "swap_rollback", track=SWAP_TRACK, reason=reason,
                swapped=len(self.swapped),
            )

    def _tick_rollback(self, now: float) -> None:
        fe = self.fe
        if self._revert_current is not None:
            h = fe._handle(self._revert_current)
            if h.health in (DEAD, BACKOFF):
                self.on_death(self._revert_current)
            elif not h.engine.has_work():
                self._revert(h)
            else:
                self._revert_drain_left -= 1
                if self._revert_drain_left <= 0:
                    self._relocate_open(h)
                    self._revert(h)
            if self._revert_current is not None:
                return
        for h in fe.replicas:
            if h.health in (DEAD, BACKOFF):
                continue  # a restart reverts by construction (factory)
            if h.weights_version == self.to_version:
                self._revert_current = h.replica_id
                self._revert_drain_left = self.policy.drain_ticks
                h.swap_excluded = True
                fe._pull_back_queued(h)
                if fe.tracer.enabled:
                    fe.tracer.instant(
                        "swap_revert_begin", track=SWAP_TRACK,
                        replica=h.replica_id,
                    )
                return
        # nothing live still holds the new version: rollback complete
        self.state = SWAP_STATE_ROLLED_BACK
        if fe.tracer.enabled:
            fe.tracer.instant(
                "swap_rolled_back", track=SWAP_TRACK, verdict=self.verdict,
            )

    def _revert(self, h: ReplicaHandle) -> None:
        fe = self.fe
        rid = h.replica_id
        old = self.old_params.get(rid)
        if old is not None:
            h.engine.rebind_params(
                old, version=self.from_versions.get(rid, "initial")
            )
            self._rebinds.inc()
        h.swap_excluded = False
        if h.health == PROBATION:
            # the reverted weights are the proven ones — no new audition
            h.health = HEALTHY
        rec = fe._recovery[rid]
        rec.probation = False
        self.phase[rid] = SWAP_ROLLED_BACK
        self._revert_current = None
        if fe.tracer.enabled:
            fe.tracer.instant(
                "swap_revert", track=SWAP_TRACK, replica=rid,
            )

    # -- completion ---------------------------------------------------------

    def _complete(self) -> None:
        fe = self.fe
        self.state = SWAP_COMPLETED
        self.verdict = "completed"
        self.current = None
        self.canary = None
        self._swaps.inc()
        # the new weights are now the fleet standard: replicas restarting
        # later (factory = OLD params) are rebound before re-entering
        # service, so a post-swap restart cannot resurrect the old version
        fe._fleet_weights = (self.to_version, self.to_params)
        if fe.tracer.enabled:
            fe.tracer.instant(
                "swap_complete", track=SWAP_TRACK,
                version=self.to_version, swapped=len(self.swapped),
                skipped=sum(
                    1 for p in self.phase.values() if p == SWAP_SKIPPED
                ),
            )
