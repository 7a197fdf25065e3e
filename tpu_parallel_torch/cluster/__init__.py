"""Replicated serving cluster: a router + admission-control frontend
driving N continuous-batching engine replicas with a fault-tolerant
request lifecycle (docs/12_cluster.md).  A copy of ``tpu_parallel/cluster``
(plain Python) bound to the port's :class:`ServingEngine`.

``Frontend.submit()/step()/drain()`` is the whole surface: pluggable
routing (round-robin / least-loaded / prefix-affinity consistent
hashing), token-budget backpressure with typed rejections, priority
classes with anti-starvation aging, per-request deadlines that cancel
in-engine work, and replica-death retries that replay delivered tokens
as a forced prefix so streamed output stays exactly consistent.

The cluster SELF-HEALS: a progress watchdog detects stalled replicas
from observed no-progress (degrade, then kill + replay), and dead
replicas carrying an ``engine_factory`` are rebuilt under a
:class:`RestartPolicy` circuit breaker — exponential backoff, half-open
probation, promotion back to healthy.


The cluster DEFENDS ITSELF against sustained overload: the SLO
autopilot (``cluster/autopilot.py``, armed via
``Frontend.enable_autopilot``) watches the queue-age and TTFT windows
and — with explicit hysteresis — sheds a bounded lowest-priority slice
(typed ``shed``), resizes the fleet through the probation gate, retunes
the admission token budget and prefill tick share, and rebalances the
prefix-affinity ring, logging every decision as a typed
:class:`AutopilotAction`.

The cluster MIGRATES KV instead of recomputing it: relocation paths
with a live source (the swap rollout's drain-timeout relocation) export
a moved request's written KV blocks and import them into the target
replica's prefix cache (``cluster/migration.py`` over the
``serving/kv_hierarchy.py`` export format), so the forced-prefix replay
hits instead of re-prefilling — bitwise-identical continuation, with
recompute surviving only as a typed, counted fallback; autopilot
scale-ups reuse the same primitive to warm-start newcomers' caches.

The cluster also ships NEW WEIGHTS under load: ``Frontend.begin_swap``
rolls a versioned weight set across the fleet one replica at a time
(``cluster/swap.py`` — exclusion, drain-or-relocate, recapture-free
rebind, canary probation), with a :class:`SwapPolicy` watching the
canary against a pre-swap latency baseline and a logit-fingerprint spot
check, rolling the whole fleet back automatically on regression.
"""

from tpu_parallel_torch.cluster.autopilot import (
    AP_REBALANCE,
    AP_REFUSED,
    AP_REFUSED_MAX_REPLICAS,
    AP_REFUSED_NO_FACTORY,
    AP_REFUSED_NO_IDLE_PEER,
    AP_REFUSED_NO_ROLE_CONTROLLER,
    AP_REFUSED_SWAP,
    AP_REROLE,
    AP_RETUNE_BUDGET,
    AP_RETUNE_PREFILL,
    AP_SCALE_DOWN,
    AP_SCALE_UP,
    AP_SHED_CANCEL,
    AP_SHED_OFF,
    AP_SHED_ON,
    AUTOPILOT_TRACK,
    Autopilot,
    AutopilotAction,
    AutopilotPolicy,
)
from tpu_parallel_torch.cluster.frontend import (
    ClusterOutput,
    Frontend,
    FrontendConfig,
)
from tpu_parallel_torch.cluster.replica import (
    BACKOFF,
    DEAD,
    DEGRADED,
    HEALTHY,
    PROBATION,
    RETIRED,
    FaultPlan,
    ReplicaDead,
    ReplicaHandle,
    RestartPolicy,
)
from tpu_parallel_torch.cluster.migration import (
    land_exports,
    MIGRATION_STATUSES,
    capture_kv,
    install_kv,
    warm_start,
)
from tpu_parallel_torch.cluster.router import (
    HashRing,
    LeastLoadedRouter,
    PrefixAffinityRouter,
    RoundRobinRouter,
    Router,
    hash_prompt_key,
    least_loaded,
    make_router,
    prefix_route_key,
)
from tpu_parallel_torch.cluster.swap import (
    ROLLBACK_CANARY_DEATH,
    ROLLBACK_SLO_E2E,
    ROLLBACK_SLO_TTFT,
    ROLLBACK_SPOT_CHECK,
    SWAP_CANARY,
    SWAP_COMPLETED,
    SWAP_EXCLUDED,
    SWAP_PROMOTED,
    SWAP_REFUSED_DRAINING,
    SWAP_REFUSED_FINGERPRINT,
    SWAP_REFUSED_IN_PROGRESS,
    SWAP_REFUSED_SHAPE,
    SWAP_REFUSED_VERSION,
    SWAP_ROLLED_BACK,
    SWAP_ROLLING,
    SWAP_ROLLING_BACK,
    SwapController,
    SwapPolicy,
)

__all__ = [
    "Autopilot",
    "AutopilotAction",
    "AutopilotPolicy",
    "AP_SHED_ON",
    "AP_SHED_OFF",
    "AP_SHED_CANCEL",
    "AP_SCALE_UP",
    "AP_SCALE_DOWN",
    "AP_RETUNE_BUDGET",
    "AP_RETUNE_PREFILL",
    "AP_REBALANCE",
    "AP_REFUSED",
    "AP_REFUSED_SWAP",
    "AP_REFUSED_MAX_REPLICAS",
    "AP_REFUSED_NO_FACTORY",
    "AP_REFUSED_NO_IDLE_PEER",
    "AP_REFUSED_NO_ROLE_CONTROLLER",
    "AP_REROLE",
    "AUTOPILOT_TRACK",
    "RETIRED",
    "Frontend",
    "FrontendConfig",
    "ClusterOutput",
    "ReplicaHandle",
    "ReplicaDead",
    "FaultPlan",
    "RestartPolicy",
    "HEALTHY",
    "DEGRADED",
    "DEAD",
    "BACKOFF",
    "PROBATION",
    "Router",
    "RoundRobinRouter",
    "LeastLoadedRouter",
    "PrefixAffinityRouter",
    "HashRing",
    "hash_prompt_key",
    "least_loaded",
    "make_router",
    "prefix_route_key",
    "MIGRATION_STATUSES",
    "capture_kv",
    "install_kv",
    "land_exports",
    "warm_start",
    "SwapController",
    "SwapPolicy",
    "SWAP_CANARY",
    "SWAP_COMPLETED",
    "SWAP_EXCLUDED",
    "SWAP_PROMOTED",
    "SWAP_ROLLED_BACK",
    "SWAP_ROLLING",
    "SWAP_ROLLING_BACK",
    "SWAP_REFUSED_DRAINING",
    "SWAP_REFUSED_FINGERPRINT",
    "SWAP_REFUSED_IN_PROGRESS",
    "SWAP_REFUSED_SHAPE",
    "SWAP_REFUSED_VERSION",
    "ROLLBACK_CANARY_DEATH",
    "ROLLBACK_SLO_E2E",
    "ROLLBACK_SLO_TTFT",
    "ROLLBACK_SPOT_CHECK",
]
