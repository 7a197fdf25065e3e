"""Pluggable request routing across serving replicas.

Three policies, one contract: ``route(prompt, candidates)`` returns the
replica to try first (or None when no candidate exists).  ``candidates``
is the frontend's pre-filtered view — alive, accepting, not excluded for
this request — ordered by replica id, so policies stay pure ranking
logic with no health bookkeeping of their own.

- :class:`RoundRobinRouter` — the baseline: cycle the candidate list.
  Ignores load AND locality; every comparison in ``SERVE_r03.json``
  starts here.
- :class:`LeastLoadedRouter` — rank by :meth:`ReplicaHandle.load`
  (queue depth + active slots + discounted pending prefill tokens),
  ties to the lowest replica id.  The right default when prompts share
  nothing.
- :class:`PrefixAffinityRouter` — SGLang-style cache-aware routing:
  consistent-hash the request's BUCKET-ALIGNED prompt prefix onto a
  replica, so repeated prefixes (system prompts, few-shot headers) land
  where that replica's :class:`~tpu_parallel_torch.serving.prefix_cache.
  PrefixCache` already holds their K/V.  Two properties matter and both
  come from the hash RING (not ``hash(prefix) % n``):

  * **Stability under failure** — when a replica dies, only the keys it
    owned move (to their ring successors); every other prefix keeps its
    replica and its warm cache.  Modulo hashing would reshuffle nearly
    everything on any membership change.
  * **Deterministic placement** — positions come from ``sha1``, not
    Python's salted ``hash``, so placement is identical across processes
    and runs (routing tests and multi-frontend deployments see one map).

  Affinity yields to load: when the hash-owner is OVERLOADED (queue
  depth at/over ``overload_queue_depth``), the router falls back to
  least-loaded — a hot prefix must not melt one replica while its peers
  idle.  Fallbacks are counted (``fallbacks``) and surface in the
  frontend's ``cluster_affinity_fallbacks`` gauge.

The prefix key mirrors :meth:`PrefixCache.lookup` alignment: the largest
bucket STRICTLY shorter than the prompt (a full-prompt hit can't exist —
the first sampled token needs the last real token's forward pass), whole
prompt when no bucket is shorter.  Aligning router and cache on the same
boundary is the point: the router's unit of placement is exactly the
cache's unit of reuse.
"""

from __future__ import annotations

import bisect
import hashlib
from typing import List, Optional, Sequence, Tuple

from tpu_parallel_torch.cluster.replica import ReplicaHandle


def prefix_route_key(
    prompt: Sequence[int], buckets: Optional[Sequence[int]]
) -> Tuple[int, ...]:
    """The bucket-aligned placement key for ``prompt``: its largest
    proper bucket-prefix (the longest prefix a :class:`PrefixCache`
    could ever serve), or the whole prompt when every bucket is too
    long / no buckets exist."""
    prompt = tuple(int(t) for t in prompt)
    if buckets:
        for b in sorted(buckets, reverse=True):
            if b < len(prompt):
                return prompt[:b]
    return prompt


def _stable_hash(data: bytes) -> int:
    """Process-stable 64-bit hash (sha1 prefix) — Python's ``hash`` is
    salted per process and would scramble placement every run."""
    return int.from_bytes(hashlib.sha1(data).digest()[:8], "big")


def hash_prompt_key(
    prompt: Sequence[int], buckets: Optional[Sequence[int]]
) -> int:
    """Ring position of a prompt: the stable hash of its bucket-aligned
    prefix key.  One function because TWO ring users must agree on it —
    the in-process :class:`PrefixAffinityRouter` and the fleet router
    placing the same prompt onto daemon processes (a disagreement would
    send a prefix to one replica's cache and its retries to another's)."""
    key = prefix_route_key(prompt, buckets)
    return _stable_hash(
        b"".join(int(t).to_bytes(8, "big", signed=True) for t in key)
    )


class HashRing:
    """The consistent-hash ring itself, transport-agnostic: members are
    any stable ids (in-process replica ints, fleet daemon ``host:port``
    strings), positions come from ``sha1(f"{member}:{vnode}")``, and
    lookups take a precomputed key hash — the ring neither knows nor
    cares what a member or a key IS.

    Extracted from :class:`PrefixAffinityRouter` (which now delegates)
    so the fleet router reuses the exact placement function, weighted
    membership and all: the stability argument — only a joining/leaving
    member's keys move, a down-weighted member keeps its LOWEST vnode
    indices so restored weight restores exactly the keys that left — is
    proven once and inherited everywhere.
    """

    def __init__(self, members, vnodes: int = 64):
        if not members:
            raise ValueError("HashRing needs at least 1 member")
        if vnodes < 1:
            raise ValueError(f"vnodes={vnodes} < 1")
        self.vnodes = vnodes
        self._weights = {m: 1.0 for m in members}
        if len(self._weights) != len(members):
            raise ValueError(f"duplicate ring members in {members!r}")
        self._rebuild()

    def _rebuild(self) -> None:
        ring = []
        for member in sorted(self._weights):
            # a weighted member keeps its LOWEST vnode indices, so
            # raising the weight back restores exactly the keys that
            # left (placement stays a pure function of the weight map)
            n = max(1, int(round(self.vnodes * self._weights[member])))
            for v in range(n):
                ring.append((_stable_hash(f"{member}:{v}".encode()), member))
        ring.sort()
        self._ring_points = [p for p, _ in ring]
        self._ring_members = [m for _, m in ring]

    @property
    def weights(self) -> dict:
        """Current per-member ring weights (1.0 = full vnode share)."""
        return dict(self._weights)

    def __contains__(self, member) -> bool:
        return member in self._weights

    def __len__(self) -> int:
        return len(self._weights)

    def set_weight(self, member, weight: float) -> None:
        """Rebalance: scale one member's share of the ring (0 < w <= 1)."""
        if not 0.0 < weight <= 1.0:
            raise ValueError(f"ring weight {weight} outside (0, 1]")
        if member not in self._weights:
            raise ValueError(f"{member!r} not on the ring")
        self._weights[member] = weight
        self._rebuild()

    def add_member(self, member, weight: float = 1.0) -> None:
        """Join the ring (no-op when already a member) — only keys whose
        nearest point is one of the NEW vnodes move."""
        if not 0.0 < weight <= 1.0:
            raise ValueError(f"ring weight {weight} outside (0, 1]")
        self._weights.setdefault(member, weight)
        self._rebuild()

    def remove_member(self, member) -> None:
        """Leave the ring; the retiree's keys slide to their ring
        successors, everyone else keeps a warm cache."""
        if len(self._weights) <= 1:
            raise ValueError("cannot remove the last ring member")
        self._weights.pop(member, None)
        self._rebuild()

    def owner(self, key_hash: int):
        """The member owning ``key_hash``, ignoring health — the stable
        answer to "where does this key live?"."""
        i = bisect.bisect_right(self._ring_points, key_hash)
        return self._ring_members[i % len(self._ring_members)]

    def walk(self, key_hash: int):
        """Yield DISTINCT members in ring order starting at the key's
        owner — the retry-with-exclusion order: callers take the first
        member that is routable/not excluded, so keys of dead members
        slide to their successors while every other key keeps its home."""
        start = bisect.bisect_right(self._ring_points, key_hash)
        n = len(self._ring_members)
        seen = set()
        for off in range(n):
            member = self._ring_members[(start + off) % n]
            if member not in seen:
                seen.add(member)
                yield member


class Router:
    """Routing-policy contract (and registry of the built-in names)."""

    name = "base"

    def route(
        self,
        prompt: Sequence[int],
        candidates: List[ReplicaHandle],
    ) -> Optional[ReplicaHandle]:
        raise NotImplementedError


class RoundRobinRouter(Router):
    """Cycle through candidates in replica-id order, one per decision."""

    name = "rr"

    def __init__(self):
        self._next = 0

    def route(self, prompt, candidates):
        if not candidates:
            return None
        pick = candidates[self._next % len(candidates)]
        self._next += 1
        return pick


def least_loaded(candidates: List[ReplicaHandle]) -> Optional[ReplicaHandle]:
    if not candidates:
        return None
    return min(candidates, key=lambda h: (h.load(), h.replica_id))


class LeastLoadedRouter(Router):
    """Lowest ``load()`` wins; ties break to the lowest replica id so
    placement is deterministic."""

    name = "least"

    def route(self, prompt, candidates):
        return least_loaded(candidates)


class PrefixAffinityRouter(Router):
    """Consistent-hash placement on the bucket-aligned prompt prefix,
    least-loaded fallback on overload (see the module docstring).

    ``replica_ids`` fixes the INITIAL ring membership (every replica the
    cluster was built with, dead or alive — health never changes the
    ring, only which owners are currently routable).  ``vnodes`` virtual
    nodes per replica smooth the key distribution; 64 keeps per-replica
    share within a few percent of fair for any realistic replica count.

    The ring is additionally WEIGHTED and membership-mutable — the
    cluster autopilot's rebalance/scale actuators: ``set_weight(rid, w)``
    shrinks a hot replica's vnode count to ``round(vnodes * w)`` (its
    HIGHEST-index vnodes are dropped, so every key still owned by a
    surviving vnode keeps its home — the consistent-hashing property the
    ring exists for), and ``add_replica`` / ``remove_replica`` grow and
    shrink membership when the autopilot resizes the fleet (again only
    the joining/leaving replica's keys move).
    """

    name = "prefix"

    def __init__(
        self,
        replica_ids: Sequence[int],
        buckets: Optional[Sequence[int]] = None,
        vnodes: int = 64,
        overload_queue_depth: int = 8,
    ):
        if not replica_ids:
            raise ValueError("PrefixAffinityRouter needs at least 1 replica")
        self.buckets = tuple(buckets) if buckets else None
        self.overload_queue_depth = overload_queue_depth
        self.vnodes = vnodes
        self.fallbacks = 0  # affinity target overloaded -> least-loaded
        self.ring = HashRing([int(rid) for rid in replica_ids], vnodes)

    @property
    def weights(self) -> dict:
        """Current per-replica ring weights (1.0 = full vnode share)."""
        return self.ring.weights

    def set_weight(self, replica_id: int, weight: float) -> None:
        """Rebalance: scale one replica's share of the ring (0 < w <= 1).
        The autopilot halves a hot replica's weight when its load runs
        past ``imbalance_factor`` x the fleet mean, and restores it once
        the fleet is balanced again."""
        try:
            self.ring.set_weight(int(replica_id), weight)
        except ValueError as exc:
            if "not on the ring" in str(exc):
                raise ValueError(
                    f"replica {replica_id} not on the ring"
                ) from None
            raise

    def add_replica(self, replica_id: int, weight: float = 1.0) -> None:
        """Scale-up: join the ring (no-op when already a member) — only
        keys whose nearest point is one of the NEW vnodes move."""
        self.ring.add_member(int(replica_id), weight)

    def remove_replica(self, replica_id: int) -> None:
        """Scale-down: leave the ring; the retiree's keys slide to their
        ring successors, everyone else keeps a warm cache."""
        self.ring.remove_member(int(replica_id))

    def owner(self, prompt: Sequence[int]) -> int:
        """The ring owner of this prompt's prefix key, ignoring health —
        the stable answer to "where does this prefix live?"."""
        return self.ring.owner(hash_prompt_key(prompt, self.buckets))

    def route(self, prompt, candidates):
        if not candidates:
            return None
        # walk the ring clockwise; first ROUTABLE owner wins, so keys of
        # dead/excluded replicas slide to their successors while every
        # other key keeps its home
        by_id = {c.replica_id: c for c in candidates}
        pick = None
        for rid in self.ring.walk(hash_prompt_key(prompt, self.buckets)):
            if rid in by_id:
                pick = by_id[rid]
                break
        if pick is None:
            return None
        if pick.queue_depth >= self.overload_queue_depth:
            self.fallbacks += 1
            return least_loaded(candidates)
        return pick


def make_router(
    policy: str,
    replica_ids: Sequence[int],
    buckets: Optional[Sequence[int]] = None,
    **kwargs,
) -> Router:
    """Build a router by policy name (``rr`` / ``least`` / ``prefix``) —
    the string surface ``serve_bench --router`` and the frontend expose."""
    if policy == "rr":
        return RoundRobinRouter()
    if policy == "least":
        return LeastLoadedRouter()
    if policy == "prefix":
        return PrefixAffinityRouter(replica_ids, buckets=buckets, **kwargs)
    raise ValueError(
        f"unknown router policy {policy!r} (want rr | least | prefix)"
    )
