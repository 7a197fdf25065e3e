"""Hierarchical KV memory: a radix prefix tree over the paged block pool
with a host-RAM offload tier and an export format for cross-replica
migration.  A copy of ``tpu_parallel/serving/kv_hierarchy.py`` (the policy
is plain Python) pointed at the port's
:class:`~tpu_parallel_torch.serving.cache_pool.PagedCachePool`, whose
exchange half gives host payloads in the JAX package's exported layout,
so spilled blocks, wire frames and disk blobs are the same bytes in both
packages.

The flat :class:`~tpu_parallel_torch.serving.prefix_cache.PrefixCache` shares
only BUCKET-aligned whole prefixes under plain LRU: a prompt hits iff an
exact bucket-length key was stored, a Zipf-skewed multi-tenant mix
thrashes the LRU (every cold tenant's store evicts a hot tenant's
entry), and an evicted prefix is gone — the next request recomputes it.
This module is the three-level memory hierarchy that replaces it on the
block-paged path (RadixAttention, Zheng et al./SGLang, over the
refcounted block pool of Kwon et al./vLLM — see PAPERS.md):

**Level 1 — HBM, the radix tree** (:class:`RadixPrefixCache`).  A tree
keyed on token sequences whose nodes each hold ONE refcounted physical
block: an edge is exactly ``block_tokens`` token ids, so walking the
tree IS longest-common-prefix matching at block granularity — *any*
shared prefix hits, not just bucket-aligned ones, and a hit of k blocks
is k table pointer writes through the existing
:meth:`~tpu_parallel_torch.serving.cache_pool.PagedCachePool.map_prefix` COW
machinery (partial-block tails never arise: the tree stores only FULL
blocks, so remainders always start on a block boundary and the engine's
copy-on-write reserve drops to zero).  Eviction is FREQUENCY-AWARE, not
LRU: the victim is the resident leaf minimizing ``last_use +
hit_recency_bonus * hits`` — a hot tenant's header survives a flood of
one-shot cold prompts that would have LRU-evicted it.

**Level 2 — host RAM, the offload tier.**  An evicted-but-warm node
SPILLS instead of dying: its block's K/V (payloads, positions, int8
scales) copies to host arrays via one batched gather and device-to-host
copy (:meth:`PagedCachePool.export_blocks`) and the device block frees.  A
later lookup that walks into host-resident nodes RESTORES them — fresh
blocks allocated, one host-to-device copy + scatter
(:meth:`PagedCachePool.import_stored`) — and the hit proceeds as if the
prefix had never left HBM: zero recompute, one PCIe copy.  The tier has
its own capacity (``host_capacity_blocks``), its own frequency-aware
eviction, and typed accounting (offloads / restored blocks / host
evictions / restore fallbacks when device blocks are too scarce to
restore without starving admission).

**Level 3 — the wire, cross-replica migration**
(:class:`KVPrefixExport`).  The same export format ships a relocated
request's KV blocks replica-to-replica: the JAX package's cluster
frontend captures an export before a relocation cancels the source slot,
imports it into the target engine's prefix cache, and the forced-prefix replay's admission HITS instead of
re-prefilling — bitwise-identical continuation (cached K/V is a pure
function of tokens, positions and params; the export carries
``weights_version`` so a cross-version import refuses typed rather than
silently continuing under different weights).  Autopilot scale-ups
reuse it to warm-start a newcomer's cache from the hottest prefixes of
a live donor (:meth:`RadixPrefixCache.hottest_chains`).

Tier invariant: along any root-to-node path, device-resident nodes form
a contiguous PREFIX followed by host-resident nodes — a prefix is only
usable from block 0, so eviction always takes the deepest (leaf-most)
nodes first and restore always fills from the front of a host run.

Ownership: nodes hold allocator REFERENCES, never tables — all block
mutation stays inside ``cache_pool.py`` (references flow through
``pin_blocks`` / ``free_stored`` / ``snapshot_blocks`` /
``import_stored``).  Refcount conservation —
Σ node-held refs == the tree's resident block count, audited against
the allocator by ``tests/test_kv_hierarchy.py``'s property suite — is
the hierarchy's load-bearing invariant.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from tpu_parallel_torch.serving.cache_pool import (
    KVIntegrityError,
    block_checksums,
)

# typed verdicts for an export landing in an engine
# (``ServingEngine.import_prefix``); a cluster frontend counts one
# ``cluster_kv_migrations_total{status=...}`` per attempt.  Everything
# except IMPORTED / ALREADY_CACHED is a counted fallback — the replay
# recomputes its forced prefix exactly as before this subsystem existed.
MIGRATE_IMPORTED = "imported"  # blocks landed; the replay will hit
MIGRATE_ALREADY_CACHED = "already_cached"  # target already holds it
MIGRATE_NOT_PAGED = "not_paged"  # fixed-slot target: no block pool
MIGRATE_NO_PREFIX_CACHE = "no_prefix_cache"  # target caches nothing
MIGRATE_NO_BLOCKS = "no_blocks"  # target pool too tight right now
MIGRATE_NO_KEY = "no_key"  # no bucket key fits (aligned-LRU target)
MIGRATE_INCOMPATIBLE = "incompatible"  # block size / leaf shapes differ
MIGRATE_WEIGHTS_VERSION = "weights_version"  # KV from other weights
MIGRATE_INTEGRITY = "integrity"  # payload failed its export checksum
MIGRATION_STATUSES = (
    MIGRATE_IMPORTED,
    MIGRATE_ALREADY_CACHED,
    MIGRATE_NOT_PAGED,
    MIGRATE_NO_PREFIX_CACHE,
    MIGRATE_NO_BLOCKS,
    MIGRATE_NO_KEY,
    MIGRATE_INCOMPATIBLE,
    MIGRATE_WEIGHTS_VERSION,
    MIGRATE_INTEGRITY,
)


@dataclasses.dataclass(frozen=True)
class KVPrefixExport:
    """A block-aligned KV prefix as host bytes — the exchange unit for
    both the offload tier's spill format and replica-to-replica
    migration.

    ``tokens`` is the covered token prefix (``length`` ids, a multiple
    of ``block_tokens``); ``leaves`` holds one numpy array per
    block-axis cache leaf (the :meth:`PagedCachePool.export_blocks`
    layout — flatten order, block dim at axis 0, ``length //
    block_tokens`` rows each); ``meta`` is the exporter's per-block
    shape signature and ``weights_version`` the weight set the K/V was
    computed under — importers refuse on either mismatch, because a
    shape-compatible import under different weights would CONTINUE the
    stream with silently wrong attention reads.  ``checksums`` is one
    CRC32 per block, computed over the leaves AT EXPORT (:func:`~tpu_
    parallel.serving.cache_pool.block_checksums`): a bit flipped in
    transit or at rest is a typed ``integrity`` refusal at import, not
    wrong attention for every request sharing the prefix (empty = a
    legacy export; verified when present)."""

    tokens: Tuple[int, ...]
    length: int
    block_tokens: int
    weights_version: str
    meta: tuple
    leaves: tuple
    checksums: Tuple[int, ...] = ()

    @property
    def n_blocks(self) -> int:
        return self.length // self.block_tokens

    @property
    def payload_bytes(self) -> int:
        """Raw K/V bytes this export ships on the wire (leaf payloads
        only, excluding the frame header) — what the fleet's chunk
        planner sizes segments against and the handoff byte counters
        report."""
        return sum(int(leaf.nbytes) for leaf in self.leaves)

    def verified(self) -> bool:
        """Recompute the leaf checksums against ``checksums`` — True
        when absent (legacy export) or matching."""
        if not self.checksums:
            return True
        return (
            block_checksums(list(self.leaves), self.n_blocks)
            == tuple(self.checksums)
        )


class _Node:
    """One radix-tree node == one KV block.  ``run`` is the
    ``block_tokens``-id edge from ``parent``; at most one of ``block``
    (device-resident, holds one allocator reference) or ``host``
    (offloaded leaf arrays, the export layout at k=1, with
    ``host_crc`` recorded at spill time and verified before any
    restore) is set.  ``disk`` is a blob id in the SSD tier's store —
    INCLUSIVE with the other two: a node promoted back up keeps its
    disk copy, so re-spilling it later is free and the persisted
    manifest keeps covering the chain across a restart."""

    __slots__ = (
        "run", "parent", "children", "block", "host", "host_crc",
        "disk", "hits", "last_use", "born",
    )

    def __init__(self, run, parent, born: int):
        self.run = run
        self.parent = parent
        self.children: Dict[tuple, "_Node"] = {}
        self.block: Optional[int] = None
        self.host: Optional[list] = None
        self.host_crc: Optional[int] = None
        self.disk: Optional[int] = None
        self.hits = 0
        self.last_use = born
        self.born = born


class RadixPrefixCache:
    """Token-level radix prefix index over a
    :class:`~tpu_parallel_torch.serving.cache_pool.PagedCachePool`, with an
    optional host-RAM offload tier (see the module docstring).

    Drop-in for the engine's :class:`PrefixCache` surface on the paged
    path: ``lookup`` returns ``(block_ids, matched_length)`` (lengths
    are block multiples — the ``buckets`` argument is accepted and
    ignored), ``pop_lru`` is the admission gate's block-pressure valve
    (it spills-or-drops one resident node), and ``hits`` / ``misses`` /
    ``evictions`` feed the same metrics mirror.  ``max_device_blocks``
    bounds HBM blocks the tree holds references to;
    ``host_capacity_blocks`` bounds the warm tier (0 disables it —
    evictions then drop outright, the radix-only configuration).
    """

    def __init__(
        self,
        pool,
        max_device_blocks: int,
        host_capacity_blocks: int = 0,
        hit_recency_bonus: int = 8,
        breaker_failures: int = 4,
        breaker_probe_ops: int = 64,
        disk_store=None,
        weights_version: str = "initial",
    ):
        if max_device_blocks < 1:
            raise ValueError(
                f"max_device_blocks={max_device_blocks} < 1"
            )
        if host_capacity_blocks < 0:
            raise ValueError(
                f"host_capacity_blocks={host_capacity_blocks} < 0"
            )
        if breaker_failures < 1:
            raise ValueError(f"breaker_failures={breaker_failures} < 1")
        if breaker_probe_ops < 1:
            raise ValueError(f"breaker_probe_ops={breaker_probe_ops} < 1")
        self.pool = pool
        self.block_tokens = int(pool.block_tokens)
        self.max_device_blocks = int(max_device_blocks)
        self.host_capacity = int(host_capacity_blocks)
        # each hit is worth this many lookup/insert ops of recency in the
        # eviction score — the "frequency-aware" dial (0 = pure recency)
        self.hit_recency_bonus = int(hit_recency_bonus)
        # host-tier circuit breaker: this many CONSECUTIVE restore
        # failures (no blocks, or checksum-failed bytes) take the
        # offload tier DOWN — no spills, no restores, device-only
        # serving continues bitwise via recompute.  After
        # ``breaker_probe_ops`` further cache ops the next host hit is
        # a half-open PROBE: success closes the breaker, failure
        # re-arms the timer.
        self.breaker_failures = int(breaker_failures)
        self.breaker_probe_ops = int(breaker_probe_ops)
        self._consec_restore_failures = 0
        self._tier_down_since: Optional[int] = None  # _seq at trip
        self._seq = 0  # monotone op counter: the deterministic recency axis
        self._root = _Node(None, None, 0)
        self.device_blocks = 0  # resident nodes == device refs held
        self.host_blocks_in_use = 0
        # lookup-level tallies (PrefixCache-compatible: one hit or miss
        # per lookup call) + the hierarchy's own typed accounting
        self.hits = 0
        self.misses = 0
        self.evictions = 0  # device refs dropped (spill or outright)
        self.offloads = 0  # device -> host spills
        self.restored_blocks = 0  # host -> device restores (blocks)
        self.host_evictions = 0  # host copies dropped for good
        self.restore_failures = 0  # host hit unrestorable (no blocks)
        self.integrity_failures = 0  # checksum-failed host bytes dropped
        self.breaker_trips = 0  # times the host tier went down
        # -- SSD tier (optional, UNDER the host tier) ----------------------
        # ``disk_store`` is a ``serving/kv_disk.KVDiskStore``: cold host
        # evictions spill their payload there (prefix-closed, so every
        # disk chain restores from block 0 after a restart), lookups
        # hydrate disk runs back through host to device, and a second
        # breaker — same K-consecutive-failures / half-open shape as the
        # host tier's — takes a sick disk out of the path entirely.
        self.disk = disk_store
        self.weights_version = str(weights_version)
        self._consec_disk_failures = 0
        self._disk_down_since: Optional[int] = None  # _seq at trip
        self.disk_spills = 0  # blobs written (host -> disk)
        self.disk_restores = 0  # blocks hydrated (disk -> host)
        self.disk_restore_failures = 0  # typed hydrate refusals
        self.disk_evictions = 0  # blobs dropped (capacity or subtree)
        self.disk_breaker_trips = 0
        # typed failure tally, keyed on kv_disk.DISK_REASONS — the
        # vocabulary tests pin and the bench's rot leg audits
        self.disk_failure_reasons: Dict[str, int] = {}
        # restart seeding: manifest chains folded back into the tree
        self.disk_seeded_blocks = 0
        self.disk_seeded_chains = 0
        self.disk_orphans_dropped = 0
        if self.disk is not None:
            self._seed_from_disk()

    # -- PrefixCache-compatible surface ------------------------------------

    def __len__(self) -> int:
        """Device-resident entries (one per block) — the entry-count
        gauge's value."""
        return self.device_blocks

    def reset_counters(self) -> None:
        """Zero the tallies (tree contents stay) — the bench's
        measure-after-warmup reset, same contract as PrefixCache."""
        self.hits = self.misses = self.evictions = 0
        self.offloads = self.restored_blocks = 0
        self.host_evictions = self.restore_failures = 0
        self.integrity_failures = self.breaker_trips = 0
        self.disk_spills = self.disk_restores = 0
        self.disk_restore_failures = self.disk_evictions = 0
        self.disk_breaker_trips = 0
        self.disk_failure_reasons = {}

    # -- host-tier breaker -------------------------------------------------

    @property
    def host_tier_up(self) -> bool:
        return self._tier_down_since is None

    @property
    def breaker_state(self) -> int:
        """0 = closed (tier serving), 1 = open (tier down), 2 =
        half-open (down, but the next host hit probes) — the
        ``serving_kv_host_breaker_state`` gauge's encoding."""
        if self._tier_down_since is None:
            return 0
        if self._seq - self._tier_down_since >= self.breaker_probe_ops:
            return 2
        return 1

    def _restore_failed(self) -> None:
        """One restore failure: counted, and past ``breaker_failures``
        consecutive ones the host tier goes DOWN (a probe failure while
        down re-arms the half-open timer)."""
        self.restore_failures += 1
        self._consec_restore_failures += 1
        if self._tier_down_since is not None:
            self._tier_down_since = self._seq  # failed probe: re-arm
        elif self._consec_restore_failures >= self.breaker_failures:
            self._tier_down_since = self._seq
            self.breaker_trips += 1

    def _restore_succeeded(self) -> None:
        self._consec_restore_failures = 0
        self._tier_down_since = None  # a successful probe closes it

    # -- disk-tier breaker (mirror of the host tier's) ---------------------

    @property
    def disk_tier_up(self) -> bool:
        return self._disk_down_since is None

    @property
    def disk_breaker_state(self) -> int:
        """0 = closed, 1 = open (disk out of the path — RAM+device
        serving continues bitwise), 2 = half-open (the next disk
        operation is a probe) — ``serving_kv_disk_breaker_state``."""
        if self.disk is None or self._disk_down_since is None:
            return 0
        if self._seq - self._disk_down_since >= self.breaker_probe_ops:
            return 2
        return 1

    def _disk_failed(self, reason: str) -> None:
        """One typed disk failure (spill or hydrate): tallied by
        reason, and past ``breaker_failures`` consecutive ones the SSD
        tier goes down; a failed half-open probe re-arms the window."""
        self.disk_failure_reasons[reason] = (
            self.disk_failure_reasons.get(reason, 0) + 1
        )
        self._consec_disk_failures += 1
        if self._disk_down_since is not None:
            self._disk_down_since = self._seq  # failed probe: re-arm
        elif self._consec_disk_failures >= self.breaker_failures:
            self._disk_down_since = self._seq
            self.disk_breaker_trips += 1

    def _disk_succeeded(self) -> None:
        """A verified blob load proves the media; write success alone
        does not close the breaker (a disk that takes bytes but cannot
        give them back is still down)."""
        self._consec_disk_failures = 0
        self._disk_down_since = None

    def lookup(
        self,
        prompt: Sequence[int],
        buckets=None,
        reserve: int = 0,
    ):
        """Longest cached prefix of ``prompt`` at block granularity,
        STRICTLY shorter than the prompt (the first sampled token needs
        the last real token's hidden state).  Host-resident tail nodes
        restore to fresh device blocks first — ``reserve`` is how many
        free blocks the caller's own admissions still need, so a restore
        can never consume blocks the admission gate already promised.
        Returns ``(block_ids, length)`` or None; one counted hit or miss
        per call.  ``buckets`` is accepted for PrefixCache call-site
        compatibility and ignored (the tree needs no alignment)."""
        del buckets
        self._seq += 1
        prompt = tuple(int(t) for t in prompt)
        bt = self.block_tokens
        max_blocks = (len(prompt) - 1) // bt
        chain: List[_Node] = []
        cur = self._root
        for j in range(max_blocks):
            child = cur.children.get(prompt[j * bt : (j + 1) * bt])
            if child is None:
                break
            chain.append(child)
            cur = child
        device_n = 0
        for node in chain:
            if node.block is None:
                break
            device_n += 1
        if device_n < len(chain):
            # warm-tier hit: restore the leading host run (partial when
            # device blocks are scarce; the restored prefix still hits)
            device_n += self._restore(
                chain, chain[device_n:], reserve=reserve
            )
        if device_n == 0:
            self.misses += 1
            return None
        for node in chain[:device_n]:
            node.hits += 1
            node.last_use = self._seq
        self.hits += 1
        blocks = tuple(node.block for node in chain[:device_n])
        return blocks, device_n * bt

    def insert(self, tokens: Sequence[int], blocks) -> list:
        """Index a freshly prefilled FULL-block prefix: ``blocks`` are
        handed over with one reference each (the engine's
        ``snapshot_blocks`` bumps).  New nodes keep their block's
        reference; runs already resident return their handed-in block in
        the DUPES list for the caller to release; host-resident runs
        ADOPT the fresh device block (a free promotion — the host copy
        drops).  Capacity is enforced after the walk, never against the
        just-inserted path."""
        self._seq += 1
        tokens = tuple(int(t) for t in tokens)
        bt = self.block_tokens
        n = len(blocks)
        if len(tokens) != n * bt:
            raise ValueError(
                f"insert of {len(tokens)} tokens with {n} blocks at "
                f"{bt} tokens/block — full blocks only"
            )
        cur = self._root
        path: List[_Node] = []
        dupes: list = []
        for j in range(n):
            run = tokens[j * bt : (j + 1) * bt]
            child = cur.children.get(run)
            if child is None:
                child = _Node(run, cur, self._seq)
                cur.children[run] = child
                child.block = int(blocks[j])
                self.device_blocks += 1
            elif child.block is None:
                # host- or disk-resident: adopt the fresh device block
                # (the warm copy is now redundant; a disk copy is KEPT —
                # inclusive retention makes the next spill free and the
                # manifest keeps covering the chain across a restart)
                child.block = int(blocks[j])
                if child.host is not None:
                    child.host = None
                    child.host_crc = None
                    self.host_blocks_in_use -= 1
                self.device_blocks += 1
            else:
                dupes.append(blocks[j])
            child.last_use = self._seq
            path.append(child)
            cur = child
        self._enforce_device(protect=frozenset(id(p) for p in path))
        return dupes

    def covers(self, tokens: Sequence[int], length: int) -> bool:
        """True when the first ``length`` tokens (a block multiple) are
        already DEVICE-resident — the store path's dedup probe."""
        tokens = tuple(int(t) for t in tokens)
        bt = self.block_tokens
        cur = self._root
        for j in range(length // bt):
            cur = cur.children.get(tokens[j * bt : (j + 1) * bt])
            if cur is None or cur.block is None:
                return False
        return True

    def pop_lru(self) -> bool:
        """Evict ONE device-resident node (lowest frequency+recency
        score, deepest-first by construction) — the admission gate's
        block-pressure valve.  Spills to the host tier when it has room;
        True when a device reference was actually dropped."""
        return self._evict_one(protect=frozenset())

    def clear(self) -> None:
        """Drop every chain on every tier (device blocks back to the pool,
        host copies and disk blobs discarded): cached K/V is a function of
        the weights, so a weight rebind leaves nothing to hit."""
        for node in list(self._walk()):
            if node.block is not None:
                self.pool.free_stored((node.block,))
                node.block = None
                self.device_blocks -= 1
                self.evictions += 1
        for child in list(self._root.children.values()):
            self._drop_subtree(child)

    # -- stats -------------------------------------------------------------

    @property
    def device_bytes(self) -> int:
        return self.device_blocks * self.pool.bytes_per_block

    @property
    def host_bytes(self) -> int:
        return self.host_blocks_in_use * self.pool.bytes_per_block

    @property
    def disk_blocks_in_use(self) -> int:
        return 0 if self.disk is None else self.disk.blocks_in_use

    @property
    def disk_bytes(self) -> int:
        return 0 if self.disk is None else self.disk.payload_bytes

    def hottest_chains(self, max_blocks: int):
        """Up to ``max_blocks`` blocks of root-to-leaf device chains,
        hottest leaf first — the autopilot scale-up's warm-start
        shopping list (the donor exports each chain and the newcomer
        imports it)."""
        leaves = [
            n
            for n in self._walk()
            if n.block is not None
            and not any(
                c.block is not None for c in n.children.values()
            )
        ]
        leaves.sort(key=self._score, reverse=True)
        out, seen = [], set()
        for leaf in leaves:
            chain: List[_Node] = []
            cur = leaf
            while cur.run is not None:
                chain.append(cur)
                cur = cur.parent
            chain.reverse()
            # chains must stay contiguous from the root to be importable,
            # so sibling chains repeat shared ancestors — the budget
            # counts DISTINCT blocks, not chain lengths, or shared
            # prefixes would eat it twice
            fresh = [n.block for n in chain if n.block not in seen]
            if len(seen) + len(fresh) > max_blocks:
                continue
            seen.update(fresh)
            out.append(
                (
                    tuple(t for node in chain for t in node.run),
                    tuple(node.block for node in chain),
                )
            )
            if len(seen) >= max_blocks:
                break
        return out

    # -- internals ---------------------------------------------------------

    def _walk(self):
        stack = [self._root]
        while stack:
            node = stack.pop()
            if node.run is not None:
                yield node
            stack.extend(node.children.values())

    def _score(self, node: _Node):
        """Eviction score (higher = hotter): recency in op-sequence
        units plus a per-hit bonus; ``born`` breaks ties
        deterministically."""
        return (
            node.last_use + self.hit_recency_bonus * node.hits,
            node.born,
        )

    def _restore(self, chain, host_nodes, reserve: int = 0) -> int:
        """Restore the leading run of ``host_nodes`` to fresh device
        blocks: checksum-verify each node's spilled bytes, then one
        batched upload + scatter through the pool.  Restores only what
        fits beyond ``reserve`` and the slots' entitlements — a partial
        restore still extends the hit; a zero restore counts one typed
        fallback.  A checksum-failed node is an ``integrity`` refusal:
        its (unreachable-without-it) subtree drops and the lookup falls
        back to the recompute path — corrupted bytes NEVER reach the
        device.  While the breaker has the tier down, restores refuse
        outright until the half-open window opens, and then admit one
        probe.  Returns restored block count."""
        state = self.breaker_state
        if state == 1:
            return 0  # tier down, probe window not open: recompute
        if state == 2:
            host_nodes = host_nodes[:1]  # half-open: ONE probe block
        # the tail may continue past the host run into DISK-resident
        # nodes: hydrate the leading disk run into transient host
        # payloads first (disk -> host; the import below finishes the
        # promotion to device).  Typed hydrate refusals drop the
        # refused subtree — the verified leading run still restores.
        host_nodes, hydrated = self._hydrate_disk_run(host_nodes)
        if not host_nodes:
            # all-disk tail behind an open disk breaker (or a refused
            # first blob): not a host-tier failure — RAM+device serving
            # continues on whatever device prefix the caller matched
            return 0
        try:
            # verify the leading run BEFORE touching the pool: truncate
            # at the first checksum-failed node (everything below it is
            # unreachable without it anyway)
            verified = []
            corrupt = None
            for node in host_nodes:
                if node.host_crc is not None and (
                    block_checksums(node.host, 1)[0] != node.host_crc
                ):
                    corrupt = node
                    break
                verified.append(node)
            if corrupt is not None:
                self.integrity_failures += 1
                self._drop_subtree(corrupt)
                if not verified:
                    self._restore_failed()
                    return 0
            avail = self.pool.blocks_available() - int(reserve)
            k = min(len(verified), max(0, avail))
            if k == 0:
                self._restore_failed()
                return 0
            take = verified[:k]
            rows = [
                np.concatenate([n.host[i] for n in take], axis=0)
                for i in range(len(take[0].host))
            ]
            try:
                blocks = self.pool.import_stored(
                    rows, k,
                    checksums=[
                        n.host_crc for n in take
                    ] if all(
                        n.host_crc is not None for n in take
                    ) else None,
                )
            except KVIntegrityError:
                # belt and braces: the pool's own verify disagreed
                # (bytes rotted between our check and the upload
                # staging).  The whole run drops — take[0]'s subtree
                # contains the rest.
                self.integrity_failures += 1
                self._drop_subtree(take[0])
                self._restore_failed()
                return 0
            if blocks is None:
                self._restore_failed()
                return 0
            for node, blk in zip(take, blocks):
                node.block = int(blk)
                node.host = None
                node.host_crc = None
                self.host_blocks_in_use -= 1
                self.device_blocks += 1
                node.last_use = self._seq
            self.restored_blocks += k
            self._restore_succeeded()
            # restoring may overshoot the device budget: evict cold
            # nodes, never the chain the caller is about to map
            self._enforce_device(
                protect=frozenset(id(n) for n in chain)
            )
            return k
        finally:
            # hydration is TRANSIENT: a hydrated node the import did
            # not reach sheds its host payload again (the disk copy
            # stays — nothing is lost) so a failed restore cannot
            # overflow the host tier's capacity accounting
            for node in hydrated:
                if node.host is not None and node.block is None:
                    node.host = None
                    node.host_crc = None
                    self.host_blocks_in_use -= 1

    def _hydrate_disk_run(self, nodes):
        """Load the leading disk run of ``nodes`` into host payloads.

        Returns ``(usable_run, hydrated)``: the leading nodes that now
        hold host payloads, and the subset hydrated HERE (whose
        payloads are transient until the device import lands).  Every
        refusal is typed into ``disk_failure_reasons`` and drops the
        refused node's subtree — corrupted or unreadable blobs never
        serve, the chain above them still does.  Breaker discipline
        mirrors the host tier: open = no disk reads, half-open =
        exactly one probe blob (a verified load closes the breaker)."""
        run: List[_Node] = []
        hydrated: List[_Node] = []
        probe_spent = False
        for node in nodes:
            if node.host is not None:
                run.append(node)
                continue
            if node.disk is None or self.disk is None:
                break
            state = self.disk_breaker_state
            if state == 1 or (state == 2 and probe_spent):
                break
            probe_spent = True
            from tpu_parallel_torch.serving.kv_disk import (
                DISK_WEIGHTS,
                KVDiskError,
            )

            try:
                export = self.disk.load(node.disk)
            except KVDiskError as err:
                self.disk_restore_failures += 1
                self._disk_failed(err.reason)
                self._drop_subtree(node)
                break
            if export.weights_version != self.weights_version:
                # stale weight set: a typed refusal, not media sickness
                # — no breaker feed
                self.disk_restore_failures += 1
                self.disk_failure_reasons[DISK_WEIGHTS] = (
                    self.disk_failure_reasons.get(DISK_WEIGHTS, 0) + 1
                )
                self._drop_subtree(node)
                break
            self._disk_succeeded()
            node.host = list(export.leaves)
            node.host_crc = int(export.checksums[0])
            self.host_blocks_in_use += 1
            self.disk_restores += 1
            hydrated.append(node)
            run.append(node)
        return run, hydrated

    def _enforce_device(self, protect=frozenset()) -> None:
        while self.device_blocks > self.max_device_blocks:
            if not self._evict_one(protect=protect):
                break  # only protected nodes remain: transient overshoot

    def _evict_one(self, protect) -> bool:
        """Drop one device reference: the coldest node with no
        device-resident child (deepest-first keeps the contiguous-prefix
        invariant).  Spills to the host tier when it has room — making
        room by dropping a strictly colder host entry first — else the
        node (and its unreachable host descendants) drop for good."""
        cands = [
            n
            for n in self._walk()
            if n.block is not None
            and id(n) not in protect
            and not any(
                c.block is not None for c in n.children.values()
            )
        ]
        if not cands:
            return False
        victim = min(cands, key=self._score)
        # only evicted-but-WARM blocks spill: a node nothing ever hit
        # (the typical case — a prompt's one-off suffix blocks) drops
        # outright, so the host tier holds reusable prefixes instead of
        # churning PCIe copies on bytes no lookup will ever want back.
        # An OPEN breaker stops spills too — a tier that cannot restore
        # is pure PCIe waste; the HALF-OPEN state re-admits them so the
        # tier can repopulate and the next lookup's probe can prove it
        # (corrupted host copies were dropped at detection, so the tier
        # may be empty by the time the probe window opens).
        spill = (
            self.host_capacity > 0
            and victim.hits > 0
            and self.breaker_state != 1
        )
        if spill and self.host_blocks_in_use >= self.host_capacity:
            spill = self._evict_host_one(colder_than=victim)
        if spill:
            victim.host = self.pool.export_blocks([victim.block])
            # checksum at spill time: restore verifies against it, so
            # host-RAM rot is a typed refusal, never wrong attention
            victim.host_crc = block_checksums(victim.host, 1)[0]
            self.host_blocks_in_use += 1
            self.offloads += 1
        self.pool.free_stored((victim.block,))
        victim.block = None
        self.device_blocks -= 1
        self.evictions += 1
        if victim.host is None and victim.disk is None:
            self._drop_subtree(victim)
        return True

    def _evict_host_one(self, colder_than: Optional[_Node] = None) -> bool:
        """Evict the coldest leaf-most host node.  With an SSD tier
        attached and healthy its payload SPILLS DOWN (the node stays in
        the tree, disk-resident, and the persisted manifest now covers
        its chain across a restart); otherwise it drops for good.
        Refuses when the victim would be HOTTER than the node about to
        spill into the freed slot."""
        cands = [
            n
            for n in self._walk()
            if n.host is not None
            and not any(
                c.block is not None or c.host is not None
                for c in n.children.values()
            )
        ]
        if not cands:
            return False
        victim = min(cands, key=self._score)
        if colder_than is not None and (
            self._score(victim) > self._score(colder_than)
        ):
            return False
        if self._spill_to_disk(victim):
            victim.host = None
            victim.host_crc = None
            self.host_blocks_in_use -= 1
            self.host_evictions += 1
            return True
        self._drop_subtree(victim)
        return True

    def _chain_of(self, node: _Node) -> List[_Node]:
        """Root-to-``node`` path, root's child first."""
        chain: List[_Node] = []
        cur = node
        while cur.run is not None:
            chain.append(cur)
            cur = cur.parent
        chain.reverse()
        return chain

    def _spill_to_disk(self, node: _Node) -> bool:
        """Persist ``node``'s payload — and any not-yet-persisted
        ancestors, the PREFIX-CLOSURE invariant: every disk chain must
        be restorable from block 0 by a cold process that holds nothing
        but the manifest.  Ancestors already on disk are skipped
        (inclusive retention makes re-spills free).  Typed failures
        feed the disk breaker and return False — the caller then drops
        the node exactly as before this tier existed."""
        store = self.disk
        if store is None or store.wedged or self.disk_breaker_state == 1:
            return False
        chain = self._chain_of(node)
        need = [n for n in chain if n.disk is None]
        if not need:
            return True  # already persisted
        # make room with cold pure-disk leaves; never drop something
        # hotter than what is arriving
        while store.blocks_in_use + len(need) > store.capacity_blocks:
            if not self._evict_disk_one(colder_than=node):
                return False
        from tpu_parallel_torch.serving.kv_disk import KVDiskError

        tokens: List[int] = []
        for n in chain:
            tokens.extend(n.run)
            if n.disk is not None:
                continue
            if n.host is not None:
                rows = list(n.host)
                crc = n.host_crc
                if crc is None:
                    crc = block_checksums(rows, 1)[0]
            elif n.block is not None:
                rows = self.pool.export_blocks([n.block])
                crc = block_checksums(rows, 1)[0]
            else:
                return False  # payload gone: the prefix cannot close
            export = KVPrefixExport(
                tokens=tuple(n.run),
                length=self.block_tokens,
                block_tokens=self.block_tokens,
                weights_version=self.weights_version,
                meta=self.pool.export_meta,
                leaves=tuple(rows),
                checksums=(int(crc),),
            )
            try:
                n.disk = store.put(export, chain_tokens=tuple(tokens))
            except KVDiskError as err:
                self._disk_failed(err.reason)
                return False
            self.disk_spills += 1
        return True

    def _evict_disk_one(self, colder_than: Optional[_Node] = None) -> bool:
        """The SSD tier's capacity valve: drop the coldest childless
        disk-only leaf for good, falling back to shedding an INCLUSIVE
        disk copy (a childless node still resident above — losing only
        restart coverage, not serving).  Refuses rather than drop
        something hotter than ``colder_than``."""
        pure = [
            n
            for n in self._walk()
            if n.disk is not None
            and n.block is None
            and n.host is None
            and not n.children
        ]
        cands = pure or [
            n
            for n in self._walk()
            if n.disk is not None and not n.children
        ]
        if not cands:
            return False
        victim = min(cands, key=self._score)
        if colder_than is not None and (
            self._score(victim) > self._score(colder_than)
        ):
            return False
        if victim.block is None and victim.host is None:
            self._drop_subtree(victim)
        else:
            if self.disk is not None:
                self.disk.delete(victim.disk)
            victim.disk = None
            self.disk_evictions += 1
        return True

    def _drop_subtree(self, node: _Node) -> None:
        """Unlink ``node`` (and any host- or disk-resident descendants
        — they are unreachable without their prefix) from the tree;
        disk blobs are deleted so the manifest keeps mirroring the
        tree's disk-resident set."""
        stack = list(node.children.values())
        while stack:
            sub = stack.pop()
            stack.extend(sub.children.values())
            self._shed_residency(sub)
            # device descendants are impossible here: eviction is
            # deepest-first and the tier invariant keeps device nodes in
            # a contiguous prefix above any host node
            assert sub.block is None, "device node below an evicted one"
        self._shed_residency(node)
        if node.parent is not None:
            node.parent.children.pop(node.run, None)
        node.children.clear()

    def _shed_residency(self, node: _Node) -> None:
        if node.host is not None:
            node.host = None
            node.host_crc = None
            self.host_blocks_in_use -= 1
            self.host_evictions += 1
        if node.disk is not None:
            if self.disk is not None:
                self.disk.delete(node.disk)
            node.disk = None
            self.disk_evictions += 1

    def _seed_from_disk(self) -> None:
        """Cold-boot warm start: fold the persisted manifest back into
        the tree as disk-resident nodes, shortest chain first so a
        parent always folds before its children.  An entry whose prefix
        is missing (its ancestor's blob was swept, superseded, or shed)
        or whose weight set no longer matches is an ORPHAN — dropped
        typed, blob deleted.  Payloads stay on disk: the first lookup
        hydrates and CRC-verifies them, so a rotted blob is a typed
        refusal at restore time, never wrong attention now."""
        from tpu_parallel_torch.serving.kv_disk import DISK_WEIGHTS

        bt = self.block_tokens
        for entry in self.disk.entries():
            tokens = entry.tokens
            if len(tokens) == 0 or len(tokens) % bt != 0:
                self.disk.delete(entry.blob)
                self.disk_orphans_dropped += 1
                continue
            if entry.weights_version != self.weights_version:
                self.disk.delete(entry.blob)
                self.disk_orphans_dropped += 1
                self.disk_failure_reasons[DISK_WEIGHTS] = (
                    self.disk_failure_reasons.get(DISK_WEIGHTS, 0) + 1
                )
                continue
            cur = self._root
            ok = True
            n_runs = len(tokens) // bt
            for j in range(n_runs - 1):
                cur = cur.children.get(tokens[j * bt : (j + 1) * bt])
                if cur is None or cur.disk is None:
                    # a chain is only restorable from block 0 — a hole
                    # in the prefix closure orphans everything below it
                    ok = False
                    break
            if not ok:
                self.disk.delete(entry.blob)
                self.disk_orphans_dropped += 1
                continue
            run = tokens[(n_runs - 1) * bt :]
            child = cur.children.get(run)
            if child is not None:
                if child.disk is not None:
                    # duplicate chain (a crash between put and delete):
                    # first blob wins, this one is garbage
                    self.disk.delete(entry.blob)
                    self.disk_orphans_dropped += 1
                    continue
                child.disk = entry.blob
            else:
                child = _Node(run, cur, 0)
                child.disk = entry.blob
                cur.children[run] = child
            self.disk_seeded_blocks += 1
        self.disk_seeded_chains = sum(
            1 for n in self._walk()
            if n.disk is not None and not n.children
        )
