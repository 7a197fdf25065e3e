"""LRU prefix cache: skip recomputing shared prompt prefixes entirely.

Production prompt streams are heavily prefix-shared — system prompts,
few-shot headers, templated instructions — and a continuous-batching
engine re-prefills those identical tokens for every request.  Cached K/V
is a pure function of (token ids, positions, params), including the int8
path's per-(position, kv-head) quantization, so a prefix computed once
can be COPIED into a fresh slot (:meth:`CachePool.copy_prefix`) with
bit-identical results; only the prompt remainder runs the model.

Keys are BUCKET-ALIGNED token prefixes (the engine's prefill buckets), so
lookups are O(#buckets) exact-match probes instead of a longest-common-
prefix search: for a prompt of length L the engine probes the largest
bucket B <= L-1 downward and takes the first hit.  (L-1, not L: a full-
prompt hit would leave no remainder token, and the FIRST sampled token
needs the last real token's hidden state — cached K/V alone cannot
produce logits.)

Entries are whole pool rows (seq_len-long K/V per layer) — real HBM — so
the cache is small and LRU-evicted; ``max_entries`` bounds it.  Hit/miss/
eviction counters feed :class:`~tpu_parallel_torch.serving.metrics.ServingMetrics`.

Under the BLOCK-PAGED pool the store is a different economy: entries hold
refcounted physical block-id tuples instead of copied rows (a hit is a
table pointer write + refcount bump — O(1), zero K/V copies), and the
``on_evict`` callback lets the engine return an evicted entry's block
references to the :class:`~tpu_parallel_torch.serving.cache_pool.BlockAllocator`.
The LRU/lookup machinery is identical either way — the cache never
inspects its values.

This is the ALIGNED-LRU tier-0 cache.  The paged path can swap it for
the token-level radix hierarchy
(:class:`~tpu_parallel_torch.serving.kv_hierarchy.RadixPrefixCache` —
block-granular matching, frequency-aware eviction, host-RAM offload
tier) via ``ServingEngine(kv_radix_cache=True)``; both expose the same
lookup/store/evict/counter surface to the engine and metrics.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional, Sequence, Tuple


class PrefixCache:
    """Exact-match LRU over bucket-aligned token prefixes.

    Keys are token-id tuples (dict hashing gives the "hash-keyed" lookup
    with zero collision risk); values are ``(row_tree, length)`` where
    ``row_tree`` is a batch-1 cache row whose first ``length`` positions
    hold the prefix (the engine trims validity at copy time, so rows are
    stored as extracted — no rewrite on the store path).
    """

    def __init__(self, max_entries: int = 8, on_evict=None):
        if max_entries < 1:
            raise ValueError(f"max_entries={max_entries} < 1")
        self.max_entries = max_entries
        self._entries: "OrderedDict[Tuple[int, ...], tuple]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        # called with each LRU-evicted (row_tree, length) entry — the
        # paged pool's refcount-release hook (None = entries just drop)
        self.on_evict = on_evict

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key) -> bool:
        return tuple(key) in self._entries

    def reset_counters(self) -> None:
        """Zero the hit/miss/eviction tallies (entries stay) — benches
        call this after a warm-up phase so measured-window rates are not
        polluted by warm traffic."""
        self.hits = self.misses = self.evictions = 0

    def lookup(self, prompt: Sequence[int], buckets: Sequence[int]):
        """Longest bucket-aligned cached prefix of ``prompt`` STRICTLY
        shorter than the prompt; returns ``(row_tree, length)`` or None.
        One counted hit or miss per call (per admission, not per probe).
        """
        prompt = tuple(int(t) for t in prompt)
        for b in sorted(buckets, reverse=True):
            if b >= len(prompt):
                continue
            entry = self._entries.get(prompt[:b])
            if entry is not None:
                self._entries.move_to_end(prompt[:b])
                self.hits += 1
                return entry
        self.misses += 1
        return None

    def store(self, prompt: Sequence[int], buckets: Sequence[int],
              row_tree) -> list:
        """Store ``row_tree`` (a freshly prefilled slot row for ``prompt``)
        under EVERY bucket-aligned proper-prefix key not already cached —
        a long prompt seeds its short shared header (the system-prompt
        case) and its long few-shot prefix in one pass, all referencing
        the SAME immutable row (copy_prefix trims validity to each key's
        length at hit time, so one stored row serves every aligned
        sub-prefix).  First writer wins per key.  Returns the newly stored
        prefix lengths."""
        prompt = tuple(int(t) for t in prompt)
        stored = []
        for b in sorted(buckets, reverse=True):
            if b >= len(prompt):
                continue
            key = prompt[:b]
            if key in self._entries:
                self._entries.move_to_end(key)
                continue
            self._entries[key] = (row_tree, b)
            stored.append(b)
        self._evict_overflow()
        return stored

    def store_one(self, prefix, length: int, row_tree) -> bool:
        """Store ONE entry under the exact ``prefix`` key (first writer
        wins; a refused store returns False so the caller can release
        whatever references ``row_tree`` carries).  The paged pool's store
        path — each bucket-aligned key holds its OWN refcounted block
        tuple, so eviction accounting stays per-key."""
        key = tuple(int(t) for t in prefix)
        if key in self._entries:
            self._entries.move_to_end(key)
            return False
        self._entries[key] = (row_tree, int(length))
        self._evict_overflow()
        return True

    def values(self):
        """Snapshot of the stored entry values (``(payload, length)``
        pairs, LRU order) — the metrics mirror's entry-bytes accounting
        reads block counts off these without reaching into the dict."""
        return list(self._entries.values())

    def pop_lru(self) -> bool:
        """Evict the least-recently-used entry NOW; False when empty.
        The paged engine's block-pressure valve: stored entries hold
        refcounted blocks indefinitely, so when the admission gate cannot
        seat the queue head it trades cold cached prefixes for capacity
        instead of starving the head forever."""
        if not self._entries:
            return False
        _, entry = self._entries.popitem(last=False)
        self.evictions += 1
        if self.on_evict is not None:
            self.on_evict(entry)
        return True

    def _evict_overflow(self) -> None:
        while len(self._entries) > self.max_entries:
            self.pop_lru()
