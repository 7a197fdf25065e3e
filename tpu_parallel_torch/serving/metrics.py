"""Serving observability: queue depth, TTFT, inter-token latency, slot
occupancy, throughput — backed by the shared labeled metric registry.

Three consumers: (1) live per-tick export through
:class:`~tpu_parallel_torch.utils.logging_utils.MetricLogger` (stdout +
machine-readable JSONL, process-0-only on multi-host — the same sink the
trainer uses), (2) an end-of-run :meth:`ServingMetrics.summary` dict
(the record ``scripts/serve_bench.py`` emits next to the ``DECODE_r*``
decode-bench lines), and (3) the registry itself
(:class:`~tpu_parallel_torch.obs.registry.MetricRegistry`), which any exporter
— Prometheus text, JSONL snapshot — can serialize at any moment.

Latency/depth distributions live in the registry's LOG-BUCKETED
histograms, so a long-lived engine's memory stays flat without a sample
cap, counters and means are exact over the whole lifetime, and
percentiles are exact to one bucket width (~10% relative at the default
growth).  The public attributes (``ticks``, ``finished``,
``prefix_hits``...) read through to the registry instruments.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from tpu_parallel_torch.obs.registry import MetricRegistry
from tpu_parallel_torch.utils.logging_utils import MetricLogger

# engine tick stall-cause labels (serving_tick_stall_total): why THIS
# tick produced fewer tokens than a pure decode tick would have
STALL_QUEUE_EMPTY = "queue_empty"  # nothing to decode, nothing queued
STALL_PREFILL = "prefill"  # prefill/chunk work ran before the decode
STALL_SPEC_VERIFY = "spec_verify"  # decode tick spent verifying drafts
STALL_NONE = "none"  # plain unstalled decode tick
STALL_CAUSES = (
    STALL_QUEUE_EMPTY, STALL_PREFILL, STALL_SPEC_VERIFY, STALL_NONE
)


def percentile(values: Sequence[float], p: float) -> Optional[float]:
    """Linear-interpolated percentile (``p`` clamped into [0, 100]); None
    on empty — the empty-safe wrapper every summary stat here needs (a run
    with ZERO finished requests must still produce a serializable summary,
    not an IndexError/NaN in the JSONL sink)."""
    vals = [v for v in values if v is not None]
    if not vals:
        return None
    return float(np.percentile(vals, min(max(p, 0.0), 100.0)))


class ServingMetrics:
    """Accumulates per-tick and per-request serving statistics in a
    :class:`MetricRegistry`.

    The engine calls :meth:`record_tick` once per ``step()`` and
    :meth:`record_finished` as requests retire; everything else derives.
    ``logger``/``log_every`` stream tick metrics through the shared
    :class:`MetricLogger` (queue depth, occupancy, cumulative tokens/sec).

    Pass ``registry`` to share one store across subsystems (engine +
    trainer + exporters); by default each instance owns a fresh one.
    ``max_samples`` is kept for call-site compatibility but unused — the
    log-bucketed histograms are bounded by construction, not by a window.
    """

    def __init__(
        self,
        logger: Optional[MetricLogger] = None,
        log_every: int = 0,
        max_samples: int = 100_000,
        registry: Optional[MetricRegistry] = None,
    ):
        del max_samples  # windowing replaced by bounded log-bucketing
        self.logger = logger
        self.log_every = log_every
        self.registry = registry if registry is not None else MetricRegistry()
        r = self.registry
        self._ticks = r.counter("serving_ticks_total")
        self._decode_ticks = r.counter("serving_decode_ticks_total")
        self._tokens_out = r.counter("serving_tokens_out_total")
        self._prefills = r.counter("serving_prefills_total")
        self._finished = r.counter("serving_finished_total")
        self._rejected = r.counter("serving_rejected_total")
        self._expired = r.counter("serving_expired_total")
        self._cancelled = r.counter("serving_cancelled_total")
        # prefill fast path: batched prefill device calls (vs. `prefills`,
        # which counts admitted REQUESTS), chunk continuations, and the
        # prefix cache's hit/miss/eviction tallies (mirrored gauges — the
        # cache owns the counts, metrics snapshots them)
        self._prefill_calls = r.counter("serving_prefill_calls_total")
        self._prefill_chunks = r.counter("serving_prefill_chunks_total")
        self._prefix_hits = r.gauge("serving_prefix_hits")
        self._prefix_misses = r.gauge("serving_prefix_misses")
        self._prefix_evictions = r.gauge("serving_prefix_evictions")
        # the hit/miss tallies AS A RATE plus the cache's live footprint
        # (entry count + device bytes) — the radix-vs-LRU comparison is
        # scrapeable, not just bench-post-processed
        self._prefix_hit_rate = r.gauge("serving_prefix_hit_rate")
        self._prefix_entries = r.gauge("serving_prefix_entries")
        self._prefix_entry_bytes = r.gauge("serving_prefix_entry_bytes")
        # a legitimately-empty cache sets the bytes gauge to 0, which is
        # NOT the same summary() answer as "this layout cannot compute
        # entry bytes" (fixed-slot rows) — track set-ness explicitly
        self._prefix_bytes_known = False
        # host-RAM KV offload tier (kv_hierarchy.RadixPrefixCache):
        # occupancy gauges + mirrored cumulative tallies (the cache owns
        # the counts, exactly like the prefix hit/miss mirror above)
        self._kv_host_blocks = r.gauge("serving_kv_host_blocks_in_use")
        self._kv_host_bytes = r.gauge("serving_kv_host_bytes")
        self._kv_host_offloads = r.gauge("serving_kv_host_offloads")
        self._kv_host_restored = r.gauge(
            "serving_kv_host_restored_blocks"
        )
        self._kv_host_evictions = r.gauge("serving_kv_host_evictions")
        self._kv_restore_failures = r.gauge(
            "serving_kv_host_restore_failures"
        )
        # transfer-integrity accounting: checksum-failed
        # spill/restore/import payloads (each one a typed refusal that
        # fell back to recompute — NEVER served), plus the host-tier
        # circuit breaker (K consecutive restore failures take the
        # offload tier down; half-open re-probe restores it)
        self._kv_integrity_failures = r.gauge(
            "serving_kv_integrity_failures"
        )
        self._kv_breaker_state = r.gauge(
            "serving_kv_host_breaker_state"
        )
        self._kv_breaker_trips = r.gauge(
            "serving_kv_host_breaker_trips"
        )
        # SSD KV tier (kv_disk.KVDiskStore under the radix hierarchy):
        # occupancy + spill/restore tallies, the disk breaker mirror,
        # and the persisted manifest's record/compaction counts —
        # the restart-warm-start story's observability surface
        self._kv_disk_blocks = r.gauge("serving_kv_disk_blocks")
        self._kv_disk_bytes = r.gauge("serving_kv_disk_bytes")
        self._kv_disk_spills = r.gauge("serving_kv_disk_spills")
        self._kv_disk_restores = r.gauge("serving_kv_disk_restores")
        self._kv_disk_restore_failures = r.gauge(
            "serving_kv_disk_restore_failures"
        )
        self._kv_disk_breaker_state = r.gauge(
            "serving_kv_disk_breaker_state"
        )
        self._kv_disk_breaker_trips = r.gauge(
            "serving_kv_disk_breaker_trips"
        )
        self._kv_disk_manifest_records = r.gauge(
            "serving_kv_disk_manifest_records"
        )
        self._kv_disk_manifest_compactions = r.gauge(
            "serving_kv_disk_manifest_compactions"
        )
        self._kv_disk_seeded_blocks = r.gauge(
            "serving_kv_disk_seeded_blocks"
        )
        self._disk_tier_seen = False
        # device-side NaN/Inf sentinel trips: per-request typed
        # integrity failures instead of streamed garbage
        self._integrity_trips = r.counter(
            "serving_integrity_trips_total"
        )
        # speculative decode: drafted vs accepted tokens (acceptance rate
        # = the drafter's hit quality), and verify positions computed but
        # not delivered (pads + rejected drafts + post-finish surplus —
        # the FLOP overhead speculative decode pays for its win)
        self._spec_slot_ticks = r.counter("serving_spec_slot_ticks_total")
        self._tokens_drafted = r.counter("serving_tokens_drafted_total")
        self._tokens_accepted = r.counter("serving_tokens_accepted_total")
        self._spec_wasted = r.counter("serving_spec_wasted_positions_total")
        self._spec_acceptance = r.histogram("serving_spec_acceptance_ratio")
        # block-paged KV pool (kv_block_tokens > 0): live block occupancy
        # gauges, copy-on-write and prefix-share tallies (delta-synced
        # from the pool's cumulative counters so reset_metrics starts a
        # fresh record at zero), and bytes of allocated KV per active
        # token — the capacity win the paged layout exists for (a fixed
        # pool pins this at seq_len's worth regardless of request length)
        self._kv_blocks_in_use = r.gauge("serving_kv_blocks_in_use")
        self._kv_blocks_free = r.gauge("serving_kv_blocks_free")
        self._kv_cow_copies = r.counter(
            "serving_kv_block_cow_copies_total"
        )
        self._prefix_shared_blocks = r.counter(
            "serving_prefix_shared_blocks_total"
        )
        self._kv_bytes_per_token = r.gauge(
            "serving_kv_bytes_per_active_token"
        )
        self._cow_seen = 0
        self._shared_seen = 0
        # dispatch amortization: every jitted model-forward the engine
        # issues (prefill/extend/chunk/decode/verify/fused) counts one
        # host dispatch; decode-family dispatches additionally observe
        # how many generated tokens they delivered — the fused tick's
        # whole win is this histogram's mean moving from ~batch to
        # ~batch * decode_steps_per_tick.  host_ms_per_tick is the
        # engine-clock wall time of each step() (host bookkeeping +
        # device wait), the per-tick cost the amortization divides.
        self._host_dispatches = r.counter("serving_host_dispatches_total")
        self._tokens_per_dispatch = r.histogram(
            "serving_tokens_per_dispatch"
        )
        self._host_ms_per_tick = r.histogram("serving_host_ms_per_tick")
        # the unified ragged tick + double-buffered launch/collect
        # pipeline: tokens (prompt chunk tokens consumed + tokens
        # generated) each unified dispatch advanced, and how many
        # decode-family dispatches were launched while the previous
        # tick's results were still uncollected — host bookkeeping for
        # tick N overlapping device compute for tick N+1.  The ratio
        # gauge is overlapped / decode dispatches (0 without the
        # pipeline; > 0 is the acceptance gate for measured overlap).
        self._unified_tick_tokens = r.histogram(
            "serving_unified_tick_tokens"
        )
        self._overlapped = r.counter("serving_overlapped_dispatches_total")
        self._overlap_ratio = r.gauge("serving_host_overlap_ratio")
        # per-tick stall attribution, pre-registered so every cause shows
        # a (possibly zero) series in exports
        self._stall = {
            cause: r.counter("serving_tick_stall_total", cause=cause)
            for cause in STALL_CAUSES
        }
        # distributions: log-bucketed histograms (exact count/sum/max,
        # percentile within one bucket width) + last-value gauges for
        # scrape-style consumers
        self._ttft = r.histogram("serving_ttft_seconds")
        self._itl = r.histogram("serving_itl_seconds")
        self._queue_depth = r.histogram("serving_queue_depth")
        self._occupancy = r.histogram("serving_slot_occupancy")
        self._queue_depth_last = r.gauge("serving_queue_depth_last")
        self._occupancy_last = r.gauge("serving_slot_occupancy_last")
        self._t_start: Optional[float] = None
        self._t_last: Optional[float] = None

    # -- counter attribute surface (unchanged names, registry-backed) ------

    @property
    def ticks(self) -> int:
        return int(self._ticks.value)

    @property
    def decode_ticks(self) -> int:
        return int(self._decode_ticks.value)

    @property
    def tokens_out(self) -> int:
        return int(self._tokens_out.value)

    @property
    def prefills(self) -> int:
        return int(self._prefills.value)

    @property
    def finished(self) -> int:
        return int(self._finished.value)

    @property
    def rejected(self) -> int:
        return int(self._rejected.value)

    @property
    def expired(self) -> int:
        return int(self._expired.value)

    @property
    def cancelled(self) -> int:
        return int(self._cancelled.value)

    @property
    def prefill_calls(self) -> int:
        return int(self._prefill_calls.value)

    @property
    def prefill_chunks(self) -> int:
        return int(self._prefill_chunks.value)

    @property
    def prefix_hits(self) -> int:
        return int(self._prefix_hits.value)

    @property
    def prefix_misses(self) -> int:
        return int(self._prefix_misses.value)

    @property
    def prefix_evictions(self) -> int:
        return int(self._prefix_evictions.value)

    @property
    def spec_slot_ticks(self) -> int:
        return int(self._spec_slot_ticks.value)

    @property
    def tokens_drafted(self) -> int:
        return int(self._tokens_drafted.value)

    @property
    def tokens_accepted(self) -> int:
        return int(self._tokens_accepted.value)

    @property
    def spec_wasted_positions(self) -> int:
        return int(self._spec_wasted.value)

    @property
    def host_dispatches(self) -> int:
        return int(self._host_dispatches.value)

    @property
    def kv_blocks_in_use(self) -> int:
        return int(self._kv_blocks_in_use.value)

    @property
    def kv_blocks_free(self) -> int:
        return int(self._kv_blocks_free.value)

    @property
    def kv_block_cow_copies(self) -> int:
        return int(self._kv_cow_copies.value)

    @property
    def prefix_shared_blocks(self) -> int:
        return int(self._prefix_shared_blocks.value)

    # -- recording ---------------------------------------------------------

    def record_tick(
        self,
        now: float,
        queue_depth: int,
        occupancy: float,
        new_tokens: int,
        prefills: int,
        decoded: bool,
        stall: Optional[str] = None,
        host_ms: Optional[float] = None,
    ) -> None:
        if self._t_start is None:
            self._t_start = now
        self._t_last = now
        self._ticks.inc()
        if host_ms is not None:
            self._host_ms_per_tick.observe(host_ms)
        if decoded:
            self._decode_ticks.inc()
            if int(self._overlapped.value):
                self._refresh_overlap_ratio()
        self._tokens_out.inc(new_tokens)
        self._prefills.inc(prefills)
        self._queue_depth.observe(queue_depth)
        self._occupancy.observe(occupancy)
        self._queue_depth_last.set(queue_depth)
        self._occupancy_last.set(occupancy)
        if stall is not None:
            self._stall.get(stall, self._stall[STALL_NONE]).inc()
        if (
            self.logger is not None
            and self.log_every > 0
            and self.ticks % self.log_every == 0
        ):
            self.logger.log(
                self.ticks,
                {
                    "queue_depth": float(queue_depth),
                    "slot_occupancy": float(occupancy),
                    "tokens_out": float(self.tokens_out),
                    "tokens_per_sec": float(self.throughput() or 0.0),
                },
            )

    def record_finished(self, out) -> None:
        """Fold one retired RequestOutput's latencies in."""
        self._finished.inc()
        if out.ttft is not None:
            self._ttft.observe(out.ttft)
        for gap in out.inter_token_latencies():
            self._itl.observe(gap)

    def record_rejected(self) -> None:
        self._rejected.inc()

    def record_expired(self) -> None:
        self._expired.inc()

    def record_cancelled(self) -> None:
        self._cancelled.inc()

    def record_integrity_trip(self) -> None:
        """One device-side NaN/Inf sentinel trip: a request FAILED
        typed ``integrity`` instead of streaming garbage tokens."""
        self._integrity_trips.inc()

    def record_prefill_call(self, chunks: int = 0) -> None:
        """One batched prefill device call (``chunks`` counts any chunk
        continuations it was split into).  Every prefill call is also a
        host dispatch."""
        self._prefill_calls.inc()
        self._prefill_chunks.inc(chunks)
        self._host_dispatches.inc()

    def record_dispatch(self, tokens: Optional[int] = None) -> None:
        """One decode-family host->device dispatch (per-step decode,
        speculative verify, or fused/unified tick); ``tokens`` is how
        many generated tokens it delivered — the amortization
        numerator."""
        self._host_dispatches.inc()
        if tokens is not None:
            self._tokens_per_dispatch.observe(tokens)

    def record_chunks(self, chunks: int) -> None:
        """Chunk continuations folded into a UNIFIED tick's single
        dispatch — counted like the per-phase engine's per-slot chunk
        extends (``prefill_chunks``) but WITHOUT a prefill call or a
        dispatch of their own: the whole point of the unified tick is
        that the chunk phase shares the decode dispatch."""
        self._prefill_chunks.inc(chunks)

    def record_unified_tick(self, tokens: int) -> None:
        """One unified ragged tick's advancement: prompt chunk tokens
        consumed plus tokens generated by its ONE dispatch (chunk
        counting goes through :meth:`record_chunks`)."""
        self._unified_tick_tokens.observe(tokens)

    def record_overlap(self) -> None:
        """One decode-family dispatch launched while the PREVIOUS tick's
        results were still uncollected (the launch/collect pipeline's
        launch-ahead) — tick N's host sync + delivery then overlapped
        tick N+1's device compute."""
        self._overlapped.inc()
        self._refresh_overlap_ratio()

    def _refresh_overlap_ratio(self) -> None:
        """Overlapped / decode dispatches.  Recomputed on every decode
        tick AND at summary time, not only when an overlap lands — a
        long non-overlapped stretch after early launch-aheads must pull
        the ratio DOWN, or the gauge (and the bench records built on
        it) would freeze at the early high-water mark."""
        decode = max(int(self._decode_ticks.value), 1)
        self._overlap_ratio.set(
            min(int(self._overlapped.value) / decode, 1.0)
        )

    def record_spec(self, drafted: int, accepted: int, wasted: int) -> None:
        """One active slot's share of a speculative verify tick: how many
        draft tokens it proposed, how many the verify accepted, and how
        many of its compiled verify positions went undelivered."""
        self._spec_slot_ticks.inc()
        self._tokens_drafted.inc(drafted)
        self._tokens_accepted.inc(accepted)
        self._spec_wasted.inc(wasted)
        if drafted > 0:
            self._spec_acceptance.observe(accepted / drafted)

    def sync_prefix_cache(self, prefix_cache, entry_bytes=None) -> None:
        """Mirror a prefix cache's cumulative counters (the cache owns
        the tallies — :class:`~tpu_parallel_torch.serving.prefix_cache.
        PrefixCache` and :class:`~tpu_parallel_torch.serving.kv_hierarchy.
        RadixPrefixCache` expose the same surface; metrics snapshots
        them so ``summary()`` is self-contained), plus the live hit RATE
        and footprint gauges.  ``entry_bytes`` is the cache's resident
        device bytes when the engine can compute them (paged layouts;
        None leaves the gauge untouched)."""
        self._prefix_hits.set(prefix_cache.hits)
        self._prefix_misses.set(prefix_cache.misses)
        self._prefix_evictions.set(prefix_cache.evictions)
        probes = prefix_cache.hits + prefix_cache.misses
        self._prefix_hit_rate.set(
            prefix_cache.hits / probes if probes else 0.0
        )
        self._prefix_entries.set(len(prefix_cache))
        if entry_bytes is not None:
            self._prefix_entry_bytes.set(entry_bytes)
            self._prefix_bytes_known = True

    def sync_host_tier(self, radix) -> None:
        """Mirror the host-RAM offload tier's occupancy and cumulative
        tallies off a :class:`~tpu_parallel_torch.serving.kv_hierarchy.
        RadixPrefixCache` (same ownership model as the prefix mirror)."""
        self._kv_host_blocks.set(radix.host_blocks_in_use)
        self._kv_host_bytes.set(radix.host_bytes)
        self._kv_host_offloads.set(radix.offloads)
        self._kv_host_restored.set(radix.restored_blocks)
        self._kv_host_evictions.set(radix.host_evictions)
        self._kv_restore_failures.set(radix.restore_failures)
        self._kv_integrity_failures.set(radix.integrity_failures)
        self._kv_breaker_state.set(radix.breaker_state)
        self._kv_breaker_trips.set(radix.breaker_trips)

    def sync_disk_tier(self, radix) -> None:
        """Mirror the SSD tier's occupancy, spill/restore tallies, disk
        breaker and manifest accounting off a radix cache with a
        ``kv_disk.KVDiskStore`` attached."""
        self._disk_tier_seen = True
        self._kv_disk_blocks.set(radix.disk_blocks_in_use)
        self._kv_disk_bytes.set(radix.disk_bytes)
        self._kv_disk_spills.set(radix.disk_spills)
        self._kv_disk_restores.set(radix.disk_restores)
        self._kv_disk_restore_failures.set(radix.disk_restore_failures)
        self._kv_disk_breaker_state.set(radix.disk_breaker_state)
        self._kv_disk_breaker_trips.set(radix.disk_breaker_trips)
        self._kv_disk_seeded_blocks.set(radix.disk_seeded_blocks)
        store = radix.disk
        if store is not None:
            self._kv_disk_manifest_records.set(store.manifest_records)
            self._kv_disk_manifest_compactions.set(
                store.manifest_compactions
            )

    def seed_block_pool(self, pool) -> None:
        """Watermark a paged pool's CUMULATIVE COW/share tallies so this
        record's delta-synced counters start at zero (``reset_metrics``
        hands a long-lived engine a fresh record without resetting the
        pool)."""
        self._cow_seen = pool.cow_copies
        self._shared_seen = pool.shared_block_maps

    def sync_block_pool(self, pool, active_tokens: int = 0) -> None:
        """Mirror a
        :class:`~tpu_parallel_torch.serving.cache_pool.PagedCachePool`'s
        occupancy and copy tallies (the pool owns the counts; metrics
        delta-syncs the cumulative ones past the :meth:`seed_block_pool`
        watermark).  ``active_tokens`` — the in-flight requests' written
        depths — is the denominator of the capacity gauge: allocated KV
        bytes per token actually in use (fixed-slot layouts pin this at
        seq_len's worth; paging's whole point is pulling it toward
        ``bytes_per_block / block_tokens``)."""
        self._kv_blocks_in_use.set(pool.blocks_in_use)
        self._kv_blocks_free.set(pool.blocks_free)
        cow, shared = pool.cow_copies, pool.shared_block_maps
        if cow > self._cow_seen:
            self._kv_cow_copies.inc(cow - self._cow_seen)
        self._cow_seen = cow
        if shared > self._shared_seen:
            self._prefix_shared_blocks.inc(shared - self._shared_seen)
        self._shared_seen = shared
        if active_tokens > 0:
            self._kv_bytes_per_token.set(
                pool.blocks_in_use * pool.bytes_per_block / active_tokens
            )

    def throughput(self) -> Optional[float]:
        """Generated tokens per wall-second over the ticks observed."""
        if self._t_start is None or self._t_last is None:
            return None
        dt = self._t_last - self._t_start
        if dt <= 0:
            return None
        return self.tokens_out / dt

    def summary(self) -> Dict[str, float]:
        def ms(x):
            return None if x is None else round(x * 1000.0, 3)

        def hist_mean(h, digits):
            m = h.mean()
            return None if m is None else round(m, digits)

        probes = self.prefix_hits + self.prefix_misses
        qd_max = self._queue_depth.max
        out = {
            "ticks": self.ticks,
            "decode_ticks": self.decode_ticks,
            "prefills": self.prefills,
            "prefill_calls": self.prefill_calls,
            "prefill_chunks": self.prefill_chunks,
            "prefix_hits": self.prefix_hits,
            "prefix_misses": self.prefix_misses,
            "prefix_evictions": self.prefix_evictions,
            "prefix_hit_rate": (
                round(self.prefix_hits / probes, 4) if probes else None
            ),
            "prefix_entries": int(self._prefix_entries.value),
            "prefix_entry_bytes": (
                int(self._prefix_entry_bytes.value)
                if self._prefix_bytes_known
                else None
            ),
            "kv_host_blocks_in_use": int(self._kv_host_blocks.value),
            "kv_host_offloads": int(self._kv_host_offloads.value),
            "kv_host_restored_blocks": int(self._kv_host_restored.value),
            "kv_host_evictions": int(self._kv_host_evictions.value),
            "kv_host_restore_failures": int(
                self._kv_restore_failures.value
            ),
            "kv_integrity_failures": int(
                self._kv_integrity_failures.value
            ),
            "kv_host_breaker_state": int(self._kv_breaker_state.value),
            "kv_host_breaker_trips": int(self._kv_breaker_trips.value),
            "integrity_trips": int(self._integrity_trips.value),
            "finished": self.finished,
            "rejected": self.rejected,
            "expired": self.expired,
            "cancelled": self.cancelled,
            "tokens_out": self.tokens_out,
            "tokens_drafted": self.tokens_drafted,
            "tokens_accepted": self.tokens_accepted,
            "spec_acceptance_rate": (
                round(self.tokens_accepted / self.tokens_drafted, 4)
                if self.tokens_drafted
                else None
            ),
            "spec_wasted_positions": self.spec_wasted_positions,
            "tokens_per_decode_tick": (
                round(self.tokens_out / self.decode_ticks, 3)
                if self.decode_ticks
                else None
            ),
            "kv_blocks_in_use": self.kv_blocks_in_use,
            "kv_blocks_free": self.kv_blocks_free,
            "kv_block_cow_copies": self.kv_block_cow_copies,
            "prefix_shared_blocks": self.prefix_shared_blocks,
            "kv_bytes_per_active_token": (
                round(float(self._kv_bytes_per_token.value), 1)
                if self._kv_bytes_per_token.value
                else None
            ),
            "host_dispatches": self.host_dispatches,
            "tokens_per_dispatch_mean": hist_mean(
                self._tokens_per_dispatch, 3
            ),
            "unified_tick_tokens_mean": hist_mean(
                self._unified_tick_tokens, 3
            ),
            "overlapped_dispatches": int(self._overlapped.value),
            "host_overlap_ratio": (
                round(
                    min(
                        int(self._overlapped.value)
                        / max(self.decode_ticks, 1),
                        1.0,
                    ),
                    4,
                )
                if int(self._overlapped.value)
                else 0.0
            ),
            "host_ms_per_tick_p50": (
                None
                if self._host_ms_per_tick.percentile(50) is None
                else round(self._host_ms_per_tick.percentile(50), 3)
            ),
            "host_ms_per_tick_p95": (
                None
                if self._host_ms_per_tick.percentile(95) is None
                else round(self._host_ms_per_tick.percentile(95), 3)
            ),
            "tokens_per_sec": (
                round(self.throughput(), 1)
                if self.throughput() is not None
                else None
            ),
            "ttft_ms_p50": ms(self._ttft.percentile(50)),
            "ttft_ms_p95": ms(self._ttft.percentile(95)),
            "itl_ms_p50": ms(self._itl.percentile(50)),
            "itl_ms_p95": ms(self._itl.percentile(95)),
            "slot_occupancy_mean": hist_mean(self._occupancy, 4),
            "queue_depth_mean": hist_mean(self._queue_depth, 2),
            "queue_depth_max": (
                None if qd_max is None else int(qd_max)
            ),
        }
        # SSD-tier rows only appear once a disk store has synced at
        # least once — a summary without them means "no disk tier",
        # which old consumers (and disk-less configs) rely on
        if self._disk_tier_seen:
            out.update(
                {
                    "kv_disk_blocks": int(self._kv_disk_blocks.value),
                    "kv_disk_bytes": int(self._kv_disk_bytes.value),
                    "kv_disk_spills": int(self._kv_disk_spills.value),
                    "kv_disk_restores": int(
                        self._kv_disk_restores.value
                    ),
                    "kv_disk_restore_failures": int(
                        self._kv_disk_restore_failures.value
                    ),
                    "kv_disk_breaker_state": int(
                        self._kv_disk_breaker_state.value
                    ),
                    "kv_disk_breaker_trips": int(
                        self._kv_disk_breaker_trips.value
                    ),
                    "kv_disk_manifest_records": int(
                        self._kv_disk_manifest_records.value
                    ),
                    "kv_disk_manifest_compactions": int(
                        self._kv_disk_manifest_compactions.value
                    ),
                    "kv_disk_seeded_blocks": int(
                        self._kv_disk_seeded_blocks.value
                    ),
                }
            )
        return out
