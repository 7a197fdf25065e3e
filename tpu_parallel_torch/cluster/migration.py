"""Cross-replica KV block migration: ship a relocated request's cache
instead of recomputing it.

Every relocation path the cluster grew — crash replay, swap
drain-timeout relocation, autopilot fleet moves — ends
in the same forced-prefix replay: the request's prompt plus every
delivered token re-prefills on the new replica.  Correct and bitwise
exact, but the prefill is pure recompute of K/V the source replica
already holds.  This shim turns that into a copy wherever the source
engine is still alive to be read:

- **capture** (:func:`capture_kv`): right before a relocation cancels
  the source slot, export the request's written full-block KV prefix as
  host bytes (:meth:`ServingEngine.export_prefix` →
  :class:`~tpu_parallel_torch.serving.kv_hierarchy.KVPrefixExport`).  Best
  effort: a dead engine, a fixed-slot engine, or a request with less
  than one full block written all yield None and the replay recomputes
  exactly as before.
- **install** (:func:`install_kv`): after the frontend places the
  replay, import the export into the target engine's prefix cache
  (:meth:`ServingEngine.import_prefix`) so the replay's admission HITS
  and only the remainder prefills.  The verdict is typed
  (``kv_hierarchy.MIGRATION_STATUSES``) and counted per status by the
  frontend — recompute survives only as an observable fallback, never a
  silent one.  A ``weights_version`` mismatch refuses: cached K/V is a
  function of the params.
- **warm start** (:func:`warm_start`): autopilot scale-ups reuse the
  same primitive in bulk — a newcomer's cold prefix cache pre-seeds
  from the hottest radix chains of a live donor, so rebalanced traffic
  hits immediately instead of re-prefilling every hot tenant header.

The crash path stays recompute-only by construction: a dead replica's
engine is in an unknown state and must not be read.  That asymmetry is
the point — migration is an optimization layered on the replay, and
every failure mode degrades to the replay's proven bitwise story.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

from tpu_parallel_torch.serving.kv_hierarchy import (
    MIGRATE_ALREADY_CACHED,
    MIGRATE_IMPORTED,
    MIGRATION_STATUSES,
    KVPrefixExport,
)

__all__ = [
    "MIGRATION_STATUSES",
    "MIGRATE_IMPORTED",
    "MIGRATE_ALREADY_CACHED",
    "capture_kv",
    "install_kv",
    "land_exports",
    "warm_start",
]


def capture_kv(handle, engine_rid: str) -> Optional[KVPrefixExport]:
    """Best-effort export of a live attempt's KV prefix from
    ``handle``'s engine (None when nothing is exportable) — call BEFORE
    the relocation cancels the slot, because the cancel frees the
    blocks.  Thin alias over :meth:`ReplicaHandle.export_kv` so call
    sites read as migration, not replica plumbing."""
    return handle.export_kv(engine_rid)


def install_kv(handle, export: KVPrefixExport) -> str:
    """Land ``export`` in ``handle``'s engine prefix cache; returns the
    engine's typed verdict (see ``kv_hierarchy.MIGRATION_STATUSES``).
    Success means the forced-prefix replay's admission will hit and skip
    recomputing ``export.length`` tokens; any other verdict leaves the
    replay recomputing exactly as before migration existed."""
    return handle.engine.import_prefix(export)


def land_exports(
    engine, exports: Iterable[KVPrefixExport]
) -> Dict[str, int]:
    """Land a batch of exports in ``engine``'s prefix cache, counting
    typed verdicts — the transport-agnostic half every import path
    shares: the in-process :func:`warm_start` below, the daemon's
    ``/v1/kv/import`` peer endpoint, and the fleet router's donor-to-
    newcomer push all reduce to this loop.  Nothing here knows where
    the exports came from; the caller already decoded (and the engine
    re-verifies) them, so a corrupt export is a counted ``integrity``
    verdict, never a partial landing."""
    counts: Dict[str, int] = {}
    for export in exports:
        verdict = engine.import_prefix(export)
        counts[verdict] = counts.get(verdict, 0) + 1
    return counts


def warm_start(donor, newcomer, max_blocks: int) -> int:
    """Pre-seed ``newcomer``'s prefix cache from ``donor``'s hottest
    radix chains (up to ``max_blocks`` blocks exported).  Returns the
    block count actually imported — zero when either side lacks the
    radix hierarchy, versions mismatch, or the newcomer's pool is too
    tight; all silent no-ops, because a cold cache is merely slow, not
    wrong."""
    exporter = getattr(donor.engine, "export_hot_prefixes", None)
    if exporter is None:
        return 0
    radix = getattr(newcomer.engine, "_radix", None)
    before = radix.device_blocks if radix is not None else 0
    any_imported = False
    for export in exporter(max_blocks=max_blocks):
        if newcomer.engine.import_prefix(export) == MIGRATE_IMPORTED:
            any_imported = True
    if radix is None:
        return 1 if any_imported else 0
    # count DISTINCT blocks actually landed: sibling chains share root
    # blocks, and the tree frees the duplicates on insert — summing
    # export sizes would over-report the seed (clamped: budget pressure
    # during import can evict other residents)
    return max(0, radix.device_blocks - before)
