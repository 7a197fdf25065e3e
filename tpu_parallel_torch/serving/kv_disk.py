"""SSD-backed third KV tier: per-block-CRC'd blobs + a persisted radix
manifest, so the prefix cache survives a restart.  A copy of
``tpu_parallel/serving/kv_disk.py`` (plain Python) over the port's
copies of ``daemon/journal.py``, ``daemon/iofaults.py`` and
``serving/kv_wire.py``: blob files and manifests are byte-compatible
with the JAX package's, so a directory written by either boots the other.

The host-RAM hierarchy (``serving/kv_hierarchy.py``) ends at host RAM and
dies with the process; million-user prefix working sets (system
prompts, few-shot preambles, RAG boilerplate) are bigger than RAM and
live longer than a deploy.  This module is the tier UNDER the host
offload tier:

- **Blobs.** Each disk-resident radix node is one file
  (``b<N>.kvw``) holding exactly one :class:`~tpu_parallel_torch.serving.
  kv_hierarchy.KVPrefixExport` frame in the ``kv_wire`` encoding — the
  SAME self-checksummed format the fleet ships over the network, so
  damage detection and typed refusals on the disk path are the code
  the wire path already proves.  The export's ``tokens`` carry the
  FULL root-to-node chain (payload = the node's one block), which is
  what makes a cold restart able to rebuild the tree from files alone.
- **Manifest.** ``manifest.jsonl`` records which chains live on disk
  (``kv_put`` / ``kv_del``), managed by the daemon's
  :class:`~tpu_parallel_torch.daemon.journal.JournalWriter` — per-record
  CRC32, monotone seqs, torn-tail truncation, and crash-safe
  ``rotate()`` compaction come for free and behave EXACTLY like the
  request journal under the same seeded faults.
- **Fault domain.** Every byte in or out routes through
  :mod:`~tpu_parallel_torch.daemon.iofaults`, so ``daemon_bench``'s seeded bit rot / EIO / ENOSPC land
  on the verify-or-recompute path; failures surface as typed
  :class:`KVDiskError` and feed the hierarchy's disk breaker.

The store is deliberately DUMB: it maps blob ids to verified exports
and keeps the manifest truthful.  Eviction policy, the breaker, the
prefix-closure invariant (every disk chain restorable from block 0)
and restart seeding live in ``RadixPrefixCache`` — the store never
decides what is hot.
"""

from __future__ import annotations

import dataclasses
import errno
import os
from typing import Callable, Dict, List, Optional, Tuple

from ..daemon import iofaults
from ..daemon.journal import JournalCorrupt, JournalWriter, read_journal
from .kv_hierarchy import KVPrefixExport
from .kv_wire import (
    WIRE_INTEGRITY,
    WIRE_REASONS,
    WIRE_TRUNCATED,
    WireFormatError,
    decode_exports,
    encode_export,
)

MANIFEST_NAME = "manifest.jsonl"
BLOB_SUFFIX = ".kvw"

# manifest record kinds — unknown to the daemon's recovery scan by
# design (read_journal passes unrecognized kinds through untouched)
REC_KV_PUT = "kv_put"
REC_KV_DEL = "kv_del"

# typed failure vocabulary: the wire format's reasons (a rotted blob
# refuses exactly like a rotted network frame) plus the disk-only
# shapes.  Pinned by tests — breaker accounting and bench legs key on
# these strings.
DISK_IO_ERROR = "io_error"
DISK_ENOSPC = "enospc"
DISK_MISSING = "missing_blob"
DISK_WEIGHTS = "weights_version"
DISK_CAPACITY = "capacity"
DISK_MANIFEST = "manifest_corrupt"
DISK_REASONS = WIRE_REASONS + (
    DISK_IO_ERROR,
    DISK_ENOSPC,
    DISK_MISSING,
    DISK_WEIGHTS,
    DISK_CAPACITY,
    DISK_MANIFEST,
)


class KVDiskError(RuntimeError):
    """A disk-tier operation that cannot be trusted — carries the typed
    ``reason`` (one of :data:`DISK_REASONS`) the hierarchy counts and
    the breaker feeds on.  Corrupted or unreadable bytes NEVER serve;
    the caller recomputes bitwise."""

    def __init__(self, reason: str, detail: str):
        assert reason in DISK_REASONS, reason
        super().__init__(f"{reason}: {detail}")
        self.reason = reason
        self.detail = detail


@dataclasses.dataclass(frozen=True)
class DiskEntry:
    """One manifest-recorded blob: the token chain it restores, the
    block CRC recorded at spill (cross-checked against the decoded
    frame, so a self-consistent but WRONG blob still refuses), the
    weight set it was computed under, and its payload size."""

    blob: int
    tokens: Tuple[int, ...]
    crc: int
    weights_version: str
    nbytes: int


class KVDiskStore:
    """Blob files + journal-backed manifest under one directory.

    ``clock`` is injectable (serving reads no wall time of its own) —
    it stamps manifest records and drives
    ``manifest_age_seconds``.  ``capacity_blocks`` bounds resident
    blobs; the HIERARCHY evicts to make room (the store just refuses
    past the line, typed ``capacity``)."""

    def __init__(
        self,
        root: str,
        clock: Callable[[], float],
        *,
        capacity_blocks: int,
        fsync_batch: int = 8,
        compact_min_records: int = 64,
        compact_factor: int = 4,
    ):
        if capacity_blocks < 1:
            raise ValueError(f"capacity_blocks={capacity_blocks} < 1")
        os.makedirs(root, exist_ok=True)
        self.root = root
        self.clock = clock
        self.capacity_blocks = capacity_blocks
        self.compact_min_records = compact_min_records
        self.compact_factor = compact_factor
        self.manifest_path = os.path.join(root, MANIFEST_NAME)
        # lifetime tallies (this process)
        self.puts = 0
        self.deletes = 0
        self.loads = 0
        self.manifest_errors = 0
        self.swept_blobs = 0
        # non-None when construction found mid-file manifest damage:
        # the typed reason we reset on (serving is unaffected — the
        # disk tier is a cache, an untrustworthy index starts empty)
        self.manifest_reset_reason: Optional[str] = None
        self._entries: Dict[int, DiskEntry] = {}
        next_seq = self._fold_manifest()
        self._writer = JournalWriter(
            self.manifest_path,
            clock,
            fsync_batch=fsync_batch,
            next_seq=next_seq,
        )
        self._sweep_unreferenced()
        self._next_blob = 1 + max(self._entries, default=-1)
        self._last_append = clock()

    # -- construction helpers ------------------------------------------------

    def _fold_manifest(self) -> int:
        """Replay the manifest into ``_entries``.  Tail damage is
        tolerated (the journal reader truncates it); MID-file damage is
        a manifest that lies — typed reset to empty, old file removed
        so the fresh writer does not weld onto garbage."""
        if not os.path.exists(self.manifest_path):
            return 0
        try:
            records, _torn = read_journal(self.manifest_path)
        except JournalCorrupt as err:
            self.manifest_reset_reason = err.reason
            self.manifest_errors += 1
            os.remove(self.manifest_path)
            return 0
        for rec in records:
            kind = rec.get("record")
            if kind == REC_KV_PUT:
                try:
                    entry = DiskEntry(
                        blob=int(rec["blob"]),
                        tokens=tuple(int(t) for t in rec["tokens"]),
                        crc=int(rec["bcrc"]),
                        weights_version=str(rec["wv"]),
                        nbytes=int(rec.get("nbytes", 0)),
                    )
                except (KeyError, TypeError, ValueError):
                    # a CRC-valid record with a broken schema is a
                    # writer bug, not media rot — drop just the record
                    self.manifest_errors += 1
                    continue
                self._entries[entry.blob] = entry
            elif kind == REC_KV_DEL:
                self._entries.pop(rec.get("blob"), None)
        return records[-1]["seq"] + 1 if records else 0

    def _sweep_unreferenced(self) -> None:
        """Reconcile directory against manifest, both directions: a
        blob without a record is a torn put (the crash hit between
        blob fsync and manifest append) — garbage, removed; a record
        without a blob is a torn delete — the entry drops and a
        ``kv_del`` makes the manifest truthful again."""
        resident = set()
        for name in os.listdir(self.root):
            if not (name.startswith("b") and name.endswith(BLOB_SUFFIX)):
                continue
            try:
                blob = int(name[1 : -len(BLOB_SUFFIX)])
            except ValueError:
                continue
            resident.add(blob)
            if blob not in self._entries:
                try:
                    os.remove(os.path.join(self.root, name))
                    self.swept_blobs += 1
                except OSError:
                    pass
        for blob in [b for b in self._entries if b not in resident]:
            del self._entries[blob]
            self.swept_blobs += 1
            try:
                self._writer.append({"record": REC_KV_DEL, "blob": blob})
            except OSError:
                self.manifest_errors += 1

    # -- the three operations ------------------------------------------------

    def _blob_path(self, blob: int) -> str:
        return os.path.join(self.root, f"b{blob}{BLOB_SUFFIX}")

    def put(
        self,
        export: KVPrefixExport,
        chain_tokens: Tuple[int, ...],
    ) -> int:
        """Persist a one-block export; returns its blob id.

        ``export`` is a standard single-block ``kv_wire`` frame (its
        ``tokens`` are the node's own run); ``chain_tokens`` is the
        FULL root-to-node token chain the manifest records — what lets
        a cold restart rebuild the tree before reading any blob.  Order
        is blob-then-manifest with an fsync between, so every recorded
        entry has durable bytes behind it and a crash between the two
        leaves only a sweepable orphan file.  Raises typed
        :class:`KVDiskError` with the blob guaranteed absent."""
        if export.n_blocks != 1:
            raise ValueError(
                f"disk tier spills one block per blob, got "
                f"{export.n_blocks}"
            )
        if not export.checksums:
            raise ValueError("disk tier requires checksummed exports")
        chain_tokens = tuple(int(t) for t in chain_tokens)
        bt = export.block_tokens
        if (
            not chain_tokens
            or len(chain_tokens) % bt
            or chain_tokens[-bt:] != tuple(int(t) for t in export.tokens)
        ):
            raise ValueError(
                "chain_tokens must be a non-empty block multiple ending "
                "in the export's own run"
            )
        if len(self._entries) >= self.capacity_blocks:
            raise KVDiskError(
                DISK_CAPACITY,
                f"{len(self._entries)}/{self.capacity_blocks} blobs "
                "resident — evict before spilling",
            )
        if self._writer.wedged:
            raise KVDiskError(DISK_IO_ERROR, "manifest wedged")
        blob = self._next_blob
        self._next_blob += 1
        path = self._blob_path(blob)
        data = encode_export(export)
        try:
            fh = iofaults.open_file(path, "wb")
            try:
                iofaults.write_line(fh, data)
                fh.flush()
                iofaults.fsync_file(fh)
            finally:
                fh.close()
        except OSError as err:
            self._remove_blob(path)
            raise KVDiskError(self._os_reason(err), str(err)) from err
        try:
            self._writer.append({
                "record": REC_KV_PUT,
                "blob": blob,
                "tokens": list(chain_tokens),
                "bcrc": int(export.checksums[0]),
                "wv": export.weights_version,
                "nbytes": int(export.payload_bytes),
            })
        except OSError as err:
            self._remove_blob(path)
            self.manifest_errors += 1
            raise KVDiskError(self._os_reason(err), str(err)) from err
        self._entries[blob] = DiskEntry(
            blob=blob,
            tokens=chain_tokens,
            crc=int(export.checksums[0]),
            weights_version=export.weights_version,
            nbytes=int(export.payload_bytes),
        )
        self.puts += 1
        self._last_append = self.clock()
        self._maybe_compact()
        return blob

    def load(self, blob: int) -> KVPrefixExport:
        """Read + verify one blob.  Three layers must agree before any
        byte serves: the frame's own block CRCs (``decode_exports``
        with ``verify=True``), the manifest's recorded CRC (so a
        self-consistent but swapped blob refuses), and the recorded
        token chain.  Any disagreement is a typed refusal — the caller
        drops the subtree and recomputes bitwise."""
        entry = self._entries.get(blob)
        if entry is None:
            raise KVDiskError(DISK_MISSING, f"blob {blob} not in manifest")
        path = self._blob_path(blob)
        try:
            exports = decode_exports(iofaults.read_bytes(path), verify=True)
        except FileNotFoundError as err:
            raise KVDiskError(DISK_MISSING, str(err)) from err
        except OSError as err:
            raise KVDiskError(self._os_reason(err), str(err)) from err
        except WireFormatError as err:
            raise KVDiskError(err.reason, err.detail) from err
        if len(exports) != 1:
            raise KVDiskError(
                WIRE_TRUNCATED,
                f"blob {blob} holds {len(exports)} frames, expected 1",
            )
        export = exports[0]
        if (
            export.length > len(entry.tokens)
            or tuple(int(t) for t in export.tokens)
            != entry.tokens[len(entry.tokens) - export.length :]
        ):
            # the blob's run must be the recorded chain's tail — a
            # self-consistent but SWAPPED blob refuses here
            raise KVDiskError(
                WIRE_INTEGRITY,
                f"blob {blob} token run disagrees with manifest chain",
            )
        if not export.checksums or int(export.checksums[0]) != entry.crc:
            raise KVDiskError(
                WIRE_INTEGRITY,
                f"blob {blob} CRC disagrees with manifest",
            )
        self.loads += 1
        return export

    def delete(self, blob: int) -> None:
        """Drop a blob + its manifest entry.  Idempotent; a manifest
        append failure here is tallied, not raised — the boot-time
        sweep reconciles either half-state."""
        entry = self._entries.pop(blob, None)
        if entry is None:
            return
        self._remove_blob(self._blob_path(blob))
        try:
            self._writer.append({"record": REC_KV_DEL, "blob": blob})
        except OSError:
            self.manifest_errors += 1
        self.deletes += 1
        self._last_append = self.clock()
        self._maybe_compact()

    # -- compaction ----------------------------------------------------------

    def _maybe_compact(self) -> None:
        """Rotate once the segment carries ``compact_factor`` records
        per live entry (floored at ``compact_min_records``): restart
        fold then reads O(live) records instead of O(churn)."""
        threshold = max(
            self.compact_min_records,
            self.compact_factor * max(1, len(self._entries)),
        )
        if self._writer.records_since_rotate < threshold:
            return
        self.compact()

    def compact(self) -> None:
        """Journal-style rotation: the snapshot is the live put set.
        Crash-safe at every point (sidecar then atomic replace; an
        orphan sidecar is discarded at the next construction)."""
        snapshot = [
            {
                "record": REC_KV_PUT,
                "blob": e.blob,
                "tokens": list(e.tokens),
                "bcrc": e.crc,
                "wv": e.weights_version,
                "nbytes": e.nbytes,
            }
            for e in sorted(self._entries.values(), key=lambda e: e.blob)
        ]
        try:
            self._writer.rotate(snapshot)
        except OSError:
            self.manifest_errors += 1

    # -- accounting ----------------------------------------------------------

    @staticmethod
    def _os_reason(err: OSError) -> str:
        return DISK_ENOSPC if err.errno == errno.ENOSPC else DISK_IO_ERROR

    @staticmethod
    def _remove_blob(path: str) -> None:
        try:
            os.remove(path)
        except OSError:
            pass

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, blob: int) -> bool:
        return blob in self._entries

    @property
    def blocks_in_use(self) -> int:
        return len(self._entries)

    @property
    def payload_bytes(self) -> int:
        return sum(e.nbytes for e in self._entries.values())

    @property
    def manifest_records(self) -> int:
        """Appends this process — with :attr:`manifest_compactions`,
        the ``serving_kv_disk_manifest_*`` metric pair."""
        return self._writer.records

    @property
    def manifest_compactions(self) -> int:
        return self._writer.rotations

    @property
    def wedged(self) -> bool:
        return self._writer.wedged

    def manifest_age_seconds(self) -> float:
        """Seconds since the last manifest append (construction counts
        — a freshly folded manifest is as fresh as its fold)."""
        return max(0.0, self.clock() - self._last_append)

    def entries(self) -> List[DiskEntry]:
        """Live entries, shortest chain first — the order restart
        seeding wants (a node's ancestors fold before it)."""
        return sorted(
            self._entries.values(), key=lambda e: (len(e.tokens), e.blob)
        )

    def sync(self) -> None:
        self._writer.sync()

    def close(self) -> None:
        self._writer.close()
