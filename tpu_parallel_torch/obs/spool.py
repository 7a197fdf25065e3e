"""Per-process span spooling: the bounded JSONL span log behind
``GET /v1/tracez``.

Each fleet process (router or daemon) owns one :class:`SpanSpool`
pointed at its tracer.  The owner's pump tick calls :meth:`drain`,
which appends every newly FINISHED span and instant as one JSONL record
— the journal's record discipline exactly (CRC32 as the textual last
key, via :func:`tpu_parallel_torch.daemon.journal.encode_record`), with all
file IO through the ``iofaults`` shim so the fault-injection tests can
reach it.

Unlike the request journal, a span log is LOSS-TOLERANT: it is
telemetry, not the durability ledger.  So the reader
(:func:`read_span_log`) skips damaged lines TYPED — counting them under
``garbage`` (unparseable) or ``crc`` (parseable, checksum disagrees) —
instead of refusing the file, and rotation simply drops the oldest half
when the log exceeds ``max_bytes`` (sidecar + ``os.replace``, the
journal's crash-safe rotation shape).

Record shapes (one JSON object per line)::

    {"kind": "meta", "proc": ..., "pid": ..., "crc": ...}
    {"kind": "span", "proc": ..., "pid": ..., "name": ..., "track": ...,
     "start": ..., "end": ..., "attrs": {...},
     ["trace_id": ..., "span_id": ..., "parent_id": ...], "crc": ...}
    {"kind": "instant", "proc": ..., "pid": ..., "name": ..., "ts": ...,
     "attrs": {...}, ["trace_id": ..., "parent_id": ...], "crc": ...}

Timestamps are the OWNING process's monotonic clock — NOT comparable
across processes; trace stitching (``tpu_parallel/obs/stitch.py``) rebases them using the
router's per-peer ``clock_sync`` samples.

The heavy daemon modules (``iofaults``, ``journal``) are imported
lazily inside methods: ``tpu_parallel_torch.obs`` must stay importable
without pulling the whole serving stack.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

__all__ = [
    "SKIP_GARBAGE",
    "SKIP_CRC",
    "SpanSpool",
    "read_span_log",
]

SKIP_GARBAGE = "garbage"  # unparseable line
SKIP_CRC = "crc"  # parseable record whose checksum disagrees

_DEFAULT_MAX_BYTES = 4 * 1024 * 1024


class SpanSpool:
    """Append-only, size-bounded span log for ONE process."""

    def __init__(self, path: str, proc: str,
                 max_bytes: int = _DEFAULT_MAX_BYTES):
        if max_bytes <= 0:
            raise ValueError(f"max_bytes={max_bytes} must be positive")
        self.path = path
        self.proc = proc
        self.pid = os.getpid()
        self.max_bytes = max_bytes
        self.rotations = 0
        self.dropped = 0  # records lost to rotation, lifetime
        self._span_cursor = 0
        self._instant_cursor = 0
        self._pending: List = []  # seen but not yet finished spans
        self._fh = None
        self._bytes = 0
        self._open()
        if self._bytes == 0:
            self._write({"kind": "meta", "proc": self.proc,
                         "pid": self.pid})
            self._fh.flush()

    # -- IO (all through the iofaults shim) ---------------------------------

    def _open(self) -> None:
        from tpu_parallel_torch.daemon import iofaults

        self._fh = iofaults.open_file(self.path, "a", encoding="utf-8")
        self._bytes = os.path.getsize(self.path)

    def _write(self, rec: Dict) -> None:
        from tpu_parallel_torch.daemon import iofaults
        from tpu_parallel_torch.daemon.journal import encode_record

        line, _crc = encode_record(rec)
        iofaults.write_line(self._fh, line + "\n")
        self._bytes += len(line) + 1

    def _record_of_span(self, span) -> Dict:
        rec = {"kind": "span", "proc": self.proc, "pid": self.pid}
        rec.update(span.to_dict())
        return rec

    def _record_of_instant(self, ev: Dict) -> Dict:
        rec = {"kind": "instant", "proc": self.proc, "pid": self.pid}
        rec.update(ev)
        return rec

    # -- the pump entry point -----------------------------------------------

    def drain(self, tracer) -> int:
        """Append every span finished (and instant recorded) since the
        last drain.  Returns the record count written.  Unfinished spans
        are parked and re-checked next drain — span lists are
        append-only, so two cursors cover them."""
        written = 0
        still_open: List = []
        for span in self._pending:
            if span.end is None:
                still_open.append(span)
            else:
                self._write(self._record_of_span(span))
                written += 1
        self._pending = still_open
        spans = tracer.spans
        while self._span_cursor < len(spans):
            span = spans[self._span_cursor]
            self._span_cursor += 1
            if span.end is None:
                self._pending.append(span)
            else:
                self._write(self._record_of_span(span))
                written += 1
        instants = tracer.instants
        while self._instant_cursor < len(instants):
            self._write(self._record_of_instant(
                instants[self._instant_cursor]
            ))
            self._instant_cursor += 1
            written += 1
        if written:
            self._fh.flush()
            if self._bytes > self.max_bytes:
                self._rotate()
        return written

    def _rotate(self) -> None:
        """Drop the oldest half of the log, crash-safely: survivors go
        to a sidecar first, then one atomic ``os.replace``."""
        from tpu_parallel_torch.daemon import iofaults
        from tpu_parallel_torch.daemon.journal import ROTATE_SUFFIX

        self._fh.close()
        lines = iofaults.read_text(self.path).splitlines()
        keep = lines[len(lines) // 2:]
        self.dropped += len(lines) - len(keep)
        tmp = self.path + ROTATE_SUFFIX
        meta_line, _ = _encode_meta(
            {"kind": "meta", "proc": self.proc, "pid": self.pid,
             "rotated": self.rotations + 1, "dropped": self.dropped}
        )
        with iofaults.open_file(tmp, "w", encoding="utf-8") as fh:
            iofaults.write_line(fh, meta_line + "\n")
            for line in keep:
                iofaults.write_line(fh, line + "\n")
            fh.flush()
            iofaults.fsync_file(fh)
        os.replace(tmp, self.path)
        self.rotations += 1
        self._open()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def status(self) -> Dict:
        return {
            "path": self.path,
            "proc": self.proc,
            "pid": self.pid,
            "bytes": self._bytes,
            "rotations": self.rotations,
            "dropped": self.dropped,
        }


def _encode_meta(rec: Dict) -> Tuple[str, int]:
    from tpu_parallel_torch.daemon.journal import encode_record

    return encode_record(rec)


def read_span_log(
    path: str, trace_id: Optional[str] = None,
) -> Tuple[List[Dict], Dict[str, int]]:
    """Read one process's span log.  Returns ``(records, skipped)``
    where ``skipped`` counts damaged lines by typed reason.  Damage is
    SKIPPED, not fatal — telemetry must degrade, not wedge — but always
    visibly: the caller re-exports the counts.

    With ``trace_id``, span/instant records are filtered to that trace;
    ``clock_sync`` instants are ALWAYS kept (they carry no trace id and
    every stitch needs them for cross-process alignment), as are meta
    records."""
    from tpu_parallel_torch.daemon import iofaults
    from tpu_parallel_torch.daemon.journal import record_crc_ok

    records: List[Dict] = []
    skipped = {SKIP_GARBAGE: 0, SKIP_CRC: 0}
    if not os.path.exists(path):
        return records, skipped
    for line in iofaults.read_text(path).splitlines():
        if not line.strip():
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            skipped[SKIP_GARBAGE] += 1
            continue
        if not isinstance(rec, dict):
            skipped[SKIP_GARBAGE] += 1
            continue
        if record_crc_ok(rec) is False:
            skipped[SKIP_CRC] += 1
            continue
        if trace_id is not None and rec.get("kind") in ("span", "instant"):
            if rec.get("trace_id") != trace_id and (
                rec.get("name") != "clock_sync"
            ):
                continue
        records.append(rec)
    return records, skipped
