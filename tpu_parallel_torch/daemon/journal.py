"""Write-ahead request journal: the daemon's crash-recovery contract.
A copy of ``tpu_parallel/daemon/journal.py`` (plain Python); in the port
its first user is the disk KV tier's manifest (``serving/kv_disk.py``).

Append-only JSONL with monotone sequence numbers, batched fsync, and a
per-record CRC32.  Every record the daemon must not lose across a
``kill -9`` goes through here BEFORE the effect is acknowledged to a
client:

- ``submit``   — an ACCEPTED submission (the full request payload plus
  the client's dedupe token).  Synced durably before the accept is
  returned, so an acknowledged request can never vanish.  The payload
  field names are intentionally the serve_bench trace-schema names
  (``arrival`` / ``prompt`` / ``prompt_len`` / ``prefix_group`` /
  ``priority`` / ``deadline`` / ``max_new_tokens``) — ONE workload
  exchange format, so ``serve_bench --trace-replay`` (alias
  ``--workload``) replays a production journal directly.
- ``tokens``   — tokens delivered to a request this tick (``index`` is
  the position of the first one).  Batched per tick; a torn tail loses
  at most the unsynced suffix, and greedy recovery regenerates exactly
  those tokens (forced-prefix replay is bitwise).
- ``terminal`` — a request reached a terminal state (status + typed
  ``finish_reason``).  A journaled terminal is what makes the dedupe
  token idempotent: a resubmission after it returns the completed
  record instead of re-admitting.
- ``decision`` — swap rollouts, autopilot actions, drain begin, the
  degraded-mode trip: the operator-action audit trail.
- ``recovery`` — a restart replayed the journal (counts ride along).
- ``shutdown`` — the process exited; ``clean`` distinguishes a drained
  exit (nothing open) from a forced fast shutdown (the journal IS the
  recovery contract for whatever was still open).

Integrity model: every record is written with a trailing ``crc``
field — CRC32 over its own serialization without that field — and
verified WHEN PRESENT on read (a pre-CRC journal still replays
unchanged).  A CRC-failed or unparseable record at the very END of the
file is the torn-write/bit-rot tail shape: tolerated by
:func:`read_journal` (``torn`` counts it) and TRUNCATED by
:func:`drop_torn_tail` before any reopen-for-append.  The same damage
anywhere else raises a typed :class:`JournalCorrupt` — ``reason`` is
``"garbage"`` (unparseable), ``"crc"`` (parseable but checksum-failed)
or ``"seq_regression"`` (order lies) — because a journal that cannot
prove its own contents must not drive recovery.

Durability model: every ``append`` writes and flushes the line to the
OS immediately (a crashed *process* loses nothing flushed); ``fsync``
— the expensive disk barrier that survives a crashed *machine* — is
batched: forced for ``submit``/``shutdown`` records, otherwise issued
once at least ``fsync_batch`` records are pending (``sync()`` at each
tick boundary).  All file operations route through the injectable
fault shim (:mod:`tpu_parallel_torch.daemon.iofaults`), so seeded media
failure — ``EIO`` on fsync, ``ENOSPC`` mid-append, read-side bit
flips — soaks the whole stack deterministically.

Growth model: :meth:`JournalWriter.rotate` compacts the journal into a
fresh segment — a meta record plus a caller-provided snapshot of the
OPEN state (submit + tokens + terminal records per live request, with
fresh monotone seqs) — written to a sidecar, fsynced, and atomically
``os.replace``d over the old file.  Restart replay is therefore
O(open requests + retained completions), not O(lifetime); a crash at
ANY point leaves exactly one authoritative file (the sidecar is
ignored and removed until the atomic replace lands).

Timestamps come from the injected clock and are only comparable within
one process lifetime (the wall clock is monotonic per process) — replay
logic never compares times across a restart, only sequence numbers.
"""

from __future__ import annotations

import dataclasses
import json
import os
import zlib
from typing import Callable, Dict, List, Optional, Tuple

from tpu_parallel_torch.daemon import iofaults

JOURNAL_VERSION = 2  # 1 = no CRC; 2 adds per-record crc + rotation

# record kinds (the "record" field)
REC_META = "journal_meta"
REC_SUBMIT = "submit"
REC_TOKENS = "tokens"
REC_TERMINAL = "terminal"
REC_DECISION = "decision"
REC_RECOVERY = "recovery"
REC_SHUTDOWN = "shutdown"

# record kinds whose append forces an immediate fsync: an accepted
# submission must be durable before the client hears "accepted", a
# recovery record is the restart's first promise, and a shutdown record
# is the last thing the process does
_SYNC_NOW = frozenset({REC_SUBMIT, REC_RECOVERY, REC_SHUTDOWN})

# the compaction sidecar: authoritative ONLY after the atomic replace
ROTATE_SUFFIX = ".compact"

# tail-damage tolerance, in LINES: one interrupted/rotted record — but a
# single flipped bit can turn a payload byte into "\n" and split that
# record into TWO unparseable lines, so the tolerated trailing run is 2.
# Anything longer (or any bad line with a good record after it) is
# corruption a torn write cannot explain.
MAX_TORN_TAIL_LINES = 2

# typed JournalCorrupt reasons (the corruption matrix's vocabulary)
CORRUPT_GARBAGE = "garbage"  # unparseable mid-file bytes
CORRUPT_CRC = "crc"  # parseable record whose checksum disagrees
CORRUPT_SEQ = "seq_regression"  # sequence numbers went backwards


class JournalCorrupt(RuntimeError):
    """The journal failed its integrity scan somewhere a torn tail
    cannot explain.  ``reason`` is one of ``CORRUPT_GARBAGE`` /
    ``CORRUPT_CRC`` / ``CORRUPT_SEQ`` — each damage class is typed
    distinctly so operators (and tests) can tell bit rot from a logic
    bug."""

    def __init__(self, message: str, reason: str = CORRUPT_GARBAGE):
        super().__init__(message)
        self.reason = reason


def encode_record(rec: Dict) -> Tuple[str, int]:
    """Serialize ``rec`` (which must not already carry ``crc``) as one
    journal line with a trailing ``crc`` field: CRC32 over the
    serialization WITHOUT it.  Writing the checksum as the textual last
    key is what makes verification exact: a parsed dict preserves file
    key order, so re-serializing it minus ``crc`` reproduces these
    bytes."""
    body = json.dumps(rec)
    crc = zlib.crc32(body.encode("utf-8"))
    return body[:-1] + f', "crc": {crc}}}', crc


def record_crc_ok(rec: Dict) -> Optional[bool]:
    """Verify one parsed record against its ``crc`` field.

    Returns None for a record WITHOUT a checksum (a pre-CRC journal —
    verified when present, so version-1 journals replay unchanged), True
    when the recomputed CRC32 matches, False on any mismatch.  This is
    THE shared verification helper: :func:`read_journal` calls it, and so does
    the JAX package's workload replay, so both reject a corrupted record
    identically."""
    stored = rec.get("crc")
    if stored is None:
        return None
    rest = {k: v for k, v in rec.items() if k != "crc"}
    return zlib.crc32(json.dumps(rest).encode("utf-8")) == stored


class JournalWriter:
    """Append-only JSONL writer with sequence numbers, per-record CRC
    and batched fsync.

    ``clock`` is injectable (the daemon passes its :class:`~tpu_parallel_torch.
    daemon.wallclock.WallClock`); every record gets ``seq`` (monotone,
    continuing across restarts via ``next_seq``), ``at`` (clock time,
    process-local) and ``crc``.  ``fsync_batch`` records may ride the OS
    page cache between disk barriers — except the kinds in ``_SYNC_NOW``,
    which sync before ``append`` returns.  All file ops go through
    :mod:`~tpu_parallel_torch.daemon.iofaults`, so append/fsync failures are
    injectable; a failed append may leave a torn prefix in the file —
    :meth:`repair` truncates it so the writer can continue without
    welding the next record into mid-file garbage.
    """

    def __init__(
        self,
        path: str,
        clock: Callable[[], float],
        *,
        fsync_batch: int = 32,
        next_seq: int = 0,
    ):
        if fsync_batch < 1:
            raise ValueError(f"fsync_batch={fsync_batch} < 1")
        self.path = path
        self.clock = clock
        self.fsync_batch = fsync_batch
        self._seq = next_seq
        self._pending = 0  # records flushed to OS but not yet fsynced
        self.records = 0  # lifetime appends (this writer)
        self.records_since_rotate = 0  # the compaction trigger's counter
        self.fsyncs = 0
        self.rotations = 0
        # the disk refused even the post-failure repair: appends are
        # permanently unsafe (welding risk) — the daemon degrades
        self.wedged = False
        # a crash between writing the compaction sidecar and the atomic
        # replace leaves an orphan: the old file is still authoritative,
        # the sidecar never became the journal — drop it
        if os.path.exists(path + ROTATE_SUFFIX):
            os.remove(path + ROTATE_SUFFIX)
        self.truncated_tail = drop_torn_tail(path)
        fresh = not os.path.exists(path) or os.path.getsize(path) == 0
        self._fh = iofaults.open_file(path, "a", encoding="utf-8")
        if fresh:
            self.append({"record": REC_META, "journal_version": JOURNAL_VERSION})
            self.sync()

    def append(self, record: Dict) -> Dict:
        """Assign seq + timestamp + crc, write one line, flush to the
        OS.  Returns the full record as written.  Sync-now kinds fsync
        before returning; everything else waits for :meth:`sync`.

        Failure contract: ``append`` raises ``OSError`` ONLY with the
        record absent from the journal — a torn write is repaired
        (truncated) in place, and a sync-now record whose fsync barrier
        failed is WITHDRAWN (the durability promise was never made, so
        a later crash must not resurrect an un-acknowledged accept).
        If the disk refuses even that cleanup, ``wedged`` flips and
        every further append refuses fast — the caller degrades."""
        if self.wedged or self._fh.closed:
            # a closed handle (failed repair/rotate reopen) must surface
            # as the OSError the degraded-mode accounting understands,
            # never as a ValueError that escapes every handler
            raise OSError("journal wedged: no usable file handle")
        rec = dict(record)
        rec["seq"] = self._seq
        self._seq += 1
        rec.setdefault("at", round(self.clock(), 6))
        line, crc = encode_record(rec)
        rec["crc"] = crc
        data = line + "\n"
        try:
            iofaults.write_line(self._fh, data)
            self._fh.flush()
        except OSError:
            # a torn prefix may be in the file: truncate it NOW, or the
            # next append welds into mid-file garbage
            if not self.repair():
                self.wedged = True
            raise
        self.records += 1
        self.records_since_rotate += 1
        self._pending += 1
        if rec.get("record") in _SYNC_NOW:
            try:
                self.sync()
            except OSError:
                # the record is in the file but its durability barrier
                # failed — withdraw it so the accept the caller is
                # about to refuse cannot come back from the dead on
                # the next recovery
                if self._withdraw_tail(len(data.encode("utf-8"))):
                    self.records -= 1
                    self.records_since_rotate -= 1
                    self._pending -= 1
                else:
                    self.wedged = True
                raise
        elif self._pending >= self.fsync_batch:
            try:
                self.sync()
            except OSError:
                # opportunistic batch barrier only: the record itself
                # is safely appended, the tick-boundary sync() retries
                # the fsync and its owner counts the failure — raising
                # here would make the caller believe the append failed
                pass
        return rec

    def _withdraw_tail(self, nbytes: int) -> bool:
        """Truncate the last ``nbytes`` of the journal — the record just
        appended (single-writer: nothing can have landed after it) whose
        sync-now barrier failed.  Returns False when the disk refuses."""
        try:
            self._fh.close()
            with iofaults.open_file(self.path, "rb+") as fh:
                fh.seek(0, os.SEEK_END)
                fh.truncate(max(0, fh.tell() - nbytes))
            self._fh = iofaults.open_file(self.path, "a", encoding="utf-8")
            return True
        except OSError:
            return False

    def sync(self) -> bool:
        """Batched disk barrier: fsync when anything is pending (tick
        boundary) — a no-op on a clean writer.  Returns whether a real
        fsync was issued.  An injected/real ``EIO`` propagates with
        ``_pending`` intact, so the next tick retries the barrier."""
        if self._pending == 0:
            return False
        if self.wedged or self._fh.closed:
            raise OSError("journal wedged: no usable file handle")
        self._fh.flush()
        iofaults.fsync_file(self._fh)
        self.fsyncs += 1
        self._pending = 0
        return True

    def repair(self) -> bool:
        """Recover the writer after a failed append: close the handle,
        truncate any torn tail fragment (the partial record the failed
        write left behind), and reopen for append.  Without this, the
        NEXT append would weld onto the fragment and brick the journal
        (mid-file garbage) on the following restart.  Returns False
        when the disk refuses even the repair — the caller degrades."""
        try:
            if not self._fh.closed:
                self._fh.close()
            drop_torn_tail(self.path)
            self._fh = iofaults.open_file(self.path, "a", encoding="utf-8")
            return True
        except OSError:
            return False

    def rotate(self, snapshot: List[Dict]) -> int:
        """Segment rotation + compaction: write a fresh segment holding
        a meta record plus ``snapshot`` (payload dicts WITHOUT seq/at/
        crc — they are re-stamped with fresh monotone seqs), fsync it,
        and atomically replace the journal with it.  The retired
        segment's records are gone: restart replay now reads O(snapshot)
        records instead of O(lifetime).  Crash-safe at every point — the
        sidecar is not the journal until ``os.replace`` lands, and a
        leftover sidecar is discarded at the next writer construction.
        Returns the new segment's record count."""
        self.sync()  # the retiring segment's tail must be durable first
        tmp = self.path + ROTATE_SUFFIX
        try:
            with iofaults.open_file(tmp, "w", encoding="utf-8") as fh:
                recs = [{
                    "record": REC_META,
                    "journal_version": JOURNAL_VERSION,
                    "compacted": True,
                }] + [dict(r) for r in snapshot]
                for rec in recs:
                    rec["seq"] = self._seq
                    self._seq += 1
                    rec.setdefault("at", round(self.clock(), 6))
                    line, _ = encode_record(rec)
                    iofaults.write_line(fh, line + "\n")
                fh.flush()
                iofaults.fsync_file(fh)
        except OSError:
            # a half-written sidecar is garbage, never the journal
            if os.path.exists(tmp):
                os.remove(tmp)
            raise
        self._fh.close()
        os.replace(tmp, self.path)
        try:
            self._fh = iofaults.open_file(self.path, "a", encoding="utf-8")
        except OSError:
            # the new segment IS the journal (replace landed) but we
            # cannot append to it: wedge so every later call refuses
            # with a typed OSError instead of a closed-handle ValueError
            self.wedged = True
            raise
        self._pending = 0
        self.records += len(recs)
        self.records_since_rotate = 0
        self.rotations += 1
        return len(recs)

    @property
    def next_seq(self) -> int:
        return self._seq

    def close(self) -> None:
        if not self._fh.closed:
            self.sync()
            self._fh.close()

    def abort(self) -> None:
        """Crash simulation for tests: drop the handle without the
        closing sync (flushed lines survive, like a SIGKILL'd process)."""
        if not self._fh.closed:
            self._fh.close()


def _line_start(fh, end: int) -> int:
    """Byte offset where the line containing/ending at ``end`` starts
    (chunked backward scan, so one long record never loads the file)."""
    pos = end
    while pos > 0:
        step = min(4096, pos)
        fh.seek(pos - step)
        chunk = fh.read(step)
        nl = chunk.rfind(b"\n")
        if nl != -1:
            return pos - step + nl + 1
        pos -= step
    return 0


def _tail_record_bad(line: bytes) -> bool:
    """Is this complete final line an unusable record?  Unparseable
    bytes, a non-record object, or a CRC mismatch all count — exactly
    the damage classes :func:`read_journal` tolerates at the tail."""
    try:
        rec = json.loads(line.decode("utf-8", errors="replace"))
    except ValueError:
        return True
    if not isinstance(rec, dict) or "record" not in rec:
        return True
    return record_crc_ok(rec) is False


def drop_torn_tail(path: str) -> int:
    """Truncate tail damage before APPENDING to a journal.

    ``read_journal`` tolerates a bad tail record while *reading*, but a
    writer reopening in append mode would concatenate its first record
    onto the damage — turning tolerable tail damage into mid-file
    garbage that bricks the journal (:class:`JournalCorrupt`) on the
    NEXT restart.  Two damage shapes truncate: an unterminated FRAGMENT
    (the write a crash interrupted — never durable, already ignored by
    the reader) and a complete final line that fails parse or CRC (the
    bit-rot shape — its payload is unusable, and recovery regenerates
    anything it held bitwise via forced-prefix replay).  Returns the
    bytes truncated (0 when the file is absent, empty, or clean)."""
    if not os.path.exists(path) or os.path.getsize(path) == 0:
        return 0
    dropped = 0
    with iofaults.open_file(path, "rb+") as fh:
        fh.seek(0, os.SEEK_END)
        size = fh.tell()
        fh.seek(size - 1)
        if fh.read(1) != b"\n":
            # unterminated fragment: scan back to the last complete
            # line's newline and cut
            keep = _line_start(fh, size)
            fh.truncate(keep)
            dropped += size - keep
            size = keep
        # the last COMPLETE record(s): parse + CRC check (a flipped bit
        # leaves the line intact but the checksum disagreeing — or
        # mints a "\n" that split one record into two bad lines, so the
        # sweep runs up to the reader's tail tolerance)
        for _ in range(MAX_TORN_TAIL_LINES):
            if size == 0:
                break
            start = _line_start(fh, size - 1)
            fh.seek(start)
            line = fh.read(size - start).rstrip(b"\n")
            if not _tail_record_bad(line):
                break
            fh.truncate(start)
            dropped += size - start
            size = start
        if dropped:
            fh.flush()
            iofaults.fsync_file(fh)
    return dropped


def read_journal(path: str) -> Tuple[List[Dict], int]:
    """Scan a journal file.  Returns ``(records, torn)`` where ``torn``
    counts dropped trailing damaged LINES (at most
    ``MAX_TORN_TAIL_LINES`` — the record a crash tore mid-write or a
    bit flip corrupted, which a flip minting a newline can split in
    two).  Damage anywhere else raises a
    typed :class:`JournalCorrupt` — ``reason`` distinguishes
    unparseable garbage, a CRC mismatch, and a sequence-number
    regression: a journal that lies about its contents or order must
    not drive recovery.  CRC fields are verified when present, so a
    pre-CRC (version 1) journal replays unchanged.  The read goes through
    the fault shim, so seeded bit flips exercise this exact path."""
    records: List[Dict] = []
    # trailing run of damaged lines: (lineno, reason).  A good record
    # arriving while this is non-empty means the damage was MID-file;
    # a run longer than MAX_TORN_TAIL_LINES exceeds what one torn/
    # rotted record can explain.  Split on "\n" ONLY — the bytes the
    # writer delimits with, and the same splitting serve_bench's
    # load_trace uses (a flipped bit must not read differently through
    # the two surfaces; splitlines() would also split on form feeds and
    # unicode breaks a flip can mint).
    bad_run: List[Tuple[int, str]] = []
    for lineno, line in enumerate(
        iofaults.read_text(path).split("\n"), 1
    ):
        line = line.strip()
        if not line:
            continue
        reason = None
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            reason = CORRUPT_GARBAGE
            rec = None
        if reason is None and (
            not isinstance(rec, dict) or "record" not in rec
        ):
            reason = CORRUPT_GARBAGE
        if reason is None and record_crc_ok(rec) is False:
            reason = CORRUPT_CRC
        if reason is not None:
            bad_run.append((lineno, reason))
            if len(bad_run) > MAX_TORN_TAIL_LINES:
                at, why = bad_run[0]
                raise JournalCorrupt(
                    f"{path}:{at}: {why} damage spans more than "
                    f"{MAX_TORN_TAIL_LINES} lines — corrupt beyond a "
                    "torn write",
                    reason=why,
                )
            continue
        if bad_run:
            at, why = bad_run[0]
            raise JournalCorrupt(
                f"{path}:{at}: {why} record is not at the tail — the "
                "journal is corrupt beyond a torn write",
                reason=why,
            )
        records.append(rec)
    last = -1
    for rec in records:
        seq = rec.get("seq")
        if seq is None:
            continue
        if seq <= last:
            raise JournalCorrupt(
                f"{path}: sequence regressed {last} -> {seq}",
                reason=CORRUPT_SEQ,
            )
        last = seq
    return records, len(bad_run)


@dataclasses.dataclass
class JournalEntry:
    """Replay state for one journaled request: the submit payload, the
    durable token prefix, and the terminal record (None = the crash
    caught it accepted-but-unfinished — recovery re-admits it)."""

    submit: Dict
    tokens: List[int] = dataclasses.field(default_factory=list)
    terminal: Optional[Dict] = None

    @property
    def request_id(self) -> str:
        return self.submit["request_id"]

    @property
    def dedupe_token(self) -> Optional[str]:
        return self.submit.get("dedupe_token")

    @property
    def unfinished(self) -> bool:
        return self.terminal is None


@dataclasses.dataclass
class RecoveryState:
    """Everything a restart needs from the journal: per-request entries
    in submit order, the dedupe index, the next sequence number, and the
    scan's damage/shutdown accounting."""

    entries: Dict[str, JournalEntry]
    order: List[str]
    dedupe: Dict[str, str]  # dedupe_token -> request_id
    next_seq: int
    torn_records: int
    clean_shutdown: bool
    recoveries: int  # prior recovery records (restart count)
    decisions: int

    @property
    def unfinished(self) -> List[JournalEntry]:
        return [
            self.entries[rid]
            for rid in self.order
            if self.entries[rid].unfinished
        ]

    @property
    def finished(self) -> List[JournalEntry]:
        return [
            self.entries[rid]
            for rid in self.order
            if not self.entries[rid].unfinished
        ]


def replay_state(records: List[Dict], torn: int = 0) -> RecoveryState:
    """Fold a journal scan into :class:`RecoveryState`.  Token records
    apply by INDEX (idempotent across overlapping replays: a re-delivery
    of positions already durable overwrites them with identical values
    under greedy decoding); a terminal closes its entry."""
    entries: Dict[str, JournalEntry] = {}
    order: List[str] = []
    dedupe: Dict[str, str] = {}
    next_seq = 0
    clean = False
    recoveries = 0
    decisions = 0
    for rec in records:
        seq = rec.get("seq")
        if seq is not None:
            next_seq = max(next_seq, seq + 1)
        kind = rec.get("record")
        if kind == REC_SUBMIT:
            rid = rec["request_id"]
            if rid not in entries:  # duplicate submits cannot re-open
                entries[rid] = JournalEntry(submit=rec)
                order.append(rid)
                tok = rec.get("dedupe_token")
                if tok:
                    dedupe[tok] = rid
        elif kind == REC_TOKENS:
            entry = entries.get(rec["request_id"])
            if entry is None:
                continue
            index = int(rec.get("index", len(entry.tokens)))
            toks = [int(t) for t in rec.get("tokens", ())]
            del entry.tokens[index:]
            entry.tokens.extend(toks)
        elif kind == REC_TERMINAL:
            entry = entries.get(rec["request_id"])
            if entry is not None:
                entry.terminal = rec
        elif kind == REC_SHUTDOWN:
            clean = bool(rec.get("clean"))
        elif kind == REC_RECOVERY:
            recoveries += 1
            clean = False
        elif kind == REC_DECISION:
            decisions += 1
        if kind in (REC_SUBMIT, REC_TOKENS, REC_TERMINAL):
            clean = False  # work after a shutdown record reopens the log
    return RecoveryState(
        entries=entries,
        order=order,
        dedupe=dedupe,
        next_seq=next_seq,
        torn_records=torn,
        clean_shutdown=clean,
        recoveries=recoveries,
        decisions=decisions,
    )


def load_state(path: str) -> RecoveryState:
    """One-call journal scan + fold (missing/empty file = empty state)."""
    if not os.path.exists(path) or os.path.getsize(path) == 0:
        return replay_state([], 0)
    records, torn = read_journal(path)
    return replay_state(records, torn)
