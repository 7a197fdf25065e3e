"""Seeded, injectable IO fault shim: the ONE door every durability-
critical file operation walks through.  A copy of
``tpu_parallel/daemon/iofaults.py`` (plain Python); in the port its
gated callers are the journal and the disk KV tier (``serving/kv_disk.py``).

The daemon's journal (``daemon/journal.py``) and the serving weight-set
unit (``checkpoint/io.py``) both promise things about what survives a
crash — but both trusted their media completely: an ``fsync`` that
returns ``EIO``, an append that hits ``ENOSPC`` halfway through a
record, a short write, or a flipped bit under a record's bytes were all
invisible until JSON parsing happened to fail.  This module makes those
failures INJECTABLE and DETERMINISTIC, in the style of the JAX package's
cluster ``FaultPlan``:

- :class:`IOFaultPlan` is a frozen schedule keyed on per-kind operation
  counters (the Nth write, the Nth fsync, the Nth read) — a pure
  function of a seed via :meth:`IOFaultPlan.from_seed`, so a disk-fault
  storm replays EXACTLY.
- :class:`IOFaultInjector` holds the mutable counters and injects:
  - **EIO on fsync** (``fsync_eio_at`` + ``fsync_eio_count``): the
    barrier the durability contract leans on reports failure — once, or
    persistently (the dead-disk shape the daemon's degraded mode
    exists for).
  - **ENOSPC mid-append** (``enospc_at_write``): a prefix of the record
    reaches the file, then the write raises — the torn-tail-plus-error
    shape of a full disk.
  - **short write** (``short_write_at``): a prefix lands and the write
    raises ``EIO`` — same torn tail, different errno.
  - **read-side bit flip** (``flip_read_at`` + ``flip_read_bit``): one
    bit of a read payload is XORed — the media-rot shape the journal's
    per-record CRC exists to catch.
- The module-level wrappers (:func:`open_file`, :func:`write_line`,
  :func:`fsync_file`, :func:`read_text`) are what the gated modules
  call INSTEAD of raw ``open`` / ``os.fsync`` / file writes.  With no injector installed they are exactly the
  raw operations — zero overhead, zero behavior change.

Faults fire on the injector installed via :func:`install` (or the
:func:`inject` context manager) — typically once per process at daemon
start or around one test block.  Nothing here reads a clock or a global RNG: every fault is a
pure function of (plan, operation index).
"""

from __future__ import annotations

import contextlib
import dataclasses
import errno
import os
import random
from typing import Optional

# the fault kinds from_seed can draw (subset via ``kinds=``)
FAULT_KINDS = ("fsync_eio", "enospc", "short_write", "bit_flip")

# "persistent" fsync failure: every fsync from the trigger on fails —
# the dead-disk / revoked-mount shape (any count >= the process's
# remaining fsyncs behaves identically)
PERSISTENT = 1 << 30


@dataclasses.dataclass(frozen=True)
class IOFaultPlan:
    """Deterministic IO fault schedule keyed on per-kind op counters.

    - ``fsync_eio_at``: the fsync index (0-based, counted per injector)
      at which ``fsync_file`` starts raising ``OSError(EIO)``;
      ``fsync_eio_count`` consecutive fsyncs fail (``PERSISTENT`` =
      every one from then on — the degraded-mode trigger).
    - ``enospc_at_write``: the write index at which ``write_line``
      writes a partial prefix then raises ``OSError(ENOSPC)``.
    - ``short_write_at``: the write index at which ``write_line``
      writes a partial prefix then raises ``OSError(EIO)``.
    - ``flip_read_at``: the read index at which ``read_text`` XORs one
      bit (``flip_read_bit``, taken modulo the payload size) into the
      returned bytes — the reader sees silently corrupted media.
    """

    fsync_eio_at: Optional[int] = None
    fsync_eio_count: int = 1
    enospc_at_write: Optional[int] = None
    short_write_at: Optional[int] = None
    flip_read_at: Optional[int] = None
    flip_read_bit: int = 0

    @classmethod
    def from_seed(
        cls,
        rnd: "random.Random",
        ops: int = 48,
        kinds: Optional[tuple] = None,
    ) -> "IOFaultPlan":
        """Draw a randomized-but-reproducible schedule over an ``ops``
        operation horizon.  ``kinds`` pins which fault shapes appear
        (subset of ``FAULT_KINDS``); None draws a random non-empty
        subset.  Same rng state + ops + kinds => identical plan, same
        as :meth:`FaultPlan.from_seed` on the cluster side."""
        if ops < 4:
            raise ValueError(f"ops={ops} < 4: no room for a schedule")
        if kinds is None:
            kinds = tuple(k for k in FAULT_KINDS if rnd.random() < 0.5)
            if not kinds:
                kinds = (rnd.choice(FAULT_KINDS),)
        unknown = set(kinds) - set(FAULT_KINDS)
        if unknown:
            raise ValueError(f"unknown IO fault kinds {sorted(unknown)}")
        kw: dict = {}
        if "fsync_eio" in kinds:
            kw["fsync_eio_at"] = rnd.randrange(1, ops)
            kw["fsync_eio_count"] = (
                PERSISTENT if rnd.random() < 0.5 else rnd.randrange(1, 4)
            )
        if "enospc" in kinds:
            kw["enospc_at_write"] = rnd.randrange(2, ops)
        if "short_write" in kinds:
            kw["short_write_at"] = rnd.randrange(2, ops)
        if "bit_flip" in kinds:
            kw["flip_read_at"] = rnd.randrange(0, 4)
            kw["flip_read_bit"] = rnd.randrange(0, 1 << 16)
        return cls(**kw)


class IOFaultInjector:
    """Mutable op counters + injected-fault tallies over one
    :class:`IOFaultPlan`.  The counters make every fault a pure function
    of the operation SEQUENCE, not of time or chance."""

    def __init__(self, plan: IOFaultPlan):
        self.plan = plan
        self.writes = 0
        self.fsyncs = 0
        self.reads = 0
        self.injected = {kind: 0 for kind in FAULT_KINDS}

    # -- the three op gates -------------------------------------------------

    def on_write(self, fh, data: str) -> bool:
        """Consulted by :func:`write_line` BEFORE the raw write.  May
        write a torn prefix and raise; returns False when the caller
        should proceed with the raw write."""
        i = self.writes
        self.writes += 1
        plan = self.plan
        if plan.short_write_at is not None and i == plan.short_write_at:
            self.injected["short_write"] += 1
            fh.write(data[: max(1, len(data) // 2)])
            fh.flush()
            raise OSError(errno.EIO, "injected short write (torn record)")
        if plan.enospc_at_write is not None and i == plan.enospc_at_write:
            self.injected["enospc"] += 1
            fh.write(data[: max(1, len(data) // 3)])
            fh.flush()
            raise OSError(
                errno.ENOSPC, "injected ENOSPC mid-append (disk full)"
            )
        return False

    def on_fsync(self) -> None:
        i = self.fsyncs
        self.fsyncs += 1
        plan = self.plan
        if plan.fsync_eio_at is not None and (
            plan.fsync_eio_at <= i < plan.fsync_eio_at + plan.fsync_eio_count
        ):
            self.injected["fsync_eio"] += 1
            raise OSError(
                errno.EIO, "injected fsync EIO (durability barrier failed)"
            )

    def on_read(self, payload: bytes) -> bytes:
        i = self.reads
        self.reads += 1
        plan = self.plan
        if (
            plan.flip_read_at is not None
            and i == plan.flip_read_at
            and payload
        ):
            self.injected["bit_flip"] += 1
            bit = plan.flip_read_bit % (len(payload) * 8)
            flipped = bytearray(payload)
            flipped[bit // 8] ^= 1 << (bit % 8)
            return bytes(flipped)
        return payload


_ACTIVE: Optional[IOFaultInjector] = None


def install(plan: IOFaultPlan) -> IOFaultInjector:
    """Arm ``plan`` process-wide (one injector at a time); returns the
    injector so callers can read its tallies."""
    global _ACTIVE
    _ACTIVE = IOFaultInjector(plan)
    return _ACTIVE


def deactivate() -> None:
    global _ACTIVE
    _ACTIVE = None


def active() -> Optional[IOFaultInjector]:
    return _ACTIVE


@contextlib.contextmanager
def inject(plan: IOFaultPlan):
    """Scoped installation for tests: the injector is live inside the
    block and removed after, whatever happens."""
    inj = install(plan)
    try:
        yield inj
    finally:
        deactivate()


# -- the sanctioned file operations ------------------------------------------
#
# These are deliberately thin: with no injector installed each is exactly
# its raw counterpart.  Durability-critical IO goes through them so it
# cannot silently bypass the shim (and with it, the fault soak's coverage).


def open_file(path: str, mode: str = "r", **kwargs):
    """The shim's ``open`` — every journal/manifest handle is minted
    here so fault-injected handles and real ones are the same object
    kind."""
    return open(path, mode, **kwargs)  # raw-io: the shim IS the door


def write_line(fh, data: str) -> None:
    """Write ``data`` (one record line) to ``fh``, consulting the
    active injector first — a torn prefix plus a typed ``OSError`` is
    the injected-failure shape."""
    inj = _ACTIVE
    if inj is not None and inj.on_write(fh, data):
        return
    fh.write(data)


def fsync_file(fh) -> None:
    """The disk barrier, injectable: ``OSError(EIO)`` per the active
    plan, else ``os.fsync``."""
    inj = _ACTIVE
    if inj is not None:
        inj.on_fsync()
    os.fsync(fh.fileno())  # raw-io: the shim IS the door


def read_bytes(path: str) -> bytes:
    """Read a whole file as bytes through the injector's read gate: the
    active plan may XOR one bit into the payload.  The binary sibling of
    :func:`read_text` — KV wire blobs (``serving/kv_wire.py``) come off
    disk through here so the fault soak's rot leg covers them too."""
    with open_file(path, "rb") as fh:
        payload = fh.read()
    inj = _ACTIVE
    if inj is not None:
        payload = inj.on_read(payload)
    return payload


def read_text(path: str) -> str:
    """Read a whole text file through the injector's read gate: the
    active plan may XOR one bit into the payload (decoded with
    ``errors="replace"`` so a flip inside a multi-byte sequence still
    yields a string — and a CRC mismatch — instead of an exception)."""
    return read_bytes(path).decode("utf-8", errors="replace")
