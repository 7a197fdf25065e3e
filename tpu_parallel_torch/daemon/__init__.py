"""Durable serving daemon: the long-lived wall-clock process around the
cluster frontend (docs/13_daemon.md), copied from ``tpu_parallel/daemon``
(plain Python) and bound to the port's :class:`Frontend`.

``daemon/journal.py`` is the write-ahead request journal (append-only
JSONL, sequence numbers, batched fsync) and its crash-recovery replay;
``daemon/daemon.py`` is the shell — recovery, dedupe-token idempotence,
the SIGTERM/SIGHUP signal contract and the tick pump; ``daemon/http.py``
is the stdlib HTTP + SSE network face; ``daemon/wallclock.py`` is the
ONE place in the serving stack allowed to read real time;
``daemon/serve.py`` is the serving process (``python -m
tpu_parallel_torch.daemon.serve --serve ...``) and its three fast gates.
"""

from tpu_parallel_torch.daemon.daemon import (
    DAEMON_TRACK,
    EXIT_CLEAN,
    EXIT_FORCED,
    REJECT_DEGRADED,
    REJECT_JOURNAL,
    DaemonConfig,
    ServingDaemon,
)
from tpu_parallel_torch.daemon.http import DaemonHTTPServer, build_request
from tpu_parallel_torch.daemon.iofaults import (
    IOFaultInjector,
    IOFaultPlan,
)
from tpu_parallel_torch.daemon.journal import (
    CORRUPT_CRC,
    CORRUPT_GARBAGE,
    CORRUPT_SEQ,
    JOURNAL_VERSION,
    REC_DECISION,
    REC_META,
    REC_RECOVERY,
    REC_SHUTDOWN,
    REC_SUBMIT,
    REC_TERMINAL,
    REC_TOKENS,
    JournalCorrupt,
    JournalEntry,
    JournalWriter,
    RecoveryState,
    drop_torn_tail,
    encode_record,
    load_state,
    read_journal,
    record_crc_ok,
    replay_state,
)
from tpu_parallel_torch.daemon.wallclock import WallClock

__all__ = [
    "CORRUPT_CRC",
    "CORRUPT_GARBAGE",
    "CORRUPT_SEQ",
    "DAEMON_TRACK",
    "EXIT_CLEAN",
    "EXIT_FORCED",
    "DaemonConfig",
    "DaemonHTTPServer",
    "IOFaultInjector",
    "IOFaultPlan",
    "JOURNAL_VERSION",
    "JournalCorrupt",
    "JournalEntry",
    "JournalWriter",
    "REC_DECISION",
    "REC_META",
    "REC_RECOVERY",
    "REC_SHUTDOWN",
    "REC_SUBMIT",
    "REC_TERMINAL",
    "REC_TOKENS",
    "REJECT_DEGRADED",
    "REJECT_JOURNAL",
    "RecoveryState",
    "ServingDaemon",
    "WallClock",
    "build_request",
    "drop_torn_tail",
    "encode_record",
    "load_state",
    "read_journal",
    "record_crc_ok",
    "replay_state",
]
