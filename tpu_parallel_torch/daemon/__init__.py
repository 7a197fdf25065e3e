"""The durability pieces of ``tpu_parallel/daemon``, copied (both are plain
Python): ``iofaults.py``, the seeded IO fault shim every durability-critical
file operation walks through, and ``journal.py``, the CRC'd append-only
JSONL journal.  The disk KV tier (``serving/kv_disk.py``) keeps its manifest
in that journal.  The daemon itself, its HTTP face and its wall clock are
not in the port yet.
"""

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

__all__ = [
    "CORRUPT_CRC",
    "CORRUPT_GARBAGE",
    "CORRUPT_SEQ",
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
    "RecoveryState",
    "drop_torn_tail",
    "encode_record",
    "load_state",
    "read_journal",
    "record_crc_ok",
    "replay_state",
]
