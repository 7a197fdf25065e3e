"""The durable serving daemon: a long-lived wall-clock process around
the cluster :class:`~tpu_parallel_torch.cluster.frontend.Frontend`.

Everything below this layer runs on the injectable clock and is soaked
deterministically by the chaos/swap/autopilot harnesses; this module is
the thin shell that finally lets it SERVE — and makes accepted work
survive the process itself:

- **Write-ahead journal** (``daemon/journal.py``): every accepted
  submission is journaled and fsynced BEFORE the accept is returned;
  delivered tokens and terminal events follow with per-tick batched
  fsync.  A ``kill -9`` mid-stream followed by a restart on the same
  journal path REPLAYS the log: finished requests become idempotent
  dedupe-token responses, accepted-but-unfinished requests re-admit
  with their durable token prefix forced (the cluster's own
  forced-prefix machinery), so greedy streams continue bitwise and no
  acknowledged request is ever lost or completed twice.
- **Signal layer**: SIGTERM begins a graceful drain (in-flight work
  finishes, new submissions are refused typed ``draining``, exit 0
  within ``grace_seconds``); a second SIGTERM — or a blown grace
  window — forces a fast shutdown with the journal as the recovery
  contract for whatever was still open (exit 1).  SIGHUP re-reads
  ``reload_path`` and rolls new weights through the rolling swap path.
- **Clock discipline**: the daemon owns the ONE
  :class:`~tpu_parallel_torch.daemon.wallclock.WallClock` and injects it into
  the frontend, so per-request wall-clock deadlines ride the exact same
  deadline machinery the fake-clock tests pin.  Handing the constructor
  a fake clock instead makes the entire daemon — journal, recovery,
  drain, dedupe — a deterministic unit-test subject
  (``tests/test_torch_daemon.py`` crash-replays it in-process).

Threading: the tick pump (``run()``) and the HTTP handler threads
(``daemon/http.py``) serialize on one reentrant lock, which the pump
hands to blocked handler threads between ticks (``_FairRLock``), so a
submit or a cancel waits at most about one tick; per-request streaming
rides lock-free subscriber queues fed from inside the tick.  Device work
a handler thread starts runs on the pump's CUDA stream, and never inside
a tick, so never during a CUDA graph capture.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import queue
import signal as _signal
import threading
from collections import deque
from typing import Callable, Dict, List, Optional

import torch

from tpu_parallel_torch.daemon import iofaults
from tpu_parallel_torch.daemon.journal import (
    REC_DECISION,
    REC_RECOVERY,
    REC_SHUTDOWN,
    REC_SUBMIT,
    REC_TERMINAL,
    REC_TOKENS,
    JournalWriter,
    drop_torn_tail,
    load_state,
)
from tpu_parallel_torch.daemon.wallclock import WallClock
from tpu_parallel_torch.obs.spool import read_span_log
from tpu_parallel_torch.obs.tracer import NULL_TRACER, TraceContext
from tpu_parallel_torch.serving.request import (
    FINISHED,
    QUEUED,
    REJECTED,
    RUNNING,
    Request,
    SamplingParams,
    StreamEvent,
)

DAEMON_TRACK = "daemon"  # tracer track for signals/recovery/shutdown

# exit codes (the signal contract; docs/13_daemon.md)
EXIT_CLEAN = 0  # drained: every accepted request terminal, journal clean
EXIT_FORCED = 1  # fast shutdown: open work recovers from the journal

# typed degraded-mode rejection reasons (HTTP maps both to 503: the
# balancer should route elsewhere, the client should retry elsewhere)
REJECT_DEGRADED = "degraded"  # persistent journal failure: no new accepts
REJECT_JOURNAL = "journal_error"  # THIS accept could not be made durable


@dataclasses.dataclass(frozen=True)
class DaemonConfig:
    """Daemon shell knobs.

    - ``grace_seconds``: the SIGTERM drain window — in-flight work that
      outlives it is abandoned to the journal (fast shutdown, exit 1).
    - ``idle_sleep_seconds``: tick-pump sleep while the frontend has no
      work (busy ticks never sleep).
    - ``fsync_batch``: journal records per disk barrier (submissions and
      shutdown records always sync immediately).
    - ``reload_path``: SIGHUP reads this JSON file
      (``{"checkpoint_dir": ..., "step": ...}``) and rolls the weights
      through ``Frontend.begin_swap`` — the canary/rollback
      machinery, not a blind rebind.  None = SIGHUP is a counted no-op.
    - ``completed_retention``: terminal records (and their dedupe
      tokens) kept in memory for idempotent replies, oldest-evicted
      beyond it — the daemon's memory stays bounded at any uptime.
      The retained horizon survives compaction; beyond it only the
      in-RAM dedupe horizon ends.
    - ``compact_interval_records``: once this many records have
      appended since the last rotation, the journal COMPACTS — open
      state snapshots into a fresh segment, retired records drop, so
      restart replay reads O(open + retained) records instead of
      O(lifetime).  0 disables rotation (the unbounded-file
      behavior).
    - ``degrade_after_io_errors``: consecutive journal append/fsync
      failures before the daemon enters DEGRADED mode — new
      submissions refuse typed ``degraded`` (503), in-flight work
      drains, ``/healthz`` flips 503 with the reason, and the process
      stays up for its balancer instead of dying mid-accept.
    - ``role``: the daemon's fleet role (``prefill`` / ``decode`` /
      ``mixed`` — :mod:`tpu_parallel_torch.fleet.roles`), advertised on
      ``/healthz``.  A ``decode``-role daemon typed-refuses fresh
      client submissions (reason ``role``, 503 — a routing refusal,
      not failure evidence) and accepts only the router's handoff
      continuations; ``prefill`` and ``mixed`` accept everything
      (colocated decode is the disaggregation fallback).
    """

    grace_seconds: float = 30.0
    idle_sleep_seconds: float = 0.005
    fsync_batch: int = 32
    reload_path: Optional[str] = None
    completed_retention: int = 50_000
    compact_interval_records: int = 4096
    degrade_after_io_errors: int = 3
    role: str = "mixed"

    def __post_init__(self):
        from tpu_parallel_torch.fleet.roles import validate_role

        validate_role(self.role)
        if self.grace_seconds <= 0:
            raise ValueError(f"grace_seconds={self.grace_seconds} <= 0")
        if self.fsync_batch < 1:
            raise ValueError(f"fsync_batch={self.fsync_batch} < 1")
        if self.completed_retention < 1:
            raise ValueError(
                f"completed_retention={self.completed_retention} < 1"
            )
        if self.compact_interval_records < 0:
            raise ValueError(
                f"compact_interval_records="
                f"{self.compact_interval_records} < 0"
            )
        if self.degrade_after_io_errors < 1:
            raise ValueError(
                f"degrade_after_io_errors="
                f"{self.degrade_after_io_errors} < 1"
            )


def _submit_payload(rec: Dict) -> Dict:
    """A journaled submit record minus its per-append stamps (``seq`` /
    ``at`` / ``crc``) — the shape compaction re-journals with fresh
    stamps into the new segment."""
    return {k: v for k, v in rec.items() if k not in ("seq", "at", "crc")}


class _DaemonRequest:
    """Daemon-side state for one accepted request: the client-visible
    record, the dedupe token, journal staging, and stream subscribers."""

    __slots__ = (
        "record", "dedupe_token", "base", "staged", "staged_index",
        "terminal_staged", "subscribers", "out", "submit_rec",
    )

    def __init__(self, record: Dict, dedupe_token: Optional[str]):
        self.record = record
        self.dedupe_token = dedupe_token
        self.base = len(record["tokens"])  # durable prefix at admission
        self.staged: List[int] = []  # tokens awaiting a journal record
        self.staged_index = self.base
        self.terminal_staged = False
        self.subscribers: List[queue.Queue] = []
        self.out = None  # the live ClusterOutput (None once terminal)
        # the journaled submit PAYLOAD (no seq/at/crc) — what compaction
        # re-emits into the fresh segment so a restart can still replay
        self.submit_rec: Optional[Dict] = None


class _FairRLock:
    """The daemon lock: an ``RLock`` that counts the threads blocked on it,
    so the pump can hand it over between ticks.  With a plain lock the
    pump takes it back before a woken handler thread runs, and an HTTP
    submit waits out a whole busy stretch of ticks."""

    def __init__(self):
        self._lock = threading.RLock()
        self._turn = threading.Condition(threading.Lock())
        self._waiting = 0

    def __enter__(self):
        if not self._lock.acquire(blocking=False):
            with self._turn:
                self._waiting += 1
            try:
                self._lock.acquire()
            finally:
                with self._turn:
                    self._waiting -= 1
                    self._turn.notify_all()
        return self

    def __exit__(self, *exc) -> None:
        self._lock.release()

    def hand_over(self) -> None:
        """Return once every thread that was waiting for the lock has had
        it.  The caller must not hold it."""
        with self._turn:
            while self._waiting:
                self._turn.wait()


def _pump_streams(frontend) -> Dict:
    """The calling thread's current CUDA stream on every device the
    frontend's engines run on (empty on the CPU)."""
    streams: Dict = {}
    for handle in frontend.replicas:
        dev = getattr(handle.engine, "device", None)
        if dev is not None and dev.type == "cuda" and dev not in streams:
            streams[dev] = torch.cuda.current_stream(dev)
    return streams


class ServingDaemon:
    """The durable daemon shell (module docstring).

    ``frontend_factory(clock)`` builds the :class:`Frontend` — the
    daemon injects its clock so deadlines, SLO windows and journal
    timestamps share one time axis.  Construction RECOVERS: an existing
    journal at ``journal_path`` is scanned, finished requests become
    idempotent dedupe responses, unfinished ones re-admit with their
    durable token prefix forced.
    """

    def __init__(
        self,
        frontend_factory: Callable,
        journal_path: str,
        *,
        config: Optional[DaemonConfig] = None,
        clock=None,
        span_spool=None,
    ):
        self.config = config or DaemonConfig()
        self.clock = clock if clock is not None else WallClock()
        self.frontend = frontend_factory(self.clock)
        # device work a handler thread starts (cancel releasing a slot,
        # a KV export's copy, a peer import's writes) is queued on the
        # PUMP's stream, behind the ticks' work and never beside it; the
        # daemon lock keeps it out of a tick, and so out of a graph
        # capture, which only a tick runs.  ``run`` re-reads the streams
        # on the thread that pumps.
        self._streams = _pump_streams(self.frontend)
        self.registry = self.frontend.registry
        self.tracer = self.frontend.tracer or NULL_TRACER
        # the per-process span log behind GET /v1/tracez; drained by
        # the tick pump, under its own lock (handler threads serving
        # tracez drain too, and a spool drain does file IO)
        self.span_spool = span_spool
        self._spool_lock = threading.Lock()
        self._lock = _FairRLock()
        self._requests: Dict[str, _DaemonRequest] = {}
        self._dedupe: Dict[str, str] = {}
        # request ids with staged journal work, in first-dirty order
        self._dirty: Dict[str, None] = {}
        self._open_count = 0  # live (non-terminal) records, O(1)
        # terminal records in completion order, for bounded retention
        self._completed: deque = deque()
        self.ticks = 0
        self._draining = False
        self._drain_deadline: Optional[float] = None
        self._stopped = False
        # degraded mode: persistent journal failure flips this to a
        # typed reason — submissions refuse 503, /healthz exposes it,
        # the process stays up (docs/13_daemon.md degraded contract)
        self._degraded_reason: Optional[str] = None
        self._io_errors = 0  # consecutive journal append/fsync failures
        # signal flags — handlers only flip these (async-signal-safe);
        # the run loop acts on them
        self._drain_requested = False
        self._force_stop = False
        self._reload_requested = False
        r = self.registry
        self._m_records = r.counter("daemon_journal_records_total")
        self._m_fsyncs = r.counter("daemon_journal_fsyncs_total")
        self._m_dedupe_hits = r.counter("daemon_dedupe_hits_total")
        self._m_recovered = r.counter("daemon_recovered_requests_total")
        self._m_recovered_done = r.counter(
            "daemon_recovered_completions_total"
        )
        self._m_ticks = r.counter("daemon_ticks_total")
        self._m_accepted = r.counter("daemon_accepted_total")
        self._m_io_errors = r.counter(
            "daemon_journal_integrity_io_errors_total"
        )
        self._m_truncated = r.counter(
            "daemon_journal_integrity_truncated_bytes_total"
        )
        self._m_compactions = r.counter("daemon_journal_compactions_total")
        self._m_degraded_rejects = r.counter(
            "daemon_degraded_rejects_total"
        )
        self._m_kv_peer_exports = r.counter("daemon_kv_peer_exports_total")
        # observed swap/autopilot decisions flow through the frontend's
        # journal hook into REC_DECISION records
        self.frontend.set_journal(self._frontend_note)
        # drop a torn final record BEFORE reading: recovery must act on
        # exactly what stays durable, and appending after a fragment
        # would turn tolerable tail damage into mid-file corruption
        truncated = drop_torn_tail(journal_path)
        if truncated:
            self._m_truncated.inc(truncated)
        state = load_state(journal_path)
        self.journal = JournalWriter(
            journal_path, self.clock,
            fsync_batch=self.config.fsync_batch,
            next_seq=state.next_seq,
        )
        self.recoveries = state.recoveries
        self._recover(state)

    # -- journal plumbing --------------------------------------------------

    @contextlib.contextmanager
    def _on_pump_stream(self):
        """Run a handler thread's engine calls on the pump's streams."""
        with contextlib.ExitStack() as stack:
            for stream in self._streams.values():
                stack.enter_context(torch.cuda.stream(stream))
            yield

    def _append(self, rec: Dict) -> Dict:
        """Journal one record, with IO-failure accounting: an
        ``OSError`` (injected or real — the record is NOT in the
        journal, see ``JournalWriter.append``'s failure contract)
        counts toward the degraded-mode threshold and re-raises for the
        call site to refuse typed."""
        before = self.journal.fsyncs
        try:
            out = self.journal.append(rec)
        except OSError as exc:
            self._m_fsyncs.inc(max(0, self.journal.fsyncs - before))
            self._note_io_error(repr(exc))
            raise
        self._io_errors = 0
        self._m_records.inc()
        self._m_fsyncs.inc(self.journal.fsyncs - before)
        return out

    def _sync(self) -> None:
        try:
            if self.journal.sync():
                self._m_fsyncs.inc()
                self._io_errors = 0
        except OSError as exc:
            # the barrier failed but every record is still in the file
            # (and the OS cache): retried next tick — persistent
            # failure crosses the degraded threshold
            self._note_io_error(repr(exc))

    def _note_io_error(self, detail: str) -> None:
        """One journal IO failure: counted, and past
        ``degrade_after_io_errors`` consecutive failures (or a wedged
        writer) the daemon enters DEGRADED mode instead of dying."""
        self._io_errors += 1
        self._m_io_errors.inc()
        if self._degraded_reason is None and (
            self.journal.wedged
            or self._io_errors >= self.config.degrade_after_io_errors
        ):
            self._enter_degraded("journal_io", detail)

    def _enter_degraded(self, reason: str, detail: str) -> None:
        """Typed degraded mode: new submissions refuse 503
        (``REJECT_DEGRADED``), in-flight work drains through the
        frontend gate, ``/healthz``/``/statez`` expose the reason, and
        the process STAYS UP — a daemon that dies mid-accept strands
        its balancer; one that drains and reports lets the fleet route
        around it.  SIGTERM still drains exit 0 from here."""
        self._degraded_reason = reason
        self.registry.counter("daemon_degraded_total", reason=reason).inc()
        if self.tracer.enabled:
            self.tracer.instant(
                "degraded", track=DAEMON_TRACK, reason=reason,
                detail=detail,
            )
        try:
            # best-effort: the disk that caused this may refuse the note
            self._append({
                "record": REC_DECISION, "kind": "degraded",
                "reason": reason, "detail": detail,
            })
        except OSError:
            pass
        # close the admission gate and drain in-flight work; the pump
        # keeps ticking (and the journal keeps retrying its barrier)
        self.frontend.drain(max_ticks=0)

    @property
    def degraded_reason(self) -> Optional[str]:
        return self._degraded_reason

    def _frontend_note(self, kind: str, payload: Dict) -> None:
        """Frontend journal hook: operator-grade decisions (swap
        rollouts, autopilot actions, drain begin) become DECISION
        records.  Per-request submit/terminal hooks are ignored here —
        the daemon journals those itself with dedupe context.  Best
        effort: an audit-trail append on failing media must not turn a
        drain (or any frontend action) into a crash — the failure
        still counts toward the degraded threshold via ``_append``."""
        if kind in ("swap_begin", "autopilot_action", "drain_begin"):
            try:
                self._append(
                    {"record": REC_DECISION, "kind": kind, **payload}
                )
            except OSError:
                pass

    # -- recovery ----------------------------------------------------------

    def _recover(self, state) -> None:
        span = (
            self.tracer.span("recovery", track=DAEMON_TRACK)
            if self.tracer.enabled else None
        )
        replayed = completed = 0
        for entry in state.finished:
            rec = self._completed_record(entry)
            dr = _DaemonRequest(rec, entry.dedupe_token)
            dr.submit_rec = _submit_payload(entry.submit)
            self._register(dr)
            self._note_terminal(dr, was_open=False)
        for entry in state.unfinished:
            sub = entry.submit
            delivered = list(entry.tokens)
            remainder = int(sub["max_new_tokens"]) - len(delivered)
            eos = sub.get("eos_token_id")
            record = {
                "request_id": entry.request_id,
                "status": RUNNING if delivered else QUEUED,
                "finish_reason": None,
                "detail": None,
                "tokens": delivered,
                "recovered": True,
            }
            if remainder <= 0 or (eos is not None and eos in delivered):
                # the crash ate the terminal record but the durable
                # prefix already satisfies the stopping contract:
                # synthesize the terminal instead of re-admitting
                reason = (
                    "eos" if eos is not None and eos in delivered
                    else "length"
                )
                record["status"] = FINISHED
                record["finish_reason"] = reason
                dr = _DaemonRequest(record, entry.dedupe_token)
                dr.submit_rec = _submit_payload(sub)
                self._register(dr)
                self._note_terminal(dr, was_open=False)
                self._append({
                    "record": REC_TERMINAL,
                    "request_id": entry.request_id,
                    "status": FINISHED, "finish_reason": reason,
                    "n_tokens": len(delivered), "recovered": True,
                })
                completed += 1
                self._m_recovered_done.inc()
                continue
            dr = _DaemonRequest(record, entry.dedupe_token)
            dr.submit_rec = _submit_payload(sub)
            self._register(dr)
            req = Request(
                prompt=list(sub["prompt"]) + delivered,
                max_new_tokens=remainder,
                sampling=SamplingParams(**sub.get("sampling") or {}),
                eos_token_id=eos,
                request_id=entry.request_id,
                client_id=sub.get("client_id"),
                priority=int(sub.get("priority") or 0),
                deadline=sub.get("deadline"),
                on_token=self._make_on_token(dr),
            )
            out = self.frontend.submit(req)
            if out.status == REJECTED:
                # loud, typed loss: the journal promised this request a
                # future the restarted config no longer affords
                self._terminal_now(
                    dr, REJECTED, out.finish_reason, detail=out.detail
                )
                continue
            dr.out = out
            self._open_count += 1
            replayed += 1
            self._m_recovered.inc()
        if state.entries or state.torn_records:
            self._append({
                "record": REC_RECOVERY,
                "replayed": replayed,
                "already_complete": completed,
                "finished_in_journal": len(state.finished),
                "torn_records": state.torn_records,
            })
        self._enforce_retention()  # recovery records are all journaled
        if span is not None:
            span.finish(replayed=replayed, completed=completed)

    @staticmethod
    def _completed_record(entry) -> Dict:
        term = entry.terminal
        return {
            "request_id": entry.request_id,
            "status": term.get("status", FINISHED),
            "finish_reason": term.get("finish_reason"),
            "detail": term.get("detail"),
            "tokens": list(entry.tokens),
            "recovered": True,
        }

    def _register(self, dr: _DaemonRequest) -> None:
        self._requests[dr.record["request_id"]] = dr
        if dr.dedupe_token:
            self._dedupe[dr.dedupe_token] = dr.record["request_id"]

    def _note_terminal(self, dr: _DaemonRequest, was_open: bool) -> None:
        """Terminal bookkeeping: keep the open count O(1) and queue the
        record for retention.  Eviction itself is deferred to
        :meth:`_enforce_retention` AFTER the tick's journal flush — a
        record evicted while its terminal/tokens were still staged
        would vanish from the journal too, and a restart would replay
        (and duplicate) an already-completed request."""
        if was_open:
            self._open_count = max(0, self._open_count - 1)
        self._completed.append(dr.record["request_id"])

    def _enforce_retention(self) -> None:
        """Evict the oldest completed records past the retention bound
        (their in-RAM dedupe horizon ends; the journal keeps
        everything).  Only ever called with the journal flushed; a head
        record that somehow still has staged work stops the sweep."""
        while len(self._completed) > self.config.completed_retention:
            old = self._completed[0]
            if old in self._dirty:
                return  # staged journal work: flush must win first
            self._completed.popleft()
            gone = self._requests.get(old)
            if gone is None or gone.out is not None:
                continue  # superseded id or somehow live again: skip
            del self._requests[old]
            if gone.dedupe_token and self._dedupe.get(
                gone.dedupe_token
            ) == old:
                del self._dedupe[gone.dedupe_token]

    # -- admission ---------------------------------------------------------

    def submit(
        self, request: Request, dedupe_token: Optional[str] = None,
        phase: Optional[str] = None,
        trace: Optional[TraceContext] = None,
    ) -> Dict:
        """Accept one request: dedupe first (an already-seen token
        returns the live/completed record instead of re-admitting —
        client retries across a daemon crash are idempotent), then the
        role gate, then the frontend's typed admission gate, then the
        DURABLE accept — the submit record is fsynced before this
        returns.  ``phase="decode"`` marks a router-issued handoff
        continuation, the only submissions a ``decode``-role daemon
        takes.  ``trace`` is the wire-adopted trace context (the
        router's fork for this crossing): bound on the tracer so every
        span this daemon records for the request carries the fleet
        trace id, unbound when the request turns terminal or is
        refused."""
        from tpu_parallel_torch.fleet.roles import (
            PHASE_DECODE,
            REJECT_ROLE,
            ROLE_DECODE,
        )

        with self._lock, self._on_pump_stream():
            dedupe_token = dedupe_token or request.dedupe_token
            if dedupe_token and dedupe_token in self._dedupe:
                self._m_dedupe_hits.inc()
                # a SNAPSHOT, like result(): the live record mutates
                # under the tick while the HTTP thread serializes this
                return self.result(self._dedupe[dedupe_token])
            record = {
                "request_id": request.request_id,
                "status": QUEUED,
                "finish_reason": None,
                "detail": None,
                "tokens": [],
                "recovered": False,
            }
            if (
                self.config.role == ROLE_DECODE
                and phase != PHASE_DECODE
            ):
                # a healthy daemon refusing on ROLE is routing policy,
                # not sickness: typed 503 so the router excludes it for
                # this request without feeding the breaker
                self.registry.counter("daemon_role_rejects_total").inc()
                record["status"] = REJECTED
                record["finish_reason"] = REJECT_ROLE
                record["detail"] = (
                    "decode-role daemon takes only handoff continuations"
                )
                return record
            if self._degraded_reason is not None:
                # the durability substrate is gone: refusing typed (the
                # HTTP layer maps this to 503) beats acknowledging work
                # a dead journal cannot promise to keep
                self._m_degraded_rejects.inc()
                record["status"] = REJECTED
                record["finish_reason"] = REJECT_DEGRADED
                record["detail"] = (
                    f"daemon degraded: {self._degraded_reason}"
                )
                return record
            if trace is not None and self.tracer.enabled:
                # bind BEFORE frontend.submit so the queue span the
                # admission records already carries the fleet trace id
                self.tracer.bind_trace(request.request_id, trace)
            dr = _DaemonRequest(record, dedupe_token)
            request.on_token = self._make_on_token(dr)
            now = self.clock()
            out = self.frontend.submit(request)
            if out.status == REJECTED:
                self.tracer.release_trace(request.request_id)
                record["status"] = REJECTED
                record["finish_reason"] = out.finish_reason
                record["detail"] = out.detail
                return record  # rejections are not journaled/deduped
            dr.out = out
            sampling = request.sampling
            payload = {
                "record": REC_SUBMIT,
                "request_id": request.request_id,
                "dedupe_token": dedupe_token,
                "client_id": request.client_id,
                # trace-schema workload fields (serve_bench
                # --workload replays journals like traces)
                "arrival": round(now, 6),
                "prompt": [int(t) for t in request.prompt],
                "prompt_len": len(request.prompt),
                "prefix_group": 0,
                "priority": request.priority,
                "deadline": request.deadline,
                "max_new_tokens": request.max_new_tokens,
                "eos_token_id": request.eos_token_id,
                "sampling": {
                    "temperature": sampling.temperature,
                    "top_k": sampling.top_k,
                    "top_p": sampling.top_p,
                },
            }
            try:
                self._append(payload)
            except OSError as exc:
                # an accept we cannot make durable must not exist: the
                # frontend admission is withdrawn (so no un-journaled
                # request keeps generating and no dedupe entry vouches
                # for it) and the refusal is TYPED — the append failure
                # already counted toward the degraded threshold
                self.frontend.cancel(
                    request.request_id, reason=REJECT_JOURNAL
                )
                self.tracer.release_trace(request.request_id)
                record["status"] = REJECTED
                record["finish_reason"] = REJECT_JOURNAL
                record["detail"] = repr(exc)
                return record
            except Exception:
                self.frontend.cancel(
                    request.request_id, reason=REJECT_JOURNAL
                )
                self.tracer.release_trace(request.request_id)
                raise
            # registered only AFTER the durable append: a failed write
            # leaves no acknowledged-but-undurable state behind
            dr.submit_rec = payload
            self._register(dr)
            self._open_count += 1
            self._m_accepted.inc()
            return self.result(request.request_id)

    def cancel(self, request_id: str, reason: str = "cancelled") -> bool:
        with self._lock, self._on_pump_stream():
            return self.frontend.cancel(request_id, reason=reason)

    def result(self, request_id: str) -> Optional[Dict]:
        with self._lock:
            dr = self._requests.get(request_id)
            if dr is None:
                return None
            rec = dict(dr.record)
            rec["tokens"] = list(rec["tokens"])
            return rec

    def subscribe(self, request_id: str):
        """Stream attachment: returns ``(snapshot, q)`` — the tokens
        already delivered plus a queue of future :class:`StreamEvent`s
        (``q`` is None when the request is already terminal; the
        snapshot record tells the subscriber how it ended)."""
        with self._lock:
            dr = self._requests.get(request_id)
            if dr is None:
                return None, None
            snapshot = self.result(request_id)
            if dr.out is None:  # terminal
                return snapshot, None
            q: queue.Queue = queue.Queue()
            dr.subscribers.append(q)
            return snapshot, q

    def unsubscribe(self, request_id: str, q) -> None:
        """Detach a stream queue (the HTTP layer calls this when the
        SSE connection ends, finished or disconnected)."""
        with self._lock:
            dr = self._requests.get(request_id)
            if dr is not None and q in dr.subscribers:
                dr.subscribers.remove(q)

    # -- delivery (runs inside frontend.step under the daemon lock) --------

    def _make_on_token(self, dr: _DaemonRequest):
        def on_token(ev: StreamEvent) -> None:
            record = dr.record
            if ev.token >= 0:
                record["status"] = RUNNING
                record["tokens"].append(int(ev.token))
                dr.staged.append(int(ev.token))
            if ev.finished:
                out = dr.out
                record["status"] = (
                    out.status if out is not None else FINISHED
                )
                record["finish_reason"] = ev.finish_reason
                if out is not None:
                    record["detail"] = out.detail
                dr.terminal_staged = True
                was_open = dr.out is not None
                dr.out = None
                if record["request_id"] in self._requests:
                    self._note_terminal(dr, was_open)
                self.tracer.release_trace(record["request_id"])
            if dr.staged or dr.terminal_staged:
                self._dirty[record["request_id"]] = None
            for q in dr.subscribers:
                q.put(StreamEvent(
                    request_id=record["request_id"],
                    token=ev.token,
                    index=dr.base + ev.index if ev.index >= 0 else -1,
                    finished=ev.finished,
                    finish_reason=ev.finish_reason,
                ))
        return on_token

    def _flush_dirty(self) -> None:
        """Journal this tick's deliveries: one TOKENS record per request
        with new tokens, then its TERMINAL record when it ended — order
        within a request is what replay correctness rides on.  An IO
        failure mid-flush keeps the unflushed remainder staged (the
        failed append left nothing in the journal, so the next tick
        retries exactly the missing records — token records fold by
        index, so even an overlap would be idempotent)."""
        rids = list(self._dirty)
        self._dirty = {}
        for i, rid in enumerate(rids):
            dr = self._requests.get(rid)
            if dr is None:
                continue
            try:
                if dr.staged:
                    self._append({
                        "record": REC_TOKENS,
                        "request_id": rid,
                        "index": dr.staged_index,
                        "tokens": dr.staged,
                    })
                    dr.staged_index += len(dr.staged)
                    dr.staged = []
                if dr.terminal_staged:
                    rec = dr.record
                    self._append({
                        "record": REC_TERMINAL,
                        "request_id": rid,
                        "status": rec["status"],
                        "finish_reason": rec["finish_reason"],
                        "n_tokens": len(rec["tokens"]),
                    })
                    dr.terminal_staged = False
            except OSError:
                # this record and everything after it stays dirty; the
                # error already counted toward the degraded threshold
                for rest in rids[i:]:
                    self._dirty[rest] = None
                return

    def _terminal_now(
        self, dr: _DaemonRequest, status: str, reason: Optional[str],
        detail: Optional[str] = None,
    ) -> None:
        """Immediate journaled terminal outside the tick path (recovery
        rejections)."""
        rec = dr.record
        rec["status"] = status
        rec["finish_reason"] = reason
        rec["detail"] = detail
        was_open = dr.out is not None
        dr.out = None
        self._note_terminal(dr, was_open)
        self._append({
            "record": REC_TERMINAL,
            "request_id": rec["request_id"],
            "status": status, "finish_reason": reason,
            "n_tokens": len(rec["tokens"]),
        })

    def _compact(self) -> None:
        """Journal segment rotation: snapshot the live state (every
        retained request's submit payload, durable token prefix, and
        terminal when it has one — all record kinds replay already
        understands) into a fresh segment and retire the old one.
        Restart replay after a long uptime reads O(open + retained)
        records instead of O(lifetime).  Only called with the tick's
        journal flushed (nothing staged), so the snapshot is exactly
        the durable state."""
        snapshot: List[Dict] = []
        for rid, dr in self._requests.items():
            if dr.submit_rec is None:
                continue  # defensive: nothing replayable without it
            snapshot.append(dict(dr.submit_rec))
            toks = [int(t) for t in dr.record["tokens"]]
            if toks:
                snapshot.append({
                    "record": REC_TOKENS, "request_id": rid,
                    "index": 0, "tokens": toks,
                })
            if dr.out is None:  # terminal (finished/rejected/cancelled)
                snapshot.append({
                    "record": REC_TERMINAL, "request_id": rid,
                    "status": dr.record["status"],
                    "finish_reason": dr.record["finish_reason"],
                    "n_tokens": len(toks),
                })
        try:
            written = self.journal.rotate(snapshot)
        except OSError as exc:
            self._note_io_error(repr(exc))
            return
        self._io_errors = 0
        self._m_compactions.inc()
        self._m_records.inc(written)
        if self.tracer.enabled:
            self.tracer.instant(
                "compact", track=DAEMON_TRACK,
                snapshot_records=written, open=self._open_count,
            )

    # -- the pump ----------------------------------------------------------

    def tick(self) -> List[StreamEvent]:
        """One daemon tick: a frontend step, then the tick's journal
        batch (tokens + terminals) and ONE batched fsync window."""
        with self._lock:
            events = self.frontend.step()
            self._flush_dirty()
            self._sync()
            self._enforce_retention()
            ci = self.config.compact_interval_records
            if (
                ci
                and not self._dirty
                and self._degraded_reason is None
                and self.journal.records_since_rotate >= ci
            ):
                self._compact()
            self.ticks += 1
            self._m_ticks.inc()
            self.registry.gauge("daemon_open_requests").set(
                self._open_count
            )
            self.registry.gauge("daemon_draining").set(
                1.0 if self._draining else 0.0
            )
            self.registry.gauge("daemon_degraded").set(
                0.0 if self._degraded_reason is None else 1.0
            )
        # span IO happens OUTSIDE the daemon lock: a slow (or
        # fault-injected) spool write must not stall admission
        self._drain_spool()
        return events

    def _drain_spool(self) -> None:
        """Flush newly-recorded spans to the per-process span log.  A
        spool write failure is logged as a skip by the spool itself;
        tracing is never allowed to take the daemon down."""
        if self.span_spool is None:
            return
        with self._spool_lock:
            try:
                self.span_spool.drain(self.tracer)
            except OSError:
                pass

    def trace_payload(self, trace_id: Optional[str] = None) -> Dict:
        """The ``GET /v1/tracez`` body: this process's spooled span
        records (optionally filtered to one trace), plus the damage
        counters ``read_span_log`` kept while skipping bad lines."""
        if self.span_spool is None:
            return {
                "proc": f"daemon:{self.config.role or 'serve'}",
                "pid": os.getpid(),
                "records": [],
                "skipped": {},
            }
        with self._spool_lock:
            try:
                self.span_spool.drain(self.tracer)
            except OSError:
                pass
            records, skipped = read_span_log(
                self.span_spool.path, trace_id=trace_id
            )
        return {
            "proc": f"daemon:{self.config.role or 'serve'}",
            "pid": os.getpid(),
            "records": records,
            "skipped": skipped,
        }

    def install_signals(self) -> None:
        """Wire the POSIX contract (main thread only): SIGTERM/SIGINT =
        graceful drain, repeated = force fast shutdown, SIGHUP = weight
        reload through the swap path.  Handlers only set flags."""
        _signal.signal(_signal.SIGTERM, self._on_term)
        _signal.signal(_signal.SIGINT, self._on_term)
        if hasattr(_signal, "SIGHUP"):
            _signal.signal(_signal.SIGHUP, self._on_hup)

    def _on_term(self, signum, frame) -> None:
        if self._drain_requested:
            self._force_stop = True
        else:
            self._drain_requested = True

    def _on_hup(self, signum, frame) -> None:
        self._reload_requested = True

    def request_drain(self) -> None:
        """Programmatic SIGTERM equivalent (tests, embedders)."""
        self._on_term(None, None)

    def request_reload(self) -> None:
        self._reload_requested = True

    def _begin_drain(self) -> None:
        self._draining = True
        self._drain_deadline = self.clock() + self.config.grace_seconds
        self.registry.counter(
            "daemon_signals_total", signal="term"
        ).inc()
        with self._lock:
            if self.tracer.enabled:
                self.tracer.instant(
                    "drain_begin", track=DAEMON_TRACK,
                    open=self._open_count,
                )
            # close the gate, gate every engine, pull queued work back —
            # then keep pumping ticks under the grace window
            self.frontend.drain(max_ticks=0)

    def _do_reload(self) -> None:
        self._reload_requested = False
        self.registry.counter("daemon_signals_total", signal="hup").inc()
        path = self.config.reload_path

        def decide(verdict, **extra):
            # under the lock: HTTP submit threads append concurrently.
            # Best effort — a reload verdict on failing media must not
            # kill the pump (the failure still counts via _append).
            with self._lock:
                try:
                    self._append({
                        "record": REC_DECISION, "kind": "reload",
                        "verdict": verdict, **extra,
                    })
                except OSError:
                    pass

        if path is None:
            return decide("no_reload_path")
        import json as _json
        try:
            with iofaults.open_file(path, encoding="utf-8") as fh:
                spec = _json.load(fh)
        except (OSError, ValueError) as exc:
            return decide("unreadable", detail=repr(exc))
        if not spec.get("checkpoint_dir"):
            return decide("no_checkpoint_dir")
        with self._lock:
            status = self.frontend.begin_swap(
                checkpoint_dir=spec["checkpoint_dir"],
                step=spec.get("step"),
                version=spec.get("version"),
            )
            try:
                self._append({
                    "record": REC_DECISION, "kind": "reload",
                    "verdict": (
                        status.get("verdict") or status.get("state")
                    ),
                })
            except OSError:
                pass

    def _shutdown(self, clean: bool) -> int:
        with self._lock:
            self._stopped = True
            open_req = self._open_count
            # a degraded (dead-disk) exit must still honor the signal
            # contract: the exit CODE is the promise, the shutdown
            # record is best-effort on media that may refuse it
            self._flush_dirty()
            try:
                self._append({
                    "record": REC_SHUTDOWN, "clean": clean,
                    "open_requests": open_req,
                })
                self.journal.close()
            except OSError:
                pass
        if self.tracer.enabled:
            self.tracer.instant(
                "shutdown", track=DAEMON_TRACK, clean=clean,
                open=open_req,
            )
        return EXIT_CLEAN if clean else EXIT_FORCED

    def run(self, max_ticks: Optional[int] = None) -> int:
        """The pump: tick until shut down.  Returns the process exit
        code — 0 for a clean drained exit, 1 for a forced fast shutdown
        (open work waits in the journal for the next recovery)."""
        ticks = 0
        while max_ticks is None or ticks < max_ticks:
            if self._force_stop:
                self.registry.counter(
                    "daemon_signals_total", signal="term_force"
                ).inc()
                return self._shutdown(clean=not self.frontend.has_work())
            if self._reload_requested:
                self._do_reload()
            if self._drain_requested and not self._draining:
                self._begin_drain()
            # handler threads blocked on the lock get it before the next
            # tick, so a submit or cancel waits at most one tick
            self._lock.hand_over()
            self.tick()
            ticks += 1
            if self._draining:
                if not self.frontend.has_work():
                    return self._shutdown(clean=True)
                if self.clock() > self._drain_deadline:
                    # grace blown: abandon the remainder to the journal
                    return self._shutdown(clean=False)
            elif not self.frontend.has_work():
                self.clock.sleep(self.config.idle_sleep_seconds)
        return EXIT_FORCED  # max_ticks exhausted with the daemon still up

    # -- peer KV exchange (fleet) ------------------------------------------

    def export_hot_kv(self, max_blocks: int = 16) -> List:
        """Snapshot the hottest radix-cached prefixes from the first
        live replica that pages any, for shipment to a fleet peer
        (warm-start on join/restart, drain-forward on leave — see
        ``fleet/router.py`` and docs/14_fleet.md).  Returns a list of
        :class:`~tpu_parallel_torch.serving.kv_hierarchy.KVPrefixExport`;
        empty when no replica runs a radix cache or nothing is hot."""
        from tpu_parallel_torch.cluster.replica import DEAD as _REPLICA_DEAD

        with self._lock, self._on_pump_stream():
            if self._stopped:
                return []
            for handle in self.frontend.replicas:
                if handle.health == _REPLICA_DEAD:
                    continue
                exporter = getattr(
                    handle.engine, "export_hot_prefixes", None
                )
                if exporter is None:
                    continue
                exports = exporter(max_blocks=max_blocks)
                if exports:
                    self._m_kv_peer_exports.inc(len(exports))
                    return list(exports)
            return []

    def export_request_kv(self, request_id: str) -> List:
        """Export ONE live request's written KV prefix — the donor half
        of the prefill→decode disaggregation handoff: the router calls
        this on the prefill daemon at first-token time and ships the
        blocks to the chosen decode peer, so the forced-prefix
        continuation admits against a warm radix tree instead of
        re-prefilling.  Empty when the request is unknown, not paged,
        or has less than one full block written — the router's typed
        fallback (colocated decode) covers every empty answer."""
        with self._lock, self._on_pump_stream():
            if self._stopped:
                return []
            dr = self._requests.get(request_id)
            if dr is None or dr.out is None:
                return []
            export = self.frontend.export_request_kv(request_id)
            if export is None:
                return []
            self._m_kv_peer_exports.inc()
            return [export]

    def kv_occupancy(self) -> Dict[str, float]:
        """Device/host KV-tier block occupancy summed over live
        replicas — carried on ``/healthz`` so the fleet router's
        placement and the autopilot's role lever see pressure, not just
        liveness."""
        from tpu_parallel_torch.cluster.replica import DEAD as _REPLICA_DEAD

        with self._lock:
            device_used = device_total = host_used = 0
            disk_used = disk_total = seeded_chains = 0
            disk_restores = disk_restore_failures = 0
            manifest_age = None
            for handle in self.frontend.replicas:
                if handle.health == _REPLICA_DEAD:
                    continue
                pool = getattr(handle.engine, "pool", None)
                alloc = getattr(pool, "allocator", None)
                if alloc is not None:
                    device_total += int(alloc.n_blocks)
                    device_used += int(alloc.n_blocks) - int(alloc.n_free)
                radix = getattr(handle.engine, "_radix", None)
                if radix is not None:
                    host_used += int(
                        getattr(radix, "host_blocks_in_use", 0)
                    )
                    store = getattr(radix, "disk", None)
                    if store is not None:
                        disk_used += int(store.blocks_in_use)
                        disk_total += int(store.capacity_blocks)
                        seeded_chains += int(
                            getattr(radix, "disk_seeded_chains", 0)
                        )
                        disk_restores += int(
                            getattr(radix, "disk_restores", 0)
                        )
                        disk_restore_failures += int(
                            getattr(radix, "disk_restore_failures", 0)
                        )
                        age = float(store.manifest_age_seconds())
                        if manifest_age is None or age > manifest_age:
                            manifest_age = age
            occ = {
                "device_blocks_used": device_used,
                "device_blocks_total": device_total,
                "host_blocks_used": host_used,
            }
            # disk-tier rows only when an SSD tier is attached — old
            # routers .get() these, new ones see the fraction + the
            # manifest's staleness in one probe
            if disk_total:
                occ["disk_blocks_used"] = disk_used
                occ["disk_blocks_total"] = disk_total
                occ["disk_seeded_chains"] = seeded_chains
                occ["disk_restores"] = disk_restores
                occ["disk_restore_failures"] = disk_restore_failures
                occ["manifest_age_seconds"] = round(
                    manifest_age or 0.0, 3
                )
            return occ

    def import_peer_kv(self, exports) -> Dict[str, int]:
        """Land already-decoded peer exports into every live replica's
        prefix cache, inheriting the migration layer's verify-or-refuse
        contract — corrupt or incompatible blocks land as typed refusal
        verdicts, never as served bytes.  Returns verdict counts
        (``imported`` / ``integrity`` / ``weights_version`` / ...)."""
        from tpu_parallel_torch.cluster.migration import land_exports
        from tpu_parallel_torch.cluster.replica import DEAD as _REPLICA_DEAD

        with self._lock, self._on_pump_stream():
            counts: Dict[str, int] = {}
            for handle in self.frontend.replicas:
                if handle.health == _REPLICA_DEAD:
                    continue
                for verdict, n in land_exports(
                    handle.engine, exports
                ).items():
                    counts[verdict] = counts.get(verdict, 0) + n
            for verdict, n in counts.items():
                self.registry.counter(
                    "daemon_kv_peer_imports_total", status=verdict
                ).inc(n)
            return counts

    # -- introspection -----------------------------------------------------

    @property
    def role(self) -> str:
        """This daemon's fleet role (``prefill``/``decode``/``mixed``) —
        fixed at config time, advertised on ``/healthz``."""
        return self.config.role

    def status(self) -> Dict:
        with self._lock:
            open_req = self._open_count
            return {
                "role": self.config.role,
                "draining": self._draining,
                "stopped": self._stopped,
                "degraded_reason": self._degraded_reason,
                "ticks": self.ticks,
                "open_requests": open_req,
                "requests": len(self._requests),
                "recoveries": self.recoveries,
                "journal": {
                    "path": self.journal.path,
                    "records": self.journal.records,
                    "fsyncs": self.journal.fsyncs,
                    "next_seq": self.journal.next_seq,
                    "rotations": self.journal.rotations,
                    "io_errors": int(self._m_io_errors.value),
                    "wedged": self.journal.wedged,
                },
            }
