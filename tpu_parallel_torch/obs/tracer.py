"""Request-lifecycle span tracer.

Records WHAT happened WHEN as named spans on named tracks: the serving
engine opens one track per cache slot plus a ``scheduler`` track, the
trainer a ``trainer`` track, and ``obs/exporters.py`` lays
the spans out as a Chrome trace-event file Perfetto opens directly — one
request's life reads left to right as
``queue -> prefill[chunk i] -> decode/verify... -> finish``.

Two span shapes:

- **Complete spans** (the default): a ``[start, end]`` interval on one
  track.  Spans on a track must be sequential or properly nested (the
  Chrome ``X`` event contract); everything the engine emits per tick is.
- **Async spans** (``start_async``): intervals that legitimately overlap
  others on their track — queue-wait spans of concurrently queued
  requests.  Exported as Chrome ``b``/``e`` nestable-async pairs, which
  Perfetto renders on per-id sub-rows instead of corrupting the track.

Each span also carries an IDENTITY —
``span_id`` / ``parent_id`` / ``trace_id`` — so spans emitted by
different PROCESSES (router, prefill daemon, decode daemon) can be
stitched back into one tree per request.  The wire carries a
:class:`TraceContext` (trace id + the parent span id for anything the
receiver emits) in the ``X-TP-Trace`` header; inside a process the
tracer stamps it onto spans by request id via :meth:`Tracer.bind_trace`
— the engine and frontend already attribute every span/instant with
``request_id=`` (or the router's ``rid=``), so they need no API change
to participate.

Timestamps come from an injectable monotonic ``clock`` so lifecycle tests
run on a fake clock, deterministically.

**Disabled tracing is near-zero cost**: the module-level :data:`NULL_TRACER`
(the engine/trainer default) returns one shared no-op span from every
call — no timestamp read, no allocation, no list append.  Hot loops that
would even BUILD attribute dicts per token guard on ``tracer.enabled``.
The trace-binding surface keeps that contract: ``bind_trace`` /
``release_trace`` on the null tracer are no-ops, and an enabled tracer
with ZERO bindings pays one falsy dict check per span.
"""

from __future__ import annotations

import itertools
import time
import uuid
from typing import Callable, Dict, List, Optional

TRACE_HEADER = "X-TP-Trace"

_TRACE_ID_LEN = 32  # 128-bit trace id, lowercase hex
_SPAN_ID_LEN = 16  # 64-bit span id, lowercase hex
_HEX = set("0123456789abcdef")


class TraceContext:
    """The portable identity of one request's trace: a 128-bit trace id
    plus the span id every span the HOLDER emits should parent to.

    Crossing a process boundary, :meth:`fork` mints a child context (same
    trace, fresh parent span id) whose id the SENDER assigns to its wire
    span — so the receiver's spans hang off the wire crossing, and the
    stitched tree keeps its depth.  On the wire it travels as the
    ``X-TP-Trace`` header, ``<trace32hex>-<span16hex>``.
    """

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: str):
        self.trace_id = trace_id
        self.span_id = span_id

    @classmethod
    def new(cls) -> "TraceContext":
        return cls(uuid.uuid4().hex, uuid.uuid4().hex[:_SPAN_ID_LEN])

    def fork(self) -> "TraceContext":
        """Same trace, fresh parent span id (a child boundary)."""
        return TraceContext(
            self.trace_id, uuid.uuid4().hex[:_SPAN_ID_LEN]
        )

    def header_value(self) -> str:
        return f"{self.trace_id}-{self.span_id}"

    @classmethod
    def parse(cls, value: Optional[str]) -> Optional["TraceContext"]:
        """The inbound-header gate: a well-formed ``<trace>-<span>``
        pair or None — garbage from a client never becomes identity."""
        if not value or not isinstance(value, str):
            return None
        trace_id, sep, span_id = value.strip().partition("-")
        if not sep:
            return None
        if len(trace_id) != _TRACE_ID_LEN or len(span_id) != _SPAN_ID_LEN:
            return None
        if not (_HEX >= set(trace_id) and _HEX >= set(span_id)):
            return None
        return cls(trace_id, span_id)

    def __repr__(self) -> str:
        return f"TraceContext({self.trace_id!r}, {self.span_id!r})"


class Span:
    """One named interval on a track.  Usable as a context manager for
    lexically-scoped work, or held across ticks and closed with
    :meth:`finish` (the engine's queue-wait spans live for many ticks)."""

    __slots__ = ("name", "track", "start", "end", "attrs", "async_id",
                 "span_id", "parent_id", "trace_id", "_tracer")

    def __init__(self, tracer: "Tracer", name: str, track: str,
                 attrs: Dict[str, object], start: float,
                 async_id: Optional[str] = None):
        self._tracer = tracer
        self.name = name
        self.track = track
        self.attrs = attrs
        self.start = start
        self.end: Optional[float] = None
        self.async_id = async_id
        self.span_id: Optional[str] = None
        self.parent_id: Optional[str] = None
        self.trace_id: Optional[str] = None

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def finish(self, **attrs) -> "Span":
        if attrs:
            self.attrs.update(attrs)
        if self.end is None:
            self.end = self._tracer.now()
        return self

    def to_dict(self) -> Dict[str, object]:
        """The span-log record body (see the JAX package's ``obs/spool.py``)."""
        rec: Dict[str, object] = {
            "name": self.name,
            "track": self.track,
            "start": self.start,
            "end": self.end,
            "attrs": dict(self.attrs),
        }
        if self.async_id is not None:
            rec["async_id"] = self.async_id
        if self.trace_id is not None:
            rec["trace_id"] = self.trace_id
            rec["span_id"] = self.span_id
            rec["parent_id"] = self.parent_id
        return rec

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> None:
        self.finish()


class _NullSpan:
    """The shared do-nothing span: every NullTracer call returns THIS
    object, so a disabled tracer allocates nothing per call."""

    __slots__ = ()

    def set(self, **attrs) -> "_NullSpan":
        return self

    def finish(self, **attrs) -> "_NullSpan":
        return self

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


NULL_SPAN = _NullSpan()


class Tracer:
    """Append-only span/instant recorder.

    ``span``/``start`` open a complete span (``span`` reads better under
    ``with``; they are the same call), ``start_async`` an overlap-safe
    async span, ``record`` retro-records an interval measured by the
    caller (the engine's batched prefill fans one device call out into
    per-slot spans sharing the measured window), ``instant`` drops a
    zero-duration marker.

    **Trace binding**: ``bind_trace(request_id, ctx)`` makes every
    subsequent span/instant whose attrs carry that ``request_id`` (or
    ``rid``) a child of ``ctx`` — stamped with the trace id, a fresh
    span id, and ``ctx.span_id`` as parent — until ``release_trace``.
    The lookup costs one falsy dict check when nothing is bound.
    """

    enabled = True

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self.clock = clock
        self.spans: List[Span] = []
        self.instants: List[Dict] = []
        self._bindings: Dict[str, TraceContext] = {}
        # per-tracer span-id mint: a process nonce + a counter keeps ids
        # unique across the fleet without a uuid4 per span
        self._span_nonce = uuid.uuid4().hex[:8]
        self._span_seq = itertools.count()

    def now(self) -> float:
        return self.clock()

    def next_span_id(self) -> str:
        return f"{self._span_nonce}{next(self._span_seq):08x}"

    # -- trace binding ----------------------------------------------------

    def bind_trace(self, request_id: str, ctx: TraceContext) -> None:
        self._bindings[request_id] = ctx

    def release_trace(self, request_id: str) -> None:
        self._bindings.pop(request_id, None)

    def trace_of(self, request_id: str) -> Optional[TraceContext]:
        return self._bindings.get(request_id)

    def _stamp(self, span: Span) -> Span:
        if self._bindings:
            key = span.attrs.get("request_id") or span.attrs.get("rid")
            ctx = self._bindings.get(key) if key is not None else None
            if ctx is not None:
                span.trace_id = ctx.trace_id
                span.parent_id = ctx.span_id
                span.span_id = self.next_span_id()
        return span

    # -- recording --------------------------------------------------------

    def start(self, name: str, track: str = "main", **attrs) -> Span:
        span = Span(self, name, track, attrs, self.clock())
        self._stamp(span)
        self.spans.append(span)
        return span

    span = start

    def start_async(self, name: str, track: str, async_id: str,
                    **attrs) -> Span:
        span = Span(self, name, track, attrs, self.clock(),
                    async_id=async_id)
        self._stamp(span)
        self.spans.append(span)
        return span

    def record(self, name: str, track: str, start: float, end: float,
               **attrs) -> Span:
        span = Span(self, name, track, attrs, start)
        span.end = end
        self._stamp(span)
        self.spans.append(span)
        return span

    def instant(self, name: str, track: str = "main", **attrs) -> None:
        ev = {"name": name, "track": track, "ts": self.clock(),
              "attrs": attrs}
        if self._bindings:
            key = attrs.get("request_id") or attrs.get("rid")
            ctx = self._bindings.get(key) if key is not None else None
            if ctx is not None:
                ev["trace_id"] = ctx.trace_id
                ev["parent_id"] = ctx.span_id
        self.instants.append(ev)

    def tracks(self) -> List[str]:
        """Every track touched, ``scheduler`` and ``trainer`` first, the
        rest natural-sorted (``slot 2`` before ``slot 10``) — the
        exporter's row order."""
        seen = {s.track for s in self.spans}
        seen.update(ev["track"] for ev in self.instants)
        head = [t for t in ("scheduler", "trainer") if t in seen]

        def natural(track: str):
            prefix, _, tail = track.rpartition(" ")
            if tail.isdigit():
                return (prefix, int(tail))
            return (track, -1)

        return head + sorted(seen - set(head), key=natural)


class NullTracer:
    """The disabled tracer: same surface as :class:`Tracer`, no clock
    reads, no storage.  ``enabled`` is False so hot loops can skip even
    building the attribute dicts."""

    enabled = False

    def now(self) -> float:
        return 0.0

    def next_span_id(self) -> str:
        return ""

    def bind_trace(self, request_id: str, ctx: TraceContext) -> None:
        pass

    def release_trace(self, request_id: str) -> None:
        pass

    def trace_of(self, request_id: str) -> None:
        return None

    def start(self, name: str, track: str = "main", **attrs) -> _NullSpan:
        return NULL_SPAN

    span = start

    def start_async(self, name: str, track: str, async_id: str,
                    **attrs) -> _NullSpan:
        return NULL_SPAN

    def record(self, name: str, track: str, start: float, end: float,
               **attrs) -> _NullSpan:
        return NULL_SPAN

    def instant(self, name: str, track: str = "main", **attrs) -> None:
        pass

    def tracks(self) -> List[str]:
        return []

    @property
    def spans(self) -> List[Span]:
        return []

    @property
    def instants(self) -> List[Dict]:
        return []


NULL_TRACER = NullTracer()
