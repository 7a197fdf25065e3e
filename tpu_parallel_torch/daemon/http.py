"""Stdlib-only streaming network frontend for the serving daemon.

One :class:`ThreadingHTTPServer` over the daemon's locked surface —
handler threads call ``daemon.submit/cancel/result/subscribe`` (which
serialize on the daemon lock) while the tick pump runs in the main
thread.  No framework, no dependency: the container bakes nothing
extra, and the protocol is plain HTTP + Server-Sent Events.

Endpoints (docs/13_daemon.md is the reference):

- ``POST /v1/submit`` — JSON body ``{"prompt": [ids], "max_new_tokens",
  "dedupe_token", "priority", "deadline", "client_id", "temperature",
  "top_k", "top_p", "eos_token_id"}``.  200 with the request record on
  accept (the submit is journal-durable before the response); typed
  rejections map to 503 (``draining`` / ``degraded`` /
  ``journal_error`` — route elsewhere) / 429 (everything else) with
  the same record shape.  Bodies over ``max_body_bytes`` are refused
  413 WITHOUT reading them (a proxy misconfiguration or a hostile
  client cannot make a handler thread buffer an unbounded payload).
  Dedupe-token replays return the existing record — acknowledged work
  is idempotent across client retries and daemon restarts.
- ``GET /v1/stream/<id>`` — SSE: every already-delivered token replays
  first (``index`` continues across daemon restarts), then live events;
  the final event carries ``finished`` + the typed ``finish_reason``.
  A client disconnect mid-stream CANCELS the request in the cluster
  (``reason="disconnected"``) — a reply nobody is reading is wasted
  compute, exactly the deadline-cancel philosophy.
- ``POST /v1/cancel/<id>`` — client cancel (200 / 404).
- ``GET /v1/result/<id>`` — the current record snapshot (200 / 404).
- ``GET /healthz`` — 200 while serving, 503 once draining (load
  balancers pull the replica out during the SIGTERM grace window).
- ``GET /statez`` — frontend summary + daemon status JSON (the bench's
  leak assertions read ``inflight_tokens`` and per-replica pools here).
- ``GET /metricsz`` — Prometheus text exposition of the shared
  registry (``daemon_*``, ``cluster_*`` and per-engine series).
- ``GET /v1/tracez[?trace_id=...]`` — this process's spooled span
  records (docs/11_observability.md): what the trace stitcher
  and the fleet router's ``/v1/requestz`` collect and stitch.
"""

from __future__ import annotations

import json
import queue as _queue
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from tpu_parallel_torch.daemon.daemon import REJECT_DEGRADED, REJECT_JOURNAL
from tpu_parallel_torch.fleet.roles import REJECT_ROLE
from tpu_parallel_torch.obs.exporters import prometheus_text
from tpu_parallel_torch.obs.tracer import TRACE_HEADER, TraceContext
from tpu_parallel_torch.serving.kv_wire import (
    CHUNK_MAGIC,
    SEGMENT_OVERHEAD,
    WIRE_SEGMENT,
    ChunkReassembler,
    WireFormatError,
    decode_exports,
    encode_exports,
    is_chunk_stream,
    segment_claimed_length,
)
from tpu_parallel_torch.serving.request import (
    REJECT_DRAINING,
    REJECTED,
    Request,
    SamplingParams,
)

# SSE subscriber poll period: how often a quiet stream wakes to emit a
# keep-alive comment — which keeps idle streams alive through proxies
# that kill silent connections, AND bounds how long a disconnected
# client can hold a stream before the write fails and cancels the
# request (the default; DaemonHTTPServer's ``sse_keepalive_seconds``
# overrides per server)
_STREAM_POLL_SECONDS = 2.0

# submit-body cap default: prompts are token-id lists, so even a
# seq_len-8k prompt with maximal ids is far below this — anything
# bigger is a misdirected upload, not a request
_MAX_BODY_BYTES = 1 << 20

# peer-KV import cap: KV payloads are raw block tensors, orders of
# magnitude above any submit body, but still bounded — a peer shipping
# more than this per transfer should chunk its exports
_MAX_KV_BODY_BYTES = 1 << 27

# typed finish_reasons that map to 503 (route elsewhere / retry later)
# rather than 429 (client-side backpressure).  ``role`` is here because
# a decode-role daemon refusing fresh work is a routing fact, not
# client backpressure: the fleet router excludes the peer and tries the
# next ring successor without charging the breaker.
_UNAVAILABLE_REASONS = frozenset(
    {REJECT_DRAINING, REJECT_DEGRADED, REJECT_JOURNAL, REJECT_ROLE}
)


def build_request(body: dict) -> Request:
    """Validate a submit payload into a :class:`Request` (ValueError on
    a malformed body — the handler maps it to 400)."""
    prompt = body.get("prompt")
    if not isinstance(prompt, list) or not prompt:
        raise ValueError("'prompt' must be a non-empty list of token ids")
    if not all(isinstance(t, int) for t in prompt):
        raise ValueError("'prompt' must contain integer token ids")
    sampling = SamplingParams(
        temperature=float(body.get("temperature", 0.0)),
        top_k=int(body.get("top_k", 0)),
        top_p=float(body.get("top_p", 0.0)),
    )
    deadline = body.get("deadline")
    return Request(
        prompt=prompt,
        max_new_tokens=int(body.get("max_new_tokens", 32)),
        sampling=sampling,
        eos_token_id=body.get("eos_token_id"),
        client_id=body.get("client_id"),
        priority=int(body.get("priority", 0)),
        deadline=None if deadline is None else float(deadline),
        dedupe_token=body.get("dedupe_token"),
    )


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    daemon = None  # set by DaemonHTTPServer
    max_body_bytes = _MAX_BODY_BYTES
    max_kv_body_bytes = _MAX_KV_BODY_BYTES
    keepalive_seconds = _STREAM_POLL_SECONDS

    # -- plumbing ----------------------------------------------------------

    def log_message(self, fmt, *args):  # quiet by default
        pass

    def _json(self, code: int, payload: dict) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _text(self, code: int, text: str, ctype: str) -> None:
        body = text.encode()
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _read_body(self) -> Optional[dict]:
        try:
            length = int(self.headers.get("Content-Length", 0))
            raw = self.rfile.read(length) if length else b"{}"
            body = json.loads(raw or b"{}")
        except (ValueError, OSError):
            return None
        return body if isinstance(body, dict) else None

    # -- routes ------------------------------------------------------------

    def do_POST(self):
        d = self.daemon
        if self.path == "/v1/submit":
            try:
                length = int(self.headers.get("Content-Length", 0))
            except ValueError:
                length = -1
            if length < 0 or length > self.max_body_bytes:
                # refused WITHOUT reading the body: the unread bytes
                # mean this connection cannot be reused
                self.close_connection = True
                return self._json(413, {
                    "error": (
                        f"body of {length} bytes exceeds the "
                        f"{self.max_body_bytes}-byte submit limit"
                    ),
                })
            body = self._read_body()
            if body is None:
                return self._json(400, {"error": "malformed JSON body"})
            try:
                req = build_request(body)
            except (ValueError, TypeError) as exc:
                return self._json(400, {"error": str(exc)})
            # adopt the caller's trace context (the router forks one
            # per wire crossing); garbage parses to None = untraced
            ctx = TraceContext.parse(self.headers.get(TRACE_HEADER))
            record = d.submit(
                req,
                dedupe_token=body.get("dedupe_token"),
                phase=body.get("phase"),
                trace=ctx,
            )
            # ``ts`` is this process's clock at response time: the
            # router pairs it with its send/recv stamps to estimate the
            # cross-host clock offset the stitcher aligns with
            record = dict(record)
            record["ts"] = d.clock()
            if record["status"] == REJECTED:
                code = (
                    503
                    if record["finish_reason"] in _UNAVAILABLE_REASONS
                    else 429
                )
                return self._json(code, record)
            return self._json(200, record)
        if self.path.startswith("/v1/cancel/"):
            rid = self.path[len("/v1/cancel/"):]
            if d.cancel(rid, reason="cancelled"):
                return self._json(200, {"cancelled": rid})
            return self._json(404, {"error": f"unknown/done request {rid}"})
        if self.path == "/v1/kv/import":
            return self._kv_import()
        return self._json(404, {"error": f"no route {self.path}"})

    def _read_exact(self, n: int) -> bytes:
        """Read exactly ``n`` body bytes or raise OSError — stdlib
        ``rfile.read`` may return short on a socket boundary."""
        chunks = []
        while n > 0:
            piece = self.rfile.read(min(n, 1 << 16))
            if not piece:
                raise OSError("short read")
            chunks.append(piece)
            n -= len(piece)
        return b"".join(chunks)

    def _kv_import(self) -> None:
        """Peer KV landing, verdict counts out.  Two body shapes:

        - bare ``KVW1`` frame stream (warm-start / drain-forward):
          decoded whole, landed whole;
        - ``KVC1`` chunk stream (the disaggregation handoff hot path):
          segments are read off the socket one at a time and whole
          frames land AS THEY COMPLETE — blocks are already in the
          radix tree while later segments are still in flight
          (Mooncake-style overlap).

        Damage is a typed 400 either way — the refusal IS the
        response.  Frames that verified and landed before the damage
        stay landed (each frame is atomic and self-verifying), the
        damaged remainder never lands, and the refusing verdict tells
        the router to fall back rather than trust the transfer."""
        d = self.daemon
        try:
            length = int(self.headers.get("Content-Length", 0))
        except ValueError:
            length = -1
        if length < 0 or length > self.max_kv_body_bytes:
            self.close_connection = True
            return self._json(413, {
                "error": (
                    f"KV payload of {length} bytes exceeds the "
                    f"{self.max_kv_body_bytes}-byte import limit"
                ),
            })

        def refuse(exc: WireFormatError, verdicts=None) -> None:
            d.registry.counter(
                "daemon_kv_wire_refusals_total", reason=exc.reason
            ).inc()
            # unread body bytes may remain after an early refusal
            self.close_connection = True
            payload = {"error": str(exc), "reason": exc.reason}
            if verdicts:
                payload["verdicts"] = verdicts
            return self._json(400, payload)

        try:
            head = self._read_exact(min(length, len(CHUNK_MAGIC)))
        except OSError:
            return self._json(400, {"error": "truncated KV payload"})

        if not is_chunk_stream(head):
            try:
                raw = head + self._read_exact(length - len(head))
            except OSError:
                return self._json(400, {"error": "truncated KV payload"})
            try:
                exports = decode_exports(raw)
            except WireFormatError as exc:
                return refuse(exc)
            verdicts = d.import_peer_kv(exports)
            return self._json(200, {
                "verdicts": verdicts,
                "imported": verdicts.get("imported", 0),
            })

        # chunk stream: feed segment by segment, landing early
        asm = ChunkReassembler()
        verdicts: dict = {}
        segments = 0
        consumed = len(head)

        def land(exports) -> None:
            if not exports:
                return
            for verdict, n in d.import_peer_kv(exports).items():
                verdicts[verdict] = verdicts.get(verdict, 0) + n

        try:
            # every read is bounded by the declared Content-Length so a
            # lying prelude can never block the handler on the socket
            if length < SEGMENT_OVERHEAD:
                raise WireFormatError(
                    WIRE_SEGMENT,
                    f"{length}-byte body, segment prelude needs "
                    f"{SEGMENT_OVERHEAD}",
                )
            prelude = head + self._read_exact(SEGMENT_OVERHEAD - len(head))
            consumed = SEGMENT_OVERHEAD
            while True:
                slen = segment_claimed_length(prelude)
                if slen > length - consumed:
                    raise WireFormatError(
                        WIRE_SEGMENT,
                        f"segment claims {slen} payload bytes, "
                        f"{length - consumed} remain in the body",
                    )
                payload = self._read_exact(slen)
                consumed += slen
                asm.feed(prelude + payload)
                segments += 1
                land(asm.drain())
                if asm.finished:
                    if consumed != length:
                        raise WireFormatError(
                            WIRE_SEGMENT,
                            f"{length - consumed} body bytes after "
                            "the terminal segment",
                        )
                    break
                if consumed >= length:
                    asm.close()  # unterminated: typed refusal
                    break
                if length - consumed < SEGMENT_OVERHEAD:
                    raise WireFormatError(
                        WIRE_SEGMENT,
                        f"{length - consumed} trailing body bytes, "
                        f"segment prelude needs {SEGMENT_OVERHEAD}",
                    )
                prelude = self._read_exact(SEGMENT_OVERHEAD)
                consumed += SEGMENT_OVERHEAD
        except WireFormatError as exc:
            return refuse(exc, verdicts)
        except OSError:
            # the sender died mid-transfer: surface it as the same
            # typed refusal the unterminated-stream close gives
            try:
                asm.close()
            except WireFormatError as exc:
                return refuse(exc, verdicts)
            return self._json(400, {"error": "truncated KV payload"})
        return self._json(200, {
            "verdicts": verdicts,
            "imported": verdicts.get("imported", 0),
            "segments": segments,
        })

    def do_GET(self):
        d = self.daemon
        if self.path == "/healthz":
            status = d.status()
            unavailable = (
                status["draining"]
                or status["stopped"]
                or status["degraded_reason"] is not None
            )
            code = 503 if unavailable else 200
            return self._json(code, {
                "ok": code == 200,
                "role": status["role"],
                "draining": status["draining"],
                "degraded_reason": status["degraded_reason"],
                "ticks": status["ticks"],
                "recoveries": status["recoveries"],
                # KV-tier occupancy: the fleet router and the
                # autopilot's role lever read pressure here instead of
                # probing blind
                "kv": d.kv_occupancy(),
                # this process's clock, for the router's probe-driven
                # clock-offset estimation (obs/stitch.py aligns on it)
                "ts": d.clock(),
            })
        if self.path == "/statez":
            return self._json(200, {
                "daemon": d.status(),
                "cluster": d.frontend.summary(),
            })
        if self.path == "/metricsz":
            return self._text(
                200, prometheus_text(d.registry),
                "text/plain; version=0.0.4",
            )
        parts = urllib.parse.urlsplit(self.path)
        if parts.path == "/v1/tracez":
            qs = urllib.parse.parse_qs(parts.query)
            trace_id = qs.get("trace_id", [None])[0]
            return self._json(200, d.trace_payload(trace_id))
        if parts.path == "/v1/kv/export":
            max_blocks = 16
            qs = urllib.parse.parse_qs(parts.query)
            if "max_blocks" in qs:
                try:
                    max_blocks = int(qs["max_blocks"][-1])
                except ValueError:
                    return self._json(400, {
                        "error": "max_blocks must be an integer",
                    })
                if max_blocks < 0:
                    return self._json(400, {
                        "error": "max_blocks must be >= 0",
                    })
            if "request_id" in qs:
                # per-request export: the prefill→decode handoff donor
                # leg (one live request's written prefix, not the hot
                # radix snapshot)
                exports = d.export_request_kv(qs["request_id"][-1])
            else:
                exports = d.export_hot_kv(max_blocks=max_blocks)
            blob = encode_exports(exports)
            self.send_response(200)
            self.send_header("Content-Type", "application/octet-stream")
            self.send_header("Content-Length", str(len(blob)))
            self.end_headers()
            self.wfile.write(blob)
            return
        if self.path.startswith("/v1/result/"):
            rid = self.path[len("/v1/result/"):]
            record = d.result(rid)
            if record is None:
                return self._json(404, {"error": f"unknown request {rid}"})
            return self._json(200, record)
        if self.path.startswith("/v1/stream/"):
            return self._stream(self.path[len("/v1/stream/"):])
        return self._json(404, {"error": f"no route {self.path}"})

    # -- SSE ---------------------------------------------------------------

    def _sse(self, payload: dict) -> None:
        self.wfile.write(f"data: {json.dumps(payload)}\n\n".encode())
        self.wfile.flush()

    def _stream(self, rid: str) -> None:
        d = self.daemon
        snapshot, q = d.subscribe(rid)
        if snapshot is None:
            return self._json(404, {"error": f"unknown request {rid}"})
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Connection", "close")
        self.end_headers()
        try:
            for i, tok in enumerate(snapshot["tokens"]):
                self._sse({"request_id": rid, "token": tok, "index": i})
            if q is None:  # already terminal: replay the ending and stop
                self._sse({
                    "request_id": rid, "finished": True,
                    "status": snapshot["status"],
                    "finish_reason": snapshot["finish_reason"],
                })
                return
            while True:
                try:
                    ev = q.get(timeout=self.keepalive_seconds)
                except _queue.Empty:
                    # heartbeat: also probes whether the client is gone
                    self.wfile.write(b": keepalive\n\n")
                    self.wfile.flush()
                    continue
                if ev.token >= 0:
                    self._sse({
                        "request_id": rid, "token": ev.token,
                        "index": ev.index,
                    })
                if ev.finished:
                    record = d.result(rid) or {}
                    self._sse({
                        "request_id": rid, "finished": True,
                        "status": record.get("status"),
                        "finish_reason": ev.finish_reason,
                    })
                    return
        except (BrokenPipeError, ConnectionResetError, OSError):
            # the client hung up mid-stream: stop generating for it
            d.cancel(rid, reason="disconnected")
        finally:
            if q is not None:
                d.unsubscribe(rid, q)


class DaemonHTTPServer:
    """The daemon's network face: a threading HTTP server bound to
    ``host:port`` (port 0 = ephemeral; read ``.port`` after start),
    served from a background thread so the daemon's ``run()`` pump owns
    the main thread (where the signal handlers live)."""

    def __init__(
        self,
        daemon,
        host: str = "127.0.0.1",
        port: int = 0,
        max_body_bytes: int = _MAX_BODY_BYTES,
        max_kv_body_bytes: int = _MAX_KV_BODY_BYTES,
        sse_keepalive_seconds: float = _STREAM_POLL_SECONDS,
    ):
        if max_body_bytes < 1:
            raise ValueError(f"max_body_bytes={max_body_bytes} < 1")
        if max_kv_body_bytes < 1:
            raise ValueError(f"max_kv_body_bytes={max_kv_body_bytes} < 1")
        if sse_keepalive_seconds <= 0:
            raise ValueError(
                f"sse_keepalive_seconds={sse_keepalive_seconds} <= 0"
            )
        handler = type("_BoundHandler", (_Handler,), {
            "daemon": daemon,
            "max_body_bytes": max_body_bytes,
            "max_kv_body_bytes": max_kv_body_bytes,
            "keepalive_seconds": sse_keepalive_seconds,
        })
        self.httpd = ThreadingHTTPServer((host, port), handler)
        self.httpd.daemon_threads = True
        self.host, self.port = self.httpd.server_address[:2]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "DaemonHTTPServer":
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, kwargs={"poll_interval": 0.1},
            daemon=True,
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
