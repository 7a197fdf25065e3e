"""Length-prefixed binary wire codec for :class:`KVPrefixExport`: a copy
of ``tpu_parallel/serving/kv_wire.py`` whose frames are byte-identical to
the JAX package's for the same export, so a prefix moves between the two
packages as bytes.

The export is a self-verifying exchange unit (one CRC32 per block,
recomputed before any import lands).  This module makes it a WIRE
format: ``encode_export`` flattens one export into a single frame of
bytes, ``decode_export`` rebuilds it bitwise, and concatenated frames
(``encode_exports`` / ``decode_exports``) are the body of the JAX
fleet's ``/v1/kv/export`` → ``/v1/kv/import`` exchange.

bfloat16: numpy has no bfloat16 type of its own, so the port carries a bf16 leaf as its raw bits, a uint16 array whose dtype is
:data:`~tpu_parallel_torch.serving.cache_pool.BFLOAT16_BITS` (uint16
tagged ``"bfloat16"`` in its metadata).  The header names such a leaf
``"bfloat16"``, as the JAX package writes it, and decoding a
``"bfloat16"`` leaf gives that tagged uint16 array back: the bytes, the
per-block CRCs and the frame are the JAX package's.

Frame layout (all integers big-endian)::

    magic   b"KVW1"                       4 bytes
    hlen    uint32  header length         4 bytes
    hcrc    uint32  CRC32 of header       4 bytes
    header  canonical JSON (utf-8)        hlen bytes
    payload leaf arrays, C-order bytes    sum(leaf nbytes)

The header carries everything except the raw K/V bytes — tokens,
block geometry, ``weights_version``, the exporter's ``meta`` shape
signature, the per-block checksums, and each leaf's dtype/shape (which
is what makes the payload self-describing: leaf byte extents are
derived, never trusted from a length field that could disagree).

Decoding REFUSES, never guesses: every way a frame can be damaged maps
to a typed :class:`WireFormatError` reason (``truncated``, ``magic``,
``header_crc``, ``header_schema``, ``integrity``).  A bit flipped in
the payload trips the per-block CRC (``integrity``); a bit flipped in
the header trips ``hcrc`` before the JSON is even parsed — so version
skew and shape compatibility are still judged by
:meth:`ServingEngine.import_prefix` on exactly the values the exporter
wrote, and corrupt bytes never serve (the importer recomputes from
tokens instead).

The codec is pure bytes-in/bytes-out; only the file helpers at the
bottom touch the filesystem, and they go through the
``daemon.iofaults`` read gate so the seeded-rot soak covers blobs at
rest the same way it covers the journal.
"""

from __future__ import annotations

import json
import math
import struct
import zlib
from typing import List, Tuple

import numpy as np

from tpu_parallel_torch.serving.cache_pool import BFLOAT16_BITS, leaf_dtype_name
from tpu_parallel_torch.serving.kv_hierarchy import KVPrefixExport

MAGIC = b"KVW1"
_HEADER_STRUCT = struct.Struct(">II")  # hlen, hcrc
_FRAME_OVERHEAD = len(MAGIC) + _HEADER_STRUCT.size

# a header is small (tokens + shapes); anything claiming more is damage,
# not data — refuse before allocating
MAX_HEADER_BYTES = 1 << 24

WIRE_TRUNCATED = "truncated"
WIRE_MAGIC = "magic"
WIRE_HEADER_CRC = "header_crc"
WIRE_HEADER_SCHEMA = "header_schema"
WIRE_INTEGRITY = "integrity"
WIRE_SEGMENT = "segment"  # chunk-stream framing damage (see below)

WIRE_REASONS = (
    WIRE_TRUNCATED,
    WIRE_MAGIC,
    WIRE_HEADER_CRC,
    WIRE_HEADER_SCHEMA,
    WIRE_INTEGRITY,
    WIRE_SEGMENT,
)

# -- streaming-chunk framing (the disaggregation hot path) -------------------
#
# A KV handoff can be far larger than a sane single message, so exports
# over ``max_wire_bytes`` ship as a CHUNK STREAM: the concatenated-frame
# body is sliced into self-checksummed segments, closed by a terminal
# segment that carries the whole-body CRC.  Each segment::
#
#     smagic  b"KVC1"                      4 bytes
#     seq     uint32 (0-based)             4 bytes
#     slen    uint32 payload length        4 bytes
#     scrc    uint32 CRC32(payload)        4 bytes
#     payload slen bytes of the frame body
#
# The terminal segment has ``slen == 0``, ``seq == n_data_segments`` and
# ``scrc == CRC32(full body)``.  The receiver imports nothing from a
# stream it cannot finish verifying PER FRAME: whole KVW1 frames that
# complete inside the received prefix may land early (each frame is
# already self-verifying — Mooncake-style overlap), but a missing,
# reordered, damaged or unterminated segment is a typed ``segment``
# refusal and the partially-received remainder never lands — no
# half-imported prefix.

CHUNK_MAGIC = b"KVC1"
_SEGMENT_STRUCT = struct.Struct(">III")  # seq, slen, scrc
SEGMENT_OVERHEAD = len(CHUNK_MAGIC) + _SEGMENT_STRUCT.size

# default per-message bound for chunked shipment: large enough that a
# warm-start blob rarely chunks, small enough that a handoff's transfer
# pipelines instead of arriving as one multi-hundred-MB message
DEFAULT_MAX_WIRE_BYTES = 1 << 20


class WireFormatError(ValueError):
    """A frame that cannot be decoded — carries the typed ``reason``
    (one of :data:`WIRE_REASONS`) the refusing side reports, so the
    import endpoint's 400 and the fleet's ``fleet_kv_wire_refusals``
    counter speak the same vocabulary as the migration verdicts."""

    def __init__(self, reason: str, detail: str):
        assert reason in WIRE_REASONS, reason
        super().__init__(f"{reason}: {detail}")
        self.reason = reason
        self.detail = detail


def _dtype(name: str) -> np.dtype:
    """Resolve a dtype name recorded at encode time.  Plain numpy names
    resolve directly; ``"bfloat16"`` resolves to its raw bits
    (:data:`BFLOAT16_BITS`).  Any other name (the float8 variants the
    JAX package could record) refuses typed."""
    if name == "bfloat16":
        return BFLOAT16_BITS
    try:
        return np.dtype(name)
    except TypeError:
        raise WireFormatError(
            WIRE_HEADER_SCHEMA, f"unknown leaf dtype {name!r}"
        ) from None


def _tuplize(obj):
    """JSON loses tuple-ness; ``meta`` equality at import compares
    against the pool's tuple-of-tuples signature, so rebuild it."""
    if isinstance(obj, list):
        return tuple(_tuplize(x) for x in obj)
    return obj


def encode_export(export: KVPrefixExport) -> bytes:
    """One export → one frame of bytes (see the module docstring for
    the layout).  Leaves are shipped as C-order raw bytes; the header's
    per-leaf dtype/shape entries are what decode uses to carve the
    payload back up, and the canonical-JSON header keeps equal exports
    byte-identical on the wire."""
    leaves = [np.ascontiguousarray(leaf) for leaf in export.leaves]
    header = {
        "tokens": [int(t) for t in export.tokens],
        "length": int(export.length),
        "block_tokens": int(export.block_tokens),
        "weights_version": str(export.weights_version),
        "meta": export.meta,
        "checksums": [int(c) for c in export.checksums],
        "leaves": [
            {"dtype": leaf_dtype_name(leaf), "shape": list(leaf.shape)}
            for leaf in leaves
        ],
    }
    hbytes = json.dumps(
        header, sort_keys=True, separators=(",", ":"), default=list
    ).encode("utf-8")
    frame = [
        MAGIC,
        _HEADER_STRUCT.pack(len(hbytes), zlib.crc32(hbytes) & 0xFFFFFFFF),
        hbytes,
    ]
    frame.extend(leaf.tobytes(order="C") for leaf in leaves)
    return b"".join(frame)


def _decode_frame(
    buf: bytes, off: int, verify: bool
) -> Tuple[KVPrefixExport, int]:
    """Decode one frame starting at ``off``; returns the export and the
    offset just past it.  Raises :class:`WireFormatError` — typed,
    never a stray struct/json/numpy exception."""
    if len(buf) - off < _FRAME_OVERHEAD:
        raise WireFormatError(
            WIRE_TRUNCATED,
            f"{len(buf) - off} bytes at offset {off}, "
            f"frame prelude needs {_FRAME_OVERHEAD}",
        )
    if buf[off:off + len(MAGIC)] != MAGIC:
        raise WireFormatError(
            WIRE_MAGIC,
            f"bad magic {buf[off:off + len(MAGIC)]!r} at offset {off}",
        )
    hlen, hcrc = _HEADER_STRUCT.unpack_from(buf, off + len(MAGIC))
    if hlen > MAX_HEADER_BYTES:
        raise WireFormatError(
            WIRE_HEADER_SCHEMA, f"header claims {hlen} bytes"
        )
    hstart = off + _FRAME_OVERHEAD
    if len(buf) - hstart < hlen:
        raise WireFormatError(
            WIRE_TRUNCATED,
            f"header needs {hlen} bytes, {len(buf) - hstart} remain",
        )
    hbytes = buf[hstart:hstart + hlen]
    if (zlib.crc32(hbytes) & 0xFFFFFFFF) != hcrc:
        raise WireFormatError(
            WIRE_HEADER_CRC, "header CRC mismatch (damaged in transit)"
        )
    try:
        header = json.loads(hbytes.decode("utf-8"))
        tokens = tuple(int(t) for t in header["tokens"])
        length = int(header["length"])
        block_tokens = int(header["block_tokens"])
        weights_version = str(header["weights_version"])
        meta = _tuplize(header["meta"])
        checksums = tuple(int(c) for c in header["checksums"])
        leaf_specs = []
        for spec in header["leaves"]:
            shape = tuple(int(d) for d in spec["shape"])
            if any(d < 0 for d in shape):
                # a negative dim would make the extent arithmetic lie
                # (count<0 reads the whole buffer, pos walks backwards)
                raise WireFormatError(
                    WIRE_HEADER_SCHEMA, f"negative leaf dim in {shape}"
                )
            leaf_specs.append((_dtype(spec["dtype"]), shape))
    except WireFormatError:
        raise
    except (KeyError, TypeError, ValueError) as exc:
        raise WireFormatError(
            WIRE_HEADER_SCHEMA, f"malformed header: {exc}"
        ) from None
    pos = hstart + hlen
    leaves = []
    for dtype, shape in leaf_specs:
        # Python-int arithmetic: a huge claimed dim must overflow into
        # "bigger than the buffer" (truncated), never wrap negative
        count = math.prod(shape)
        nbytes = dtype.itemsize * count
        if nbytes > len(buf) - pos:
            raise WireFormatError(
                WIRE_TRUNCATED,
                f"leaf needs {nbytes} bytes, {len(buf) - pos} remain",
            )
        try:
            arr = np.frombuffer(buf, dtype=dtype, count=count, offset=pos)
            leaves.append(arr.reshape(shape).copy())
        except (ValueError, TypeError) as exc:
            raise WireFormatError(
                WIRE_HEADER_SCHEMA, f"leaf does not carve: {exc}"
            ) from None
        pos += nbytes
    export = KVPrefixExport(
        tokens=tokens,
        length=length,
        block_tokens=block_tokens,
        weights_version=weights_version,
        meta=meta,
        leaves=tuple(leaves),
        checksums=checksums,
    )
    if verify and not export.verified():
        raise WireFormatError(
            WIRE_INTEGRITY,
            "per-block CRC mismatch — payload damaged in transit",
        )
    return export, pos


def decode_export(buf: bytes, *, verify: bool = True) -> KVPrefixExport:
    """Decode exactly one frame; trailing bytes are damage, not data.
    ``verify=True`` (the default) recomputes the per-block CRCs so
    corrupt payloads refuse HERE — importers may pass ``verify=False``
    when they run the same check themselves via
    :meth:`ServingEngine.import_prefix`."""
    export, end = _decode_frame(buf, 0, verify)
    if end != len(buf):
        raise WireFormatError(
            WIRE_TRUNCATED,
            f"{len(buf) - end} trailing bytes after one frame",
        )
    return export


def encode_exports(exports) -> bytes:
    """Concatenated frames — the ``/v1/kv/export`` response body.  An
    empty list is an empty body (a donor with nothing hot is a valid
    answer, not an error)."""
    return b"".join(encode_export(e) for e in exports)


def decode_exports(
    buf: bytes, *, verify: bool = True
) -> List[KVPrefixExport]:
    """Decode a stream of concatenated frames until the buffer is
    exactly consumed.  Any damage — mid-frame truncation included —
    refuses the WHOLE stream: a partial import would leave the receiver
    believing it warm-started chains it only half holds."""
    out: List[KVPrefixExport] = []
    off = 0
    while off < len(buf):
        export, off = _decode_frame(buf, off, verify)
        out.append(export)
    return out


def _segment(seq: int, payload: bytes) -> bytes:
    return b"".join((
        CHUNK_MAGIC,
        _SEGMENT_STRUCT.pack(
            seq, len(payload), zlib.crc32(payload) & 0xFFFFFFFF
        ),
        payload,
    ))


def encode_export_chunks(
    exports, *, max_wire_bytes: int = DEFAULT_MAX_WIRE_BYTES
) -> List[bytes]:
    """Slice a stream of exports into bounded, self-checksummed chunk
    segments (see the layout comment above).  Always ends with the
    terminal segment — even an empty export list ships as one terminal
    (so the receiver can tell "nothing hot" from "transfer died").
    Concatenating the returned segments is a valid single-message body;
    sending them one write at a time is the streaming hot path."""
    return chunk_body(encode_exports(exports), max_wire_bytes=max_wire_bytes)


def chunk_body(
    body: bytes, *, max_wire_bytes: int = DEFAULT_MAX_WIRE_BYTES
) -> List[bytes]:
    """Chunk an ALREADY-ENCODED frame-stream body — the router's relay
    leg, which holds the donor's encoded bytes and must not decode K/V
    it merely forwards.  Same segment layout and terminal as
    :func:`encode_export_chunks`."""
    if max_wire_bytes < 1:
        raise ValueError(f"max_wire_bytes={max_wire_bytes} < 1")
    segments = [
        _segment(seq, body[off:off + max_wire_bytes])
        for seq, off in enumerate(range(0, len(body), max_wire_bytes))
    ]
    terminal = b"".join((
        CHUNK_MAGIC,
        _SEGMENT_STRUCT.pack(
            len(segments), 0, zlib.crc32(body) & 0xFFFFFFFF
        ),
    ))
    segments.append(terminal)
    return segments


def segment_claimed_length(prelude: bytes) -> int:
    """Payload length a segment prelude claims — the incremental
    receiver's read-ahead (how many payload bytes to pull off the
    socket before feeding).  Typed ``segment`` refusal on a short
    prelude or wrong magic, so a receiver never sizes a read from
    garbage."""
    if len(prelude) < SEGMENT_OVERHEAD:
        raise WireFormatError(
            WIRE_SEGMENT,
            f"prelude of {len(prelude)} bytes, needs {SEGMENT_OVERHEAD}",
        )
    if prelude[: len(CHUNK_MAGIC)] != CHUNK_MAGIC:
        raise WireFormatError(
            WIRE_SEGMENT,
            f"bad segment magic {prelude[:len(CHUNK_MAGIC)]!r}",
        )
    _seq, slen, _scrc = _SEGMENT_STRUCT.unpack_from(
        prelude, len(CHUNK_MAGIC)
    )
    return slen


def is_chunk_stream(buf: bytes) -> bool:
    """Whether a body starts as a chunk stream (KVC1) rather than a
    bare frame stream (KVW1) — the import endpoint's dispatch test."""
    return buf[: len(CHUNK_MAGIC)] == CHUNK_MAGIC


class ChunkReassembler:
    """Rebuild a chunk stream segment by segment, surfacing whole
    frames EARLY (``drain``) while refusing damage typed.

    Feed order is the wire order; every damage shape — wrong magic,
    out-of-order ``seq``, payload CRC mismatch, bytes after the
    terminal, or a final body whose whole-stream CRC disagrees — raises
    :class:`WireFormatError` with reason ``segment`` and poisons the
    reassembler (further feeds refuse).  ``drain`` decodes any frames
    that are COMPLETE in the verified prefix received so far; a frame
    still straddling the incoming edge stays buffered.  A receiver that
    lands drained frames as they appear and treats any raised refusal
    as "stop, import nothing further" can never half-import a prefix:
    frames are atomic and each one re-verifies its own per-block CRCs.
    """

    def __init__(self, *, verify: bool = True):
        self.verify = verify
        self._buf = bytearray()
        self._next_seq = 0
        self._decoded_off = 0  # bytes already returned via drain()
        self._finished = False
        self._failed = False

    @property
    def finished(self) -> bool:
        """True once the terminal segment verified the whole body."""
        return self._finished

    def _fail(self, detail: str) -> "WireFormatError":
        self._failed = True
        return WireFormatError(WIRE_SEGMENT, detail)

    def feed(self, segment: bytes) -> None:
        """Fold one wire segment in.  Typed ``segment`` refusal on any
        framing damage; the terminal segment closes and verifies the
        stream."""
        if self._failed:
            raise self._fail("stream already refused")
        if self._finished:
            raise self._fail("segment after terminal")
        if len(segment) < SEGMENT_OVERHEAD:
            raise self._fail(
                f"segment of {len(segment)} bytes, prelude needs "
                f"{SEGMENT_OVERHEAD}"
            )
        if segment[: len(CHUNK_MAGIC)] != CHUNK_MAGIC:
            raise self._fail(
                f"bad segment magic {segment[:len(CHUNK_MAGIC)]!r}"
            )
        seq, slen, scrc = _SEGMENT_STRUCT.unpack_from(
            segment, len(CHUNK_MAGIC)
        )
        payload = segment[SEGMENT_OVERHEAD:]
        if seq != self._next_seq:
            raise self._fail(
                f"segment seq {seq}, expected {self._next_seq} "
                "(lost or reordered in transit)"
            )
        if slen == 0:
            # terminal: scrc covers the WHOLE reassembled body
            if payload:
                raise self._fail(
                    f"{len(payload)} bytes after the terminal segment"
                )
            if (zlib.crc32(bytes(self._buf)) & 0xFFFFFFFF) != scrc:
                raise self._fail(
                    "whole-stream CRC mismatch at terminal"
                )
            self._finished = True
            return
        if len(payload) != slen:
            raise self._fail(
                f"segment claims {slen} payload bytes, "
                f"{len(payload)} present"
            )
        if (zlib.crc32(payload) & 0xFFFFFFFF) != scrc:
            raise self._fail("segment CRC mismatch (damaged in transit)")
        self._buf.extend(payload)
        self._next_seq += 1

    def drain(self) -> List[KVPrefixExport]:
        """Decode every frame COMPLETE in the verified bytes received
        so far and not yet returned — the early-overlap surface: the
        importer lands these while later segments are still in flight.
        Frame-level damage refuses typed exactly as
        :func:`decode_exports` would."""
        out: List[KVPrefixExport] = []
        buf = bytes(self._buf)
        while self._decoded_off < len(buf):
            try:
                export, end = _decode_frame(
                    buf, self._decoded_off, self.verify
                )
            except WireFormatError as exc:
                if exc.reason == WIRE_TRUNCATED and not self._finished:
                    break  # frame straddles the incoming edge: wait
                self._failed = True
                raise
            out.append(export)
            self._decoded_off = end
        if self._finished and self._decoded_off != len(buf):
            raise self._fail(
                f"{len(buf) - self._decoded_off} trailing bytes after "
                "the last whole frame"
            )
        return out

    def close(self) -> None:
        """Assert the stream terminated — call when the sender's
        connection ends.  An unterminated stream (the mid-transfer
        death case) is a typed ``segment`` refusal here, so the caller
        records it instead of mistaking the silence for success."""
        if self._failed:
            raise self._fail("stream already refused")
        if not self._finished:
            raise self._fail(
                f"stream ended after {self._next_seq} segment(s) "
                "without a terminal"
            )


def decode_export_chunks(
    buf: bytes, *, verify: bool = True
) -> List[KVPrefixExport]:
    """One-shot decode of a concatenated chunk-stream body (the
    non-streaming receiver).  Walks segment framing first, then the
    frames — every damage shape is the same typed refusal the
    incremental :class:`ChunkReassembler` raises."""
    asm = ChunkReassembler(verify=verify)
    out: List[KVPrefixExport] = []
    off = 0
    while off < len(buf) and not asm.finished:
        if len(buf) - off < SEGMENT_OVERHEAD:
            raise WireFormatError(
                WIRE_SEGMENT,
                f"{len(buf) - off} bytes at offset {off}, segment "
                f"prelude needs {SEGMENT_OVERHEAD}",
            )
        _seq, slen, _scrc = _SEGMENT_STRUCT.unpack_from(
            buf, off + len(CHUNK_MAGIC)
        )
        end = off + SEGMENT_OVERHEAD + slen
        if end > len(buf):
            raise WireFormatError(
                WIRE_SEGMENT,
                f"segment claims {slen} payload bytes, "
                f"{len(buf) - off - SEGMENT_OVERHEAD} remain",
            )
        asm.feed(buf[off:end])
        out.extend(asm.drain())
        off = end
    if off != len(buf):
        raise WireFormatError(
            WIRE_SEGMENT, f"{len(buf) - off} bytes after the terminal"
        )
    asm.close()
    return out


def write_export_file(path: str, exports) -> str:
    """Spill a stream of exports to ``path`` (the bench's corpus /
    corrupt-injection legs).  Plain binary write — durability barriers
    are the journal's business, not a bench artifact's."""
    from tpu_parallel_torch.daemon import iofaults

    with iofaults.open_file(path, "wb") as fh:
        fh.write(encode_exports(exports))
    return path


def read_export_file(
    path: str, *, verify: bool = True
) -> List[KVPrefixExport]:
    """Read a spilled stream back through the ``iofaults`` read gate —
    an armed flip plan rots the blob exactly as it would the journal,
    and the typed refusal surfaces here instead of garbage K/V."""
    from tpu_parallel_torch.daemon import iofaults

    return decode_exports(iofaults.read_bytes(path), verify=verify)
