"""Port parity for the ``KVW1`` wire codec (``serving/kv_wire.py``): the
wire and chunk cases of ``tests/test_fleet.py`` re-run against the port,
and the cross-package contract — for one seeded payload, as float32 and as
bfloat16, both packages' ``encode_export`` give the same bytes, each
package decodes the other's frames bitwise, and ``block_checksums`` agree.

The port carries a bf16 leaf as its raw bits (``BFLOAT16_BITS``: uint16
tagged ``"bfloat16"``); the frames name it ``"bfloat16"`` as the JAX
package does.  Bytes and checksums compare exactly.  The JAX side is
imported inside a fixture.
"""

import dataclasses
import os
import random
import types

import numpy as np
import pytest
import torch

from tpu_parallel_torch.daemon import IOFaultPlan, iofaults
from tpu_parallel_torch.models import GPTLM, tiny_test
from tpu_parallel_torch.serving import (
    Request,
    SchedulerConfig,
    ServingEngine,
    block_checksums,
)
from tpu_parallel_torch.serving.cache_pool import BFLOAT16_BITS, leaf_dtype_name
from tpu_parallel_torch.serving.kv_hierarchy import (
    MIGRATE_IMPORTED,
    MIGRATE_WEIGHTS_VERSION,
    KVPrefixExport,
)
from tpu_parallel_torch.serving.kv_wire import (
    SEGMENT_OVERHEAD,
    WIRE_HEADER_SCHEMA,
    WIRE_MAGIC,
    WIRE_REASONS,
    WIRE_SEGMENT,
    ChunkReassembler,
    WireFormatError,
    decode_export,
    decode_export_chunks,
    decode_exports,
    encode_export,
    encode_export_chunks,
    encode_exports,
    is_chunk_stream,
    read_export_file,
    write_export_file,
)

# one torch intra-op thread per test process: under pytest-xdist several
# processes share the cores, and torch's default (a thread per core in each)
# oversubscribes them
torch.set_num_threads(1)


def _bf16_bits(x):
    """float values rounded to bf16 (round to nearest even), as raw bits."""
    t = torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
    return t.view(torch.int16).numpy().view(BFLOAT16_BITS)


# -- the wire and chunk cases of tests/test_fleet.py ---------------------------


def _synthetic_export(dtype, seed=0, n_blocks=2, block_tokens=4):
    """A hand-built export whose checksums are real (computed by the
    same ``block_checksums`` the pool uses), so ``verify=True`` decode
    paths exercise the genuine integrity check."""
    rnd = np.random.default_rng(seed)
    length = n_blocks * block_tokens
    shape_a = (n_blocks, block_tokens, 3)
    shape_b = (n_blocks, 2, block_tokens, 2)
    if dtype == "bfloat16":
        leaves = (
            _bf16_bits(rnd.standard_normal(shape_a)),
            _bf16_bits(rnd.standard_normal(shape_b)),
        )
    elif np.dtype(dtype).kind in "iu":
        leaves = (
            rnd.integers(-100, 100, shape_a).astype(dtype),
            rnd.integers(-100, 100, shape_b).astype(dtype),
        )
    else:
        leaves = (
            rnd.standard_normal(shape_a).astype(dtype),
            rnd.standard_normal(shape_b).astype(dtype),
        )
    return KVPrefixExport(
        tokens=tuple(int(t) for t in rnd.integers(1, 250, length)),
        length=length,
        block_tokens=block_tokens,
        weights_version="initial",
        meta=(("leaf_a", (block_tokens, 3)), ("leaf_b", (2, block_tokens, 2))),
        leaves=leaves,
        checksums=block_checksums(list(leaves), n_blocks),
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_wire_roundtrip_bitwise(dtype):
    """encode -> decode is the identity: every field equal, every leaf
    byte-identical (dtype included), and re-encoding the decoded export
    reproduces the original frame byte-for-byte (canonical headers)."""
    export = _synthetic_export(dtype, seed=3)
    blob = encode_export(export)
    back = decode_export(blob)
    assert back.tokens == export.tokens
    assert back.length == export.length
    assert back.block_tokens == export.block_tokens
    assert back.weights_version == export.weights_version
    assert back.meta == export.meta
    assert back.checksums == export.checksums
    assert len(back.leaves) == len(export.leaves)
    for got, want in zip(back.leaves, export.leaves):
        assert got.dtype == want.dtype
        assert leaf_dtype_name(got) == leaf_dtype_name(want) == dtype
        assert got.shape == want.shape
        assert got.tobytes() == want.tobytes()
    assert encode_export(back) == blob


def test_wire_multi_frame_stream():
    """Concatenated frames (the /v1/kv/export body) decode back to the
    same list, and an empty stream is a valid empty answer."""
    exports = [
        _synthetic_export(np.float32, seed=1),
        _synthetic_export(np.int8, seed=2, n_blocks=3),
    ]
    blob = encode_exports(exports)
    back = decode_exports(blob)
    assert len(back) == 2
    for got, want in zip(back, exports):
        assert got.tokens == want.tokens
        for g, w in zip(got.leaves, want.leaves):
            assert g.tobytes() == w.tobytes()
    assert decode_exports(b"") == []


def test_wire_truncation_refuses_typed():
    """Every prefix truncation refuses with a typed reason — never a
    stray struct/json/numpy exception, never a partial export."""
    blob = encode_export(_synthetic_export(np.float32, seed=4))
    cuts = {0, 2, 4, 7, 11, 40, len(blob) // 2, len(blob) - 1}
    for cut in sorted(cuts):
        with pytest.raises(WireFormatError) as exc:
            decode_export(blob[:cut])
        assert exc.value.reason in WIRE_REASONS
    # trailing garbage after a whole frame is damage too, not data
    with pytest.raises(WireFormatError):
        decode_export(blob + b"\x00")
    # a mid-stream truncation refuses the WHOLE multi-frame body
    stream = encode_exports(
        [_synthetic_export(np.float32, seed=5)] * 2
    )
    with pytest.raises(WireFormatError):
        decode_exports(stream[:-3])


def _tamper_header(blob, mutate):
    """Rewrite a frame's JSON header through ``mutate`` with a VALID
    CRC, so the tampered values reach the schema checks instead of
    tripping ``header_crc`` first."""
    import json
    import struct
    import zlib

    hlen, _hcrc = struct.unpack_from(">II", blob, 4)
    header = json.loads(blob[12:12 + hlen])
    mutate(header)
    hbytes = json.dumps(
        header, sort_keys=True, separators=(",", ":")
    ).encode("utf-8")
    return (
        blob[:4]
        + struct.pack(">II", len(hbytes), zlib.crc32(hbytes) & 0xFFFFFFFF)
        + hbytes
        + blob[12 + hlen:]
    )


def test_wire_negative_dim_refuses_typed():
    """A crafted header claiming a negative leaf dim refuses typed
    (``header_schema``) — a negative element count would otherwise read
    the whole remaining buffer and walk the stream offset BACKWARDS,
    turning ``decode_exports`` into an unbounded loop."""
    blob = encode_export(_synthetic_export(np.float32, seed=8))

    def negate(header):
        header["leaves"][0]["shape"][0] *= -1

    bad = _tamper_header(blob, negate)
    with pytest.raises(WireFormatError) as exc:
        decode_export(bad)
    assert exc.value.reason == WIRE_HEADER_SCHEMA
    # the multi-frame decoder refuses (terminates) on the same damage
    with pytest.raises(WireFormatError):
        decode_exports(bad + blob)

    # an absurdly huge dim must land in "bigger than the buffer", not
    # wrap through fixed-width arithmetic into something plausible
    def huge(header):
        header["leaves"][0]["shape"][0] = 1 << 62

    with pytest.raises(WireFormatError) as exc:
        decode_export(_tamper_header(blob, huge))
    assert exc.value.reason in WIRE_REASONS


def test_wire_bad_magic_typed():
    blob = bytearray(encode_export(_synthetic_export(np.float32)))
    blob[0] ^= 0xFF
    with pytest.raises(WireFormatError) as exc:
        decode_export(bytes(blob))
    assert exc.value.reason == WIRE_MAGIC


def test_wire_single_bit_flips_refuse_typed():
    """Seeded single-bit flips anywhere in the frame — magic, length
    words, header JSON, payload — ALWAYS refuse typed: there is no bit
    whose flip decodes into a silently different export."""
    blob = encode_export(_synthetic_export(np.float32, seed=6))
    rnd = random.Random(1234)
    for _ in range(64):
        bit = rnd.randrange(len(blob) * 8)
        flipped = bytearray(blob)
        flipped[bit // 8] ^= 1 << (bit % 8)
        with pytest.raises(WireFormatError) as exc:
            decode_export(bytes(flipped))
        assert exc.value.reason in WIRE_REASONS, bit


def test_wire_file_roundtrip_and_read_rot():
    """The file helpers ride the iofaults read gate: a clean read is
    bitwise, an armed read-side bit flip surfaces as the same typed
    refusal the wire path gives — never garbage K/V off disk."""
    import tempfile

    export = _synthetic_export(np.float32, seed=7)
    with tempfile.TemporaryDirectory() as tmp:
        path = write_export_file(
            os.path.join(tmp, "kv.wire"), [export]
        )
        back = read_export_file(path)
        assert len(back) == 1
        assert back[0].tokens == export.tokens
        with iofaults.inject(
            IOFaultPlan(flip_read_at=0, flip_read_bit=31337)
        ) as inj:
            with pytest.raises(WireFormatError) as exc:
                read_export_file(path)
            assert exc.value.reason in WIRE_REASONS
            assert inj.injected["bit_flip"] == 1


def test_chunk_roundtrip_and_streaming_drain():
    """The streaming framing: a multi-frame export body split into
    bounded segments reassembles bitwise, whole frames surface EARLY
    (before the terminal arrives — the Mooncake-style overlap), and an
    empty export list still ships as one lone terminal so the receiver
    can tell 'nothing hot' from 'transfer died'."""
    exports = [
        _synthetic_export(np.float32, seed=21),
        _synthetic_export(np.int8, seed=22, n_blocks=3),
    ]
    segments = encode_export_chunks(exports, max_wire_bytes=128)
    assert len(segments) > 3, "body never actually split"
    for seg in segments:
        assert is_chunk_stream(seg)
        assert len(seg) <= 128 + SEGMENT_OVERHEAD
    back = decode_export_chunks(b"".join(segments))
    assert len(back) == 2
    for got, want in zip(back, exports):
        assert got.tokens == want.tokens
        assert got.checksums == want.checksums
        for g, w in zip(got.leaves, want.leaves):
            assert g.tobytes() == w.tobytes()
    # incremental receive: the first frame lands while later segments
    # are still "in flight"
    asm = ChunkReassembler()
    landed = []
    for seg in segments[:-1]:
        asm.feed(seg)
        landed.extend(asm.drain())
    assert landed and not asm.finished
    asm.feed(segments[-1])
    landed.extend(asm.drain())
    asm.close()
    assert len(landed) == 2
    lone = encode_export_chunks([], max_wire_bytes=128)
    assert len(lone) == 1
    assert decode_export_chunks(b"".join(lone)) == []


def test_chunk_damage_matrix_refuses_typed():
    """Every chunk-stream damage shape — lost segment, reordering, a
    flipped payload bit, a corrupted terminal checksum, a missing
    terminal (the mid-transfer death), bytes after the terminal,
    truncated preludes — refuses with the typed ``segment`` reason;
    none of them ever yields a partial decode."""
    segments = encode_export_chunks(
        [_synthetic_export(np.float32, seed=23)], max_wire_bytes=64
    )
    assert len(segments) >= 4
    body = b"".join(segments)

    def refused(buf):
        with pytest.raises(WireFormatError) as exc:
            decode_export_chunks(buf)
        assert exc.value.reason == WIRE_SEGMENT

    refused(b"".join(segments[:1] + segments[2:]))  # lost segment
    refused(b"".join([segments[1], segments[0]] + segments[2:]))
    flipped = bytearray(segments[1])
    flipped[SEGMENT_OVERHEAD] ^= 1  # payload bit
    refused(b"".join([segments[0], bytes(flipped)] + segments[2:]))
    bad_term = bytearray(segments[-1])
    bad_term[-1] ^= 1  # whole-stream CRC in the terminal
    refused(b"".join(segments[:-1] + [bytes(bad_term)]))
    refused(b"".join(segments[:-1]))  # stream ends without terminal
    refused(body + segments[0])  # bytes after the terminal
    refused(body[:-1])  # truncated terminal prelude
    refused(body[:SEGMENT_OVERHEAD - 2])
    # a reassembler poisoned by damage refuses every further feed, and
    # an unterminated incremental stream refuses at close — the death
    # of the sender is never mistaken for a complete transfer
    asm = ChunkReassembler()
    asm.feed(segments[0])
    with pytest.raises(WireFormatError):
        asm.feed(segments[0])  # seq replay
    with pytest.raises(WireFormatError):
        asm.feed(segments[1])  # poisoned
    asm2 = ChunkReassembler()
    for seg in segments[:-1]:
        asm2.feed(seg)
    with pytest.raises(WireFormatError) as exc:
        asm2.close()
    assert exc.value.reason == WIRE_SEGMENT


def _mk_engine(model):
    return ServingEngine(
        model, n_slots=2, decode_steps_per_tick=1,
        scheduler=SchedulerConfig(max_prefills_per_tick=2),
        kv_block_tokens=4, prefix_cache_size=16, kv_radix_cache=True,
    )


def test_wire_preserves_version_skew_refusal():
    """A REAL engine export survives the wire bitwise (import verdict
    ``imported``), and a version-skewed export still refuses typed
    AFTER an encode/decode round trip."""
    model = GPTLM(tiny_test(), device="cpu", seed=11).eval()
    prompt = [int(t) for t in np.random.default_rng(11).integers(1, 256, 17)]
    a = _mk_engine(model)
    a.add_request(Request(request_id="mid", prompt=prompt, max_new_tokens=10))
    for _ in range(5):
        a.step()
    export = a.export_prefix("mid")
    assert export is not None and export.checksums

    b = _mk_engine(model)
    assert b.import_prefix(decode_export(encode_export(export))) == MIGRATE_IMPORTED

    skewed = dataclasses.replace(export, weights_version="v9")
    c = _mk_engine(model)
    assert c.import_prefix(decode_export(encode_export(skewed))) == MIGRATE_WEIGHTS_VERSION


# -- across the two packages --------------------------------------------------


@pytest.fixture(scope="module")
def jax_wire():
    """The JAX package's codec, export type, checksums and bfloat16."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from tpu_parallel.serving import cache_pool, kv_hierarchy, kv_wire

    return types.SimpleNamespace(wire=kv_wire, export=kv_hierarchy.KVPrefixExport,
                                 checksums=cache_pool.block_checksums,
                                 bf16=np.dtype(jnp.bfloat16))


def _pool_style_payload(seed, n_blocks=3, layers=2, bt=4, kv_heads=2, head_dim=8):
    """One seeded payload in the pool's exported layout (scanned: key,
    pos, value), as float32 values; positions int32."""
    rnd = np.random.default_rng(seed)
    payload = (n_blocks, layers, bt, kv_heads, head_dim)
    key = rnd.standard_normal(payload).astype(np.float32)
    value = rnd.standard_normal(payload).astype(np.float32)
    pos = np.arange(n_blocks * layers * bt, dtype=np.int32).reshape(n_blocks, layers, bt)
    tokens = tuple(int(t) for t in rnd.integers(1, 250, n_blocks * bt))
    return tokens, key, pos, value


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_frames_byte_identical_across_packages(jax_wire, dtype):
    """The same export built in each package from one seeded numpy payload:
    equal checksums, byte-identical frames, and each package decodes the
    other's frame back to the same bytes (the JAX side to its bfloat16
    dtype, the port to the tagged raw bits)."""
    tokens, key, pos, value = _pool_style_payload(7)
    if dtype == "bfloat16":
        port_kv = (_bf16_bits(key), _bf16_bits(value))
        jax_kv = (key.astype(jax_wire.bf16), value.astype(jax_wire.bf16))
        for p, j in zip(port_kv, jax_kv):
            np.testing.assert_array_equal(p.view(np.uint16), j.view(np.uint16))
    else:
        port_kv = jax_kv = (key, value)
    n = key.shape[0]
    meta = (("cached_key", key.shape[1:], dtype), ("cached_pos", pos.shape[1:], "int32"),
            ("cached_value", value.shape[1:], dtype))
    port_leaves = (port_kv[0], pos, port_kv[1])
    jax_leaves = (jax_kv[0], pos, jax_kv[1])
    assert block_checksums(list(port_leaves), n) == jax_wire.checksums(list(jax_leaves), n)
    fields = dict(tokens=tokens, length=len(tokens), block_tokens=4, weights_version="initial",
                  meta=meta)
    port_export = KVPrefixExport(**fields, leaves=port_leaves,
                                 checksums=block_checksums(list(port_leaves), n))
    jax_export = jax_wire.export(**fields, leaves=jax_leaves,
                                 checksums=jax_wire.checksums(list(jax_leaves), n))
    port_frame = encode_export(port_export)
    jax_frame = jax_wire.wire.encode_export(jax_export)
    assert port_frame == jax_frame
    # each side decodes the other's frame bitwise, dtype names included
    mine = decode_export(jax_frame)
    theirs = jax_wire.wire.decode_export(port_frame)
    for got, want in zip(mine.leaves, port_leaves):
        assert leaf_dtype_name(got) == leaf_dtype_name(want)
        assert got.shape == want.shape and got.tobytes() == want.tobytes()
    for got, want in zip(theirs.leaves, jax_leaves):
        assert got.dtype == want.dtype
        assert got.shape == want.shape and got.tobytes() == want.tobytes()
    assert mine.meta == theirs.meta == meta
    assert mine.checksums == theirs.checksums == port_export.checksums
    assert encode_export(mine) == jax_wire.wire.encode_export(theirs) == port_frame
    # multi-frame streams and chunk streams interoperate too
    stream = encode_exports([port_export, port_export])
    assert stream == jax_wire.wire.encode_exports([jax_export, jax_export])
    assert len(jax_wire.wire.decode_exports(stream)) == 2
    chunks = b"".join(jax_wire.wire.encode_export_chunks([jax_export], max_wire_bytes=256))
    assert [e.tokens for e in decode_export_chunks(chunks)] == [tokens]
