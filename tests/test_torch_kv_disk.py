"""Port parity for the disk KV tier (``serving/kv_disk.py``): every case of
``tests/test_kv_disk.py`` re-run against the port (the blob store and its
journal-backed manifest, the hierarchy's disk spill / hydrate path with a
fake pool, the disk breaker, restart seeding, the three-tier conservation
storm, and the engine's knobs and warm restart), and the cross-package
contract: a disk directory written by either package's engine boots the
other's (manifest fold, seeded chains, then a warm-restart hit with equal
greedy tokens).

Engine cases run ``tiny_test`` in fp32 on the CPU; the cross-package ones
bridge one flax init into the port.  The JAX side is imported inside a
fixture.
"""

import os
import shutil
import types

import numpy as np
import pytest

from tpu_parallel_torch.daemon.journal import (
    CORRUPT_CRC,
    CORRUPT_GARBAGE,
    CORRUPT_SEQ,
    ROTATE_SUFFIX,
)
from tpu_parallel_torch.models import GPTLM, tiny_test
from tpu_parallel_torch.serving import (
    FINISHED,
    BlockAllocator,
    KVIntegrityError,
    Request,
    SchedulerConfig,
    ServingEngine,
    block_checksums,
)
from tpu_parallel_torch.serving.kv_disk import (
    DISK_CAPACITY,
    DISK_MISSING,
    DISK_REASONS,
    DISK_WEIGHTS,
    MANIFEST_NAME,
    KVDiskError,
    KVDiskStore,
)
from tpu_parallel_torch.serving.kv_hierarchy import (
    KVPrefixExport,
    RadixPrefixCache,
)
from tpu_parallel_torch.serving.kv_wire import WIRE_REASONS

BT = 4  # block_tokens for the property suite (engine tests pick their own)

# the journal reader's typed mid-file damage vocabulary — what a
# manifest reset may legally be attributed to
_JOURNAL_REASONS = (CORRUPT_GARBAGE, CORRUPT_CRC, CORRUPT_SEQ)


class _FakePool:
    """The pool surface the hierarchy consumes (see
    ``tests/test_kv_hierarchy.py``), plus ``export_meta`` — the disk
    spill path stamps it into every blob frame."""

    def __init__(self, n_blocks, block_tokens=BT):
        self.allocator = BlockAllocator(n_blocks)
        self.block_tokens = block_tokens
        self.bytes_per_block = 64
        self.content = {}  # block id -> np payload row [1, BT]

    def blocks_available(self):
        return self.allocator.n_free

    def pin_blocks(self, blocks):
        for b in blocks:
            self.allocator.share(int(b))

    def free_stored(self, blocks):
        for b in blocks:
            if self.allocator.free(int(b)):
                self.content.pop(int(b), None)

    def export_blocks(self, blocks):
        return [
            np.concatenate([self.content[int(b)] for b in blocks], axis=0)
        ]

    @property
    def export_meta(self):
        return (("k", (1, BT), "int64"),)

    def import_stored(self, rows, count, checksums=None):
        if count < 1:
            return ()
        if checksums is not None:
            got = block_checksums(rows, count)
            if got != tuple(int(c) for c in checksums[:count]):
                raise KVIntegrityError(
                    "fake pool: import failed its checksum"
                )
        if self.blocks_available() < count:
            return None
        blocks = tuple(self.allocator.alloc() for _ in range(count))
        for i, b in enumerate(blocks):
            self.content[b] = rows[0][i : i + 1].copy()
        return blocks

    def seed_block(self, payload_row):
        b = self.allocator.alloc()
        self.content[b] = payload_row
        return b


def _payload(run):
    """Canonical per-block payload — a pure function of the token run,
    so any byte that ever serves can be content-verified."""
    return np.asarray(run, np.int64).reshape(1, -1) * 7 + 3


def _export(run, wv="initial"):
    """A standard single-block frame for ``run`` — the disk tier's
    exchange unit."""
    rows = [_payload(run)]
    crc = block_checksums(rows, 1)[0]
    return KVPrefixExport(
        tokens=tuple(run),
        length=BT,
        block_tokens=BT,
        weights_version=wv,
        meta=(("k", (1, BT), "int64"),),
        leaves=tuple(rows),
        checksums=(int(crc),),
    )


def _insert(pool, cache, tokens):
    """Mimic the engine's store path (see test_kv_hierarchy)."""
    n = len(tokens) // pool.block_tokens
    runs = [tuple(tokens[j * BT : (j + 1) * BT]) for j in range(n)]
    slot_blocks = [pool.seed_block(_payload(r)) for r in runs]
    pool.pin_blocks(slot_blocks)
    dupes = cache.insert(tokens[: n * BT], slot_blocks)
    pool.free_stored(dupes)
    pool.free_stored(slot_blocks)


def _tiers_consistent(pool, cache, held=0):
    """The three-tier conservation audit: allocator refcounts match
    tree-held device refs, host payload count matches the host tally,
    and every store-resident blob is referenced by exactly one node."""
    tree_refs = sum(1 for n in cache._walk() if n.block is not None)
    total = int(pool.allocator._ref.sum())
    assert total == tree_refs + held, (
        f"refcount conservation broken: allocator {total} != "
        f"tree {tree_refs} + held {held}"
    )
    pool.allocator.check()
    host_nodes = sum(1 for n in cache._walk() if n.host is not None)
    assert host_nodes == cache.host_blocks_in_use
    if cache.disk is not None:
        refs = [n.disk for n in cache._walk() if n.disk is not None]
        assert len(refs) == len(set(refs)) == cache.disk.blocks_in_use
        for blob in refs:
            assert blob in cache.disk


def _hit_payload_ok(pool, cache, tokens, expect_blocks=None):
    """Probe ``tokens`` and content-verify every returned block."""
    got = cache.lookup(list(tokens) + [9])
    if got is None:
        return None
    blocks, length = got
    if expect_blocks is not None:
        assert length == expect_blocks * BT
    for j, b in enumerate(blocks):
        run = tokens[j * BT : (j + 1) * BT]
        assert np.array_equal(pool.content[int(b)], _payload(run)), (
            f"block {b} served wrong bytes for run {run}"
        )
    return length


# -- store: roundtrip, validation, restart fold -------------------------------


def test_disk_reason_vocabulary_pinned():
    """The typed failure vocabulary is load-bearing (breaker
    accounting, bench rot-leg audits, docs/11) — pin it exactly."""
    assert DISK_REASONS == WIRE_REASONS + (
        "io_error",
        "enospc",
        "missing_blob",
        "weights_version",
        "capacity",
        "manifest_corrupt",
    )
    with pytest.raises(AssertionError):
        KVDiskError("not_a_reason", "x")


def test_put_load_roundtrip_and_restart_fold(tmp_path):
    root = str(tmp_path / "kv")
    store = KVDiskStore(root, lambda: 0.0, capacity_blocks=8)
    run_a, run_b = (1, 2, 3, 4), (5, 6, 7, 8)
    blob_a = store.put(_export(run_a), chain_tokens=run_a)
    blob_b = store.put(_export(run_b), chain_tokens=run_a + run_b)
    assert store.blocks_in_use == 2
    assert store.payload_bytes > 0
    got = store.load(blob_b)
    assert got.tokens == run_b
    assert np.array_equal(got.leaves[0], _payload(run_b))
    store.close()
    # restart: the manifest alone rebuilds the entry set
    again = KVDiskStore(root, lambda: 0.0, capacity_blocks=8)
    assert again.manifest_reset_reason is None
    assert {e.blob for e in again.entries()} == {blob_a, blob_b}
    # shortest chain first — the order restart seeding needs
    assert [e.tokens for e in again.entries()] == [
        run_a, run_a + run_b,
    ]
    got = again.load(blob_a)
    assert np.array_equal(got.leaves[0], _payload(run_a))
    assert again.manifest_age_seconds() >= 0.0
    again.close()


def test_put_validation_and_typed_capacity(tmp_path):
    store = KVDiskStore(
        str(tmp_path / "kv"), lambda: 0.0, capacity_blocks=1
    )
    run = (1, 2, 3, 4)
    with pytest.raises(ValueError):
        store.put(_export(run), chain_tokens=run[:2])  # not a multiple
    with pytest.raises(ValueError):
        store.put(_export(run), chain_tokens=(9, 9, 9, 9))  # wrong tail
    bad = _export(run)
    bad = KVPrefixExport(
        tokens=bad.tokens, length=bad.length,
        block_tokens=bad.block_tokens,
        weights_version=bad.weights_version, meta=bad.meta,
        leaves=bad.leaves, checksums=(),
    )
    with pytest.raises(ValueError):
        store.put(bad, chain_tokens=run)  # unchecksummed
    store.put(_export(run), chain_tokens=run)
    with pytest.raises(KVDiskError) as err:
        store.put(_export((5, 6, 7, 8)), chain_tokens=(5, 6, 7, 8))
    assert err.value.reason == DISK_CAPACITY
    with pytest.raises(KVDiskError) as err:
        store.load(999)
    assert err.value.reason == DISK_MISSING
    store.close()


def test_boot_sweep_reconciles_both_directions(tmp_path):
    """A blob without a record (torn put) is swept; a record without a
    blob (torn delete) drops its entry and re-truthifies the
    manifest."""
    root = str(tmp_path / "kv")
    store = KVDiskStore(root, lambda: 0.0, capacity_blocks=8)
    run = (1, 2, 3, 4)
    blob = store.put(_export(run), chain_tokens=run)
    store.close()
    # torn put: durable blob bytes, no manifest record
    with open(os.path.join(root, "b77.kvw"), "wb") as fh:
        fh.write(b"orphan")
    # torn delete: manifest record, blob bytes gone
    os.remove(os.path.join(root, f"b{blob}.kvw"))
    again = KVDiskStore(root, lambda: 0.0, capacity_blocks=8)
    assert again.blocks_in_use == 0
    assert again.swept_blobs == 2
    assert not os.path.exists(os.path.join(root, "b77.kvw"))
    again.close()
    # the kv_del it appended makes the NEXT boot clean too
    third = KVDiskStore(root, lambda: 0.0, capacity_blocks=8)
    assert third.blocks_in_use == 0 and third.swept_blobs == 0
    third.close()


# -- manifest lifecycle: compaction crashes, torn tail, bit rot ---------------


def test_crash_during_compaction_both_sides(tmp_path):
    """Crash-safety at both ends of the atomic replace: an orphan
    ``.compact`` sidecar (crash BEFORE ``os.replace``) is discarded at
    the next boot with the old manifest authoritative; a completed
    rotation (crash AFTER) folds identically from the compacted file."""
    root = str(tmp_path / "kv")
    store = KVDiskStore(
        root, lambda: 0.0, capacity_blocks=16,
        compact_min_records=10_000,  # no auto-compaction mid-test
    )
    runs = [(i, i, i, i) for i in range(1, 6)]
    blobs = {store.put(_export(r), chain_tokens=r): r for r in runs}
    store.delete(next(iter(blobs)))
    live = {b for b in blobs if b in store}
    store.close()
    # side 1: a half-written sidecar never becomes the journal
    sidecar = os.path.join(root, MANIFEST_NAME + ROTATE_SUFFIX)
    with open(sidecar, "w") as fh:
        fh.write('{"record": "kv_put", "blob": 999, "tok')
    again = KVDiskStore(root, lambda: 0.0, capacity_blocks=16)
    assert not os.path.exists(sidecar)
    assert {e.blob for e in again.entries()} == live
    # side 2: rotation completed — the compacted file is authoritative
    # and carries O(live) records
    again.compact()
    assert again.manifest_compactions == 1
    again.close()
    third = KVDiskStore(root, lambda: 0.0, capacity_blocks=16)
    assert {e.blob for e in third.entries()} == live
    for blob in live:
        got = third.load(blob)
        assert np.array_equal(got.leaves[0], _payload(blobs[blob]))
    third.close()


def test_manifest_torn_tail_tolerated(tmp_path):
    """A torn final append (the crash-mid-write shape) truncates; the
    records before it fold untouched — no reset, no orphaned blobs for
    recorded entries."""
    root = str(tmp_path / "kv")
    store = KVDiskStore(root, lambda: 0.0, capacity_blocks=8)
    run = (1, 2, 3, 4)
    blob = store.put(_export(run), chain_tokens=run)
    store.close()
    path = os.path.join(root, MANIFEST_NAME)
    with open(path, "a") as fh:
        fh.write('{"record": "kv_put", "blob": 2, "tokens": [5')
    again = KVDiskStore(root, lambda: 0.0, capacity_blocks=8)
    assert again.manifest_reset_reason is None
    assert {e.blob for e in again.entries()} == {blob}
    assert np.array_equal(again.load(blob).leaves[0], _payload(run))
    again.close()


def test_manifest_bitflip_sweep_every_corruption_typed(tmp_path):
    """Seeded single-bit rot swept across the manifest: every outcome
    is either a bitwise-identical fold, a (sub)set of the original
    entries (tail tolerance / swept records), or a TYPED reset whose
    reason is in the journal's pinned vocabulary — never a silently
    mutated entry."""
    root = str(tmp_path / "kv")
    store = KVDiskStore(
        root, lambda: 0.0, capacity_blocks=16,
        compact_min_records=10_000,
    )
    runs = [(i, i + 1, i + 2, i + 3) for i in range(1, 5)]
    original = {}
    for r in runs:
        original[store.put(_export(r), chain_tokens=r)] = r
    store.close()
    manifest = os.path.join(root, MANIFEST_NAME)
    with open(manifest, "rb") as fh:
        pristine = fh.read()
    rnd = np.random.RandomState(18)
    bits = sorted(
        int(b) for b in rnd.choice(len(pristine) * 8, 24, replace=False)
    )
    for bit in bits:
        trial = str(tmp_path / f"flip{bit}")
        shutil.copytree(root, trial)
        rotted = bytearray(pristine)
        rotted[bit // 8] ^= 1 << (bit % 8)
        with open(os.path.join(trial, MANIFEST_NAME), "wb") as fh:
            fh.write(bytes(rotted))
        got = KVDiskStore(trial, lambda: 0.0, capacity_blocks=16)
        if got.manifest_reset_reason is not None:
            assert got.manifest_reset_reason in _JOURNAL_REASONS, bit
            assert got.blocks_in_use == 0  # untrustworthy index: empty
        for e in got.entries():
            # any surviving entry is EXACTLY an original one — and its
            # blob still round-trips bitwise
            assert e.blob in original, f"bit {bit} invented blob {e.blob}"
            assert e.tokens == original[e.blob], f"bit {bit} mutated"
            assert np.array_equal(
                got.load(e.blob).leaves[0], _payload(e.tokens)
            )
        got.close()


# -- hierarchy: spill cascade, hydration, typed drops, breaker ----------------


def _spill_cascade(tmp_path, n_chains=4, **cache_kw):
    """Drive distinct 2-block chains through a 2-device/2-host budget so
    the cold ones cascade down to disk; every chain is hit once (only
    warm blocks spill).  Returns (pool, cache, store, chains)."""
    pool = _FakePool(64)
    store = KVDiskStore(
        str(tmp_path / "kv"), lambda: 0.0, capacity_blocks=32
    )
    kw = dict(
        max_device_blocks=2, host_capacity_blocks=2, disk_store=store
    )
    kw.update(cache_kw)
    cache = RadixPrefixCache(pool, **kw)
    chains = [
        tuple([10 * i + d for d in range(1, 5)] * 2)
        for i in range(1, n_chains + 1)
    ]
    for c in chains:
        _insert(pool, cache, list(c))
        assert _hit_payload_ok(pool, cache, c) is not None
        _tiers_consistent(pool, cache)
    return pool, cache, store, chains


def test_three_tier_spill_and_hydrate_bitwise(tmp_path):
    """The cascade spills cold chains device->host->disk (prefix-
    closed); revisiting a disk-resident chain hydrates disk->host->
    device and every served byte is the canonical payload — zero
    recompute observed as typed-failure-free restores."""
    pool, cache, store, chains = _spill_cascade(tmp_path)
    assert cache.disk_spills > 0, "no chain ever reached the disk tier"
    assert store.blocks_in_use == cache.disk_blocks_in_use > 0
    assert cache.disk_bytes > 0
    # the oldest chain is disk-resident by now: revisit it
    length = _hit_payload_ok(pool, cache, chains[0])
    assert length is not None and length > 0
    assert cache.disk_restores > 0, "revisit never hydrated from disk"
    assert cache.disk_restore_failures == 0
    assert cache.disk_failure_reasons == {}
    _tiers_consistent(pool, cache)
    # inclusive retention: hydrated nodes keep their blob — the next
    # spill of the same chain writes nothing new
    spills = cache.disk_spills
    promoted = [n for n in cache._walk() if n.block is not None and
                n.disk is not None]
    assert promoted, "promotion dropped the disk copy"
    store.close()


def test_blob_rot_typed_drop_leading_run_restores(tmp_path):
    """A rotted blob mid-chain: hydration refuses TYPED at the rotted
    node, drops its (unreachable) subtree, and the verified leading run
    still restores — corrupted bytes never serve."""
    pool, cache, store, chains = _spill_cascade(tmp_path)
    victim_chain = chains[0]
    nodes = []
    cur = cache._root
    for j in range(2):
        cur = cur.children.get(victim_chain[j * BT : (j + 1) * BT])
        assert cur is not None and cur.disk is not None
        nodes.append(cur)
    # rot the SECOND block's blob on the media
    path = os.path.join(store.root, f"b{nodes[1].disk}.kvw")
    with open(path, "r+b") as fh:
        fh.seek(os.path.getsize(path) // 2)
        byte = fh.read(1)
        fh.seek(-1, os.SEEK_CUR)
        fh.write(bytes([byte[0] ^ 0x10]))
    length = _hit_payload_ok(pool, cache, victim_chain)
    assert length == BT, "verified leading run must still restore"
    assert cache.disk_restores >= 1
    assert cache.disk_restore_failures == 1
    assert sum(cache.disk_failure_reasons.values()) == 1
    (reason,) = cache.disk_failure_reasons
    assert reason in DISK_REASONS
    # the rotted node's subtree is gone from tree AND manifest
    assert nodes[1].disk is None or nodes[1].parent is None
    sub = cache._root.children[victim_chain[:BT]].children
    assert victim_chain[BT:] not in sub
    _tiers_consistent(pool, cache)
    store.close()


def test_disk_breaker_ram_device_only_stays_bitwise(tmp_path):
    """K consecutive typed hydrate failures trip the disk breaker:
    disk drops out of the path, RAM+device serving continues bitwise,
    the half-open window admits exactly one probe, and a failed probe
    re-arms."""
    pool, cache, store, chains = _spill_cascade(
        tmp_path, n_chains=5,
        breaker_failures=2, breaker_probe_ops=4,
    )
    # every disk blob's media dies (files vanish: typed missing_blob)
    disk_nodes = [n for n in cache._walk()
                  if n.disk is not None and n.block is None
                  and n.host is None]
    assert len(disk_nodes) >= 2
    for name in os.listdir(store.root):
        if name.endswith(".kvw"):
            os.remove(os.path.join(store.root, name))
    failures = 0
    for c in chains:
        before = cache.disk_restore_failures
        cache.lookup(list(c) + [9])
        failures += cache.disk_restore_failures - before
        if cache.disk_breaker_state == 1:
            break
    assert cache.disk_breaker_state == 1
    assert cache.disk_breaker_trips == 1
    assert failures >= 2
    assert cache.disk_failure_reasons.get(DISK_MISSING, 0) >= 2
    # RAM+device-only serving: the hottest chain still hits bitwise,
    # and no disk op fires while the breaker is open
    loads_down = store.loads
    resident = next(
        c for c in chains
        if cache.covers(list(c), BT)
    )
    assert _hit_payload_ok(pool, cache, resident) is not None
    assert store.loads == loads_down
    # half-open: after the probe window, exactly ONE blob is probed;
    # the still-dead media fails it typed and re-arms the window
    while cache.disk_breaker_state != 2:
        cache.lookup([3, 3, 3, 3, 3])
    survivor = next(
        (n for n in cache._walk()
         if n.disk is not None and n.block is None and n.host is None),
        None,
    )
    if survivor is not None:
        fails = cache.disk_restore_failures
        chain = []
        cur = survivor
        while cur.run is not None:
            chain = list(cur.run) + chain
            cur = cur.parent
        cache.lookup(chain + [9])
        assert cache.disk_restore_failures == fails + 1
        assert cache.disk_breaker_state == 1, "failed probe must re-arm"
    _tiers_consistent(pool, cache)
    store.close()


def test_restart_warm_start_bitwise(tmp_path):
    """Kill the process (close the store), reopen the same directory:
    the manifest seeds the tree's disk chains, and the first lookup
    hydrates them bitwise — the restart-surviving-prefix-cache
    acceptance shape at property scale."""
    pool, cache, store, chains = _spill_cascade(tmp_path)
    disk_chains = [
        c for c in chains
        if (n := cache._root.children.get(c[:BT])) is not None
        and n.disk is not None
    ]
    assert disk_chains, "cascade left nothing on disk"
    store.close()
    # a new process: fresh pool, fresh tree, same directory
    pool2 = _FakePool(64)
    store2 = KVDiskStore(
        str(tmp_path / "kv"), lambda: 0.0, capacity_blocks=32
    )
    cache2 = RadixPrefixCache(
        pool2, max_device_blocks=8, host_capacity_blocks=8,
        disk_store=store2,
    )
    assert cache2.disk_seeded_blocks > 0
    assert cache2.disk_seeded_chains > 0
    assert cache2.disk_orphans_dropped == 0
    _tiers_consistent(pool2, cache2)
    for c in disk_chains:
        length = _hit_payload_ok(pool2, cache2, c)
        assert length is not None, f"seeded chain {c[:4]}... missed"
    assert cache2.disk_restores >= len(disk_chains)
    assert cache2.disk_restore_failures == 0
    _tiers_consistent(pool2, cache2)
    store2.close()


def test_restart_drops_weights_version_orphans_typed(tmp_path):
    """Seeding refuses chains from another weight set (typed, blob
    deleted) — a restarted daemon that rebound weights cannot serve
    stale K/V."""
    pool, cache, store, chains = _spill_cascade(tmp_path)
    n_disk = store.blocks_in_use
    assert n_disk > 0
    store.close()
    store2 = KVDiskStore(
        str(tmp_path / "kv"), lambda: 0.0, capacity_blocks=32
    )
    cache2 = RadixPrefixCache(
        _FakePool(64), max_device_blocks=8, host_capacity_blocks=8,
        disk_store=store2, weights_version="rebound-v2",
    )
    assert cache2.disk_seeded_blocks == 0
    assert cache2.disk_orphans_dropped == n_disk
    assert cache2.disk_failure_reasons.get(DISK_WEIGHTS, 0) == n_disk
    assert store2.blocks_in_use == 0
    store2.close()


def test_conservation_storm_across_three_tiers(tmp_path):
    """Randomized op storm (insert / lookup / pop_lru) over tight
    device+host+disk budgets: the conservation audit holds after every
    op, every hit serves canonical bytes, and every typed failure is in
    the pinned vocabulary."""
    rnd = np.random.RandomState(7)
    pool = _FakePool(96)
    store = KVDiskStore(
        str(tmp_path / "kv"), lambda: 0.0, capacity_blocks=6,
        compact_min_records=16, compact_factor=2,
    )
    cache = RadixPrefixCache(
        pool, max_device_blocks=3, host_capacity_blocks=2,
        disk_store=store,
    )
    vocab = 6
    for step in range(250):
        op = rnd.rand()
        toks = [int(t) for t in rnd.randint(1, vocab, rnd.randint(4, 16))]
        if op < 0.45:
            full = (len(toks) // BT) * BT
            if full:
                _insert(pool, cache, toks[:full])
        elif op < 0.9:
            _hit_payload_ok(pool, cache, tuple(toks))
        else:
            cache.pop_lru()
        _tiers_consistent(pool, cache)
    for reason in cache.disk_failure_reasons:
        assert reason in DISK_REASONS
    assert store.manifest_records > 0
    store.close()


# -- engine level ---------------------------------------------------------------


@pytest.fixture(scope="module")
def model():
    return GPTLM(tiny_test(), device="cpu", seed=18).eval()


def test_engine_disk_knob_validation(model):
    kw = dict(n_slots=2, kv_block_tokens=4, prefix_cache_size=2, kv_radix_cache=True)
    with pytest.raises(ValueError):
        ServingEngine(model, kv_disk_blocks=-1, **kw)
    with pytest.raises(ValueError):
        ServingEngine(model, kv_disk_dir="/tmp/x", kv_host_blocks=8, **kw)
    with pytest.raises(ValueError):
        ServingEngine(model, kv_disk_blocks=8, kv_host_blocks=8, **kw)
    with pytest.raises(ValueError):
        ServingEngine(model, kv_disk_dir="/tmp/x", kv_disk_blocks=8, **kw)


def _headers(seed=5, vocab=256):
    rnd = np.random.RandomState(seed)
    return [[int(t) for t in rnd.randint(1, vocab, 8)] for _ in range(4)]


def _build(make, api, disk_dir):
    return make(n_slots=2, decode_steps_per_tick=1,
                scheduler=api.SchedulerConfig(max_prefills_per_tick=2),
                kv_block_tokens=4, prefix_cache_size=2, kv_host_blocks=2, kv_radix_cache=True,
                kv_disk_dir=disk_dir, kv_disk_blocks=32)


def _go(eng, api, h, tag):
    out = eng.add_request(api.Request(request_id=tag, prompt=h + [7, 9], max_new_tokens=4))
    eng.run(max_ticks=200)
    assert out.status == FINISHED
    return list(out.tokens)


def _fill(eng, api):
    """Warm every header (first visit, then a hit) so evictions spill down
    the tiers to disk; returns the first visits' tokens."""
    first = []
    for i, h in enumerate(_headers()):
        first.append(_go(eng, api, h, f"a{i}"))
        _go(eng, api, h, f"w{i}")
    assert eng._radix.disk_spills > 0, "cascade never reached disk"
    assert eng._radix.disk_restore_failures == 0
    return first


def test_engine_disk_warm_restart_bitwise(model, tmp_path):
    """A tight hierarchy spills warm prefixes to disk; a NEW engine on the
    same directory seeds them from the manifest, the replayed requests
    hydrate (>= 1 disk restore, zero failures) and continue bitwise; the
    metrics summary carries the ``kv_disk_*`` rows."""
    import tpu_parallel_torch.serving as api

    disk_dir = str(tmp_path / "kvdisk")
    make = lambda **kw: ServingEngine(model, **kw)  # noqa: E731
    eng = _build(make, api, disk_dir)
    first = _fill(eng, api)
    s = eng.metrics.summary()
    assert s["kv_disk_blocks"] > 0
    assert s["kv_disk_manifest_records"] > 0
    eng._radix.disk.close()

    eng2 = _build(make, api, disk_dir)
    assert eng2._radix.disk_seeded_blocks > 0, "manifest seeded nothing"
    restored = [_go(eng2, api, h, f"r{i}") for i, h in enumerate(_headers())]
    assert eng2._radix.disk_restores >= 1, "warm chain never hydrated"
    assert eng2._radix.disk_restore_failures == 0
    assert restored == first, "warm-restart continuation diverged"
    eng2.pool.allocator.check()
    s2 = eng2.metrics.summary()
    assert s2["kv_disk_seeded_blocks"] > 0
    assert s2["kv_disk_restores"] >= 1
    assert s2["kv_disk_restore_failures"] == 0
    eng2._radix.disk.close()


@pytest.fixture(scope="module")
def sides():
    """(JAX side, port side) on one flax init bridged into the port."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from tpu_parallel import serving as jserving
    from tpu_parallel.models import GPTLM as JaxGPTLM
    from tpu_parallel.models import tiny_test as jax_tiny_test
    from tpu_parallel_torch import serving as tserving
    from tpu_parallel_torch.models.convert import params_from_jax

    jm = JaxGPTLM(jax_tiny_test(dtype=jnp.float32, remat=False))
    params = jm.init({"params": jax.random.PRNGKey(1)}, jnp.zeros((1, 20), jnp.int32),
                     train=False)["params"]
    cfg = tiny_test()
    port = GPTLM(cfg, device="cpu")
    port.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), cfg))
    port.eval()
    return (types.SimpleNamespace(api=jserving,
                                  make=lambda **kw: jserving.ServingEngine(jm, params, **kw)),
            types.SimpleNamespace(api=tserving,
                                  make=lambda **kw: tserving.ServingEngine(port, **kw)))


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_disk_dir_boots_the_other_package(sides, tmp_path, direction):
    """A disk directory written by one package's engine boots the other's:
    the manifest folds into seeded chains (the same count the writer's own
    package seeds), and the replayed requests hydrate from disk with zero
    failures and the writer's greedy tokens."""
    jax_side, port_side = sides
    writer, reader = (jax_side, port_side) if direction == "jax_to_port" else (port_side,
                                                                              jax_side)
    disk_dir = str(tmp_path / "kvdisk")
    eng = _build(writer.make, writer.api, disk_dir)
    first = _fill(eng, writer.api)
    eng._radix.disk.close()
    shutil.copytree(disk_dir, str(tmp_path / "copy"))
    same = _build(writer.make, writer.api, str(tmp_path / "copy"))
    other = _build(reader.make, reader.api, disk_dir)
    assert other._radix.disk_seeded_blocks == same._radix.disk_seeded_blocks > 0
    assert other._radix.disk_seeded_chains == same._radix.disk_seeded_chains
    assert other._radix.disk_orphans_dropped == 0
    restored = [_go(other, reader.api, h, f"r{i}") for i, h in enumerate(_headers())]
    assert other._radix.disk_restores >= 1, "warm chain never hydrated"
    assert other._radix.disk_restore_failures == 0
    assert other._radix.hits > 0
    assert restored == first
    other.pool.allocator.check()
    other._radix.disk.close()
    same._radix.disk.close()
