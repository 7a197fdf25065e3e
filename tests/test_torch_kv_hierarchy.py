"""Port parity for the hierarchical KV memory (``serving/kv_hierarchy.py``)
and the pool's exchange half: the cases of ``tests/test_kv_hierarchy.py``
(all but the two that need the JAX package's cluster layer) re-run against
the port, and the cross-package contract.

- The radix property suite and the host-tier breaker cases run the port's
  ``RadixPrefixCache`` over a fake pool (no device), as the JAX tests do.
- Engine cases run ``tiny_test`` in fp32 on the CPU.  The JAX-parity ones
  bridge one flax init into the port (``params_from_jax``) and hold the
  port engine's greedy tokens and radix / host / disk counters EXACTLY
  equal to the JAX engine's with the same knobs, in per-step, fused
  (unified), chunked and overlapped modes, over scanned, GQA and unrolled
  configs; ``export_meta`` equals the JAX pool's.
- A prefix moves both ways: exported mid-flight by one package's engine,
  through the wire, imported into the other's (``"imported"``), the next
  admission hits and continues with the exporter's greedy tokens; the two
  packages' exports of the same request agree within atol = rtol = 1e-5
  (positions exactly).

The JAX side is imported inside fixtures.
"""

import dataclasses
import types

import numpy as np
import pytest

from tpu_parallel_torch.models import GPTLM, tiny_test
from tpu_parallel_torch.serving import (
    FINISHED,
    BlockAllocator,
    KVIntegrityError,
    Request,
    SchedulerConfig,
    ServingEngine,
    block_checksums,
    decode_export,
    encode_export,
)
from tpu_parallel_torch.serving.kv_hierarchy import (
    MIGRATE_IMPORTED,
    MIGRATE_INTEGRITY,
    MIGRATE_WEIGHTS_VERSION,
    RadixPrefixCache,
)

TOL = dict(atol=1e-5, rtol=1e-5)

BT = 4  # block_tokens for the property suite (engine tests pick their own)


class _FakePool:
    """The narrow pool surface RadixPrefixCache consumes, over a real
    :class:`BlockAllocator` and host-side block CONTENT (one payload row
    per block), so the property suite can audit refcount conservation
    and byte-exact spill/restore round-trips without touching a device.
    Content rows are written at import/alloc time and compared on every
    hit — a tree that ever returned the wrong block fails loudly."""

    def __init__(self, n_blocks, block_tokens=BT):
        self.allocator = BlockAllocator(n_blocks)
        self.block_tokens = block_tokens
        self.bytes_per_block = 64
        self.content = {}  # block id -> np payload row [1, 8]

    # admission entitlements don't exist here: available == free
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

    # test-side helpers ---------------------------------------------------
    def seed_block(self, payload_row):
        """Allocate a block holding ``payload_row`` (the 'slot prefill'
        write) — refcount 1 owned by the caller."""
        b = self.allocator.alloc()
        self.content[b] = payload_row
        return b


def _payload(run):
    """Canonical per-block payload: a pure function of the token run, so
    any block returned for a prefix can be content-verified."""
    return np.asarray(run, np.int64).reshape(1, -1) * 7 + 3


def _tree_refs(cache):
    """Device references the tree holds (one per resident node)."""
    return sum(1 for n in cache._walk() if n.block is not None)


def _conservation(pool, cache, held):
    """Σ allocator refcounts == tree-held refs + test-held refs — the
    load-bearing invariant after ANY op sequence."""
    total = int(pool.allocator._ref.sum())
    assert total == _tree_refs(cache) + held, (
        f"refcount conservation broken: allocator {total} != "
        f"tree {_tree_refs(cache)} + held {held}"
    )
    pool.allocator.check()


def _insert(pool, cache, tokens):
    """Mimic the engine's store path: 'prefill' blocks (alloc + content),
    snapshot-style handoff (pin), insert, release dupes and the slot's
    own refs.  Leaves exactly one tree-held ref per new node."""
    n = len(tokens) // pool.block_tokens
    runs = [
        tuple(tokens[j * BT : (j + 1) * BT]) for j in range(n)
    ]
    slot_blocks = [pool.seed_block(_payload(r)) for r in runs]
    pool.pin_blocks(slot_blocks)  # the handoff refs the tree may keep
    dupes = cache.insert(tokens[: n * BT], slot_blocks)
    pool.free_stored(dupes)
    pool.free_stored(slot_blocks)  # the 'slot' retires


def _oracle_lcp(stored, prompt):
    """Brute force: longest block-aligned common prefix of ``prompt``
    with any stored full-block prefix, capped strictly below the prompt
    length."""
    best = 0
    cap = (len(prompt) - 1) // BT
    for s in stored:
        k = 0
        while (
            k < cap
            and k < len(s) // BT
            and tuple(s[k * BT : (k + 1) * BT])
            == tuple(prompt[k * BT : (k + 1) * BT])
        ):
            k += 1
        best = max(best, k)
    return best * BT


def test_radix_matches_lcp_oracle_without_eviction():
    """With capacity ample enough that nothing evicts, lookup must equal
    the brute-force longest-common-prefix oracle on every probe — and
    every returned block's content must be the canonical payload for its
    token run (never someone else's K/V)."""
    rnd = np.random.RandomState(0)
    pool = _FakePool(512)
    cache = RadixPrefixCache(pool, max_device_blocks=512)
    stored = []
    vocab = 5  # tiny vocab: collisions and shared prefixes are common
    for step in range(300):
        toks = [int(t) for t in rnd.randint(1, vocab, rnd.randint(1, 20))]
        if rnd.rand() < 0.5:
            full = (len(toks) // BT) * BT
            if full:
                _insert(pool, cache, toks[:full])
                stored.append(tuple(toks[:full]))
        else:
            want = _oracle_lcp(stored, toks)
            hit = cache.lookup(toks)
            got = 0 if hit is None else hit[1]
            assert got == want, (
                f"step {step}: radix matched {got}, oracle says {want} "
                f"for {toks}"
            )
            if hit is not None:
                blocks, length = hit
                for j, b in enumerate(blocks):
                    np.testing.assert_array_equal(
                        pool.content[int(b)],
                        _payload(toks[j * BT : (j + 1) * BT]),
                        err_msg=f"step {step}: wrong block content",
                    )
        _conservation(pool, cache, held=0)
    assert cache.hits > 20 and cache.misses > 5  # both paths exercised


def test_radix_conservation_under_eviction_and_offload():
    """The evict/spill/restore storm: tight device budget, small host
    tier, random inserts and lookups.  After EVERY op: refcount
    conservation, budget bounds, and content-correct hits (a hit may
    cover less than the oracle under eviction — never more, and never
    wrong bytes).  The storm must actually exercise spill, restore,
    host eviction and the restore-fallback path."""
    rnd = np.random.RandomState(7)
    pool = _FakePool(24)
    cache = RadixPrefixCache(
        pool, max_device_blocks=6, host_capacity_blocks=4
    )
    stored = []
    vocab = 4
    held = 0
    pinned = []  # simulated live-slot refs on looked-up blocks
    for step in range(400):
        op = rnd.randint(4)
        if op == 0:
            toks = [
                int(t) for t in rnd.randint(1, vocab, rnd.randint(4, 16))
            ]
            full = (len(toks) // BT) * BT
            if full and pool.blocks_available() >= full // BT:
                _insert(pool, cache, toks[:full])
                stored.append(tuple(toks[:full]))
        elif op == 1 and stored:
            base = list(stored[rnd.randint(len(stored))])
            probe = base + [int(rnd.randint(1, vocab))]
            hit = cache.lookup(probe)
            if hit is not None:
                blocks, length = hit
                assert length <= _oracle_lcp(stored, probe) + 0, (
                    "matched beyond anything ever stored"
                )
                for j, b in enumerate(blocks):
                    np.testing.assert_array_equal(
                        pool.content[int(b)],
                        _payload(probe[j * BT : (j + 1) * BT]),
                    )
                # a live slot maps the hit (engine: map_prefix share)
                pool.pin_blocks(blocks)
                pinned.append(tuple(blocks))
                held += len(blocks)
        elif op == 2 and pinned:
            blocks = pinned.pop(rnd.randint(len(pinned)))
            pool.free_stored(blocks)  # the slot retires
            held -= len(blocks)
        else:
            cache.pop_lru()
        _conservation(pool, cache, held=held)
        assert cache.host_blocks_in_use <= cache.host_capacity
    assert cache.evictions > 0, "storm never evicted"
    assert cache.offloads > 0, "storm never spilled to host"
    assert cache.restored_blocks > 0, "storm never restored from host"
    assert cache.host_evictions > 0, "host tier never evicted"
    # full teardown: drop every pin, then evict the tree dry — the
    # allocator must come back to zero live blocks (no leak)
    for blocks in pinned:
        pool.free_stored(blocks)
    while cache.pop_lru():
        pass
    assert _tree_refs(cache) == 0
    pool.allocator.check()
    assert pool.allocator.in_use == 0


def test_radix_frequency_beats_pure_recency():
    """Frequency-aware eviction: a header hit many times survives
    pressure from a stream of newer one-shot inserts that pure LRU would
    have let evict it."""
    pool = _FakePool(64)
    cache = RadixPrefixCache(
        pool, max_device_blocks=3, hit_recency_bonus=8
    )
    hot = [1, 2, 3, 4]
    _insert(pool, cache, hot)
    for _ in range(6):
        assert cache.lookup(hot + [9]) is not None  # heat it up
    for i in range(5):  # colder one-shot inserts force evictions
        _insert(pool, cache, [5 + i, 6, 7, 8])
    hit = cache.lookup(hot + [9])
    assert hit is not None and hit[1] == BT, (
        "the frequently-hit header was evicted under one-shot pressure"
    )


def test_restore_integrity_failure_typed_and_dropped():
    """Checksum-failed host bytes NEVER restore: the corrupted node (and
    its unreachable subtree) drops, the verified leading run still
    restores, and the failure is typed-counted — the lookup falls back
    to recompute instead of serving rotted KV."""
    pool = _FakePool(16)
    cache = RadixPrefixCache(
        pool, max_device_blocks=2, host_capacity_blocks=4
    )
    toks = [1, 2, 3, 4, 2, 3, 4, 1]  # two blocks
    _insert(pool, cache, toks)
    assert cache.lookup(toks + [9]) is not None  # warm both nodes
    cache.pop_lru()
    cache.pop_lru()  # deepest-first: both spill
    assert cache.host_blocks_in_use == 2 and cache.offloads == 2
    # corrupt the DEEPER node's spilled bytes (one flipped value)
    deeper = next(
        n for n in cache._walk()
        if n.host is not None and n.run == tuple(toks[4:8])
    )
    deeper.host[0].flat[0] += 1
    hit = cache.lookup(toks + [9])
    # the verified first block restored; the corrupted one dropped and
    # its coverage falls back to recompute (shorter hit, never wrong)
    assert hit is not None and hit[1] == BT
    np.testing.assert_array_equal(
        pool.content[int(hit[0][0])], _payload(tuple(toks[:4]))
    )
    assert cache.integrity_failures == 1
    assert cache.host_blocks_in_use == 0  # corrupt copy gone for good
    _conservation(pool, cache, held=0)
    # corruption of the FIRST host node: zero restore, typed failure
    cache.pop_lru()  # spill the restored block again
    first = next(n for n in cache._walk() if n.host is not None)
    first.host[0].flat[0] += 1
    probes = cache.hits + cache.misses
    assert cache.lookup(toks[:4] + [9]) is None
    assert cache.misses == probes - cache.hits + 1
    assert cache.integrity_failures == 2
    assert cache.restore_failures == 1
    _conservation(pool, cache, held=0)
    pool.allocator.check()


def test_host_tier_breaker_opens_and_half_open_reprobes():
    """K consecutive restore failures take the offload tier DOWN (no
    restores, no new spills — device-only serving continues); after the
    probe window the next host hit is a half-open PROBE whose success
    closes the breaker and restores the tier."""
    pool = _FakePool(8)
    cache = RadixPrefixCache(
        pool, max_device_blocks=2, host_capacity_blocks=4,
        breaker_failures=2, breaker_probe_ops=8,
    )
    hot = [1, 2, 3, 4]
    _insert(pool, cache, hot)
    assert cache.lookup(hot + [9]) is not None  # warm it
    assert cache.pop_lru()  # spills (warm + tier up)
    assert cache.offloads == 1 and cache.host_blocks_in_use == 1
    # exhaust the free list so restores fail typed (no blocks)
    held = [pool.seed_block(_payload((0, 0, 0, 0)))
            for _ in range(pool.allocator.n_free)]
    assert pool.blocks_available() == 0
    for _ in range(2):
        assert cache.lookup(hot + [9]) is None
    assert cache.restore_failures == 2
    assert not cache.host_tier_up
    assert cache.breaker_trips == 1 and cache.breaker_state == 1
    # while OPEN: no restore attempts (no new typed failures burned),
    # and evictions stop spilling
    rf = cache.restore_failures
    assert cache.lookup(hot + [9]) is None
    assert cache.restore_failures == rf
    pool.free_stored(held)  # pressure gone — the breaker stays open
    _insert(pool, cache, [5, 6, 7, 8])
    assert cache.lookup([5, 6, 7, 8, 9]) is not None  # warm it
    assert cache.breaker_state == 1
    offs = cache.offloads
    while cache.device_blocks > 0:
        cache.pop_lru()
    assert cache.offloads == offs, "spilled while the breaker was open"
    # the op clock advances into the half-open probe window
    while cache.breaker_state != 2:
        cache.lookup([7, 7, 7, 7, 7])
    hit = cache.lookup(hot + [9])  # the half-open probe
    assert hit is not None and hit[1] == BT
    assert cache.host_tier_up and cache.breaker_state == 0
    assert cache.restored_blocks == 1
    np.testing.assert_array_equal(
        pool.content[int(hit[0][0])], _payload(tuple(hot))
    )
    # the recovered tier spills again
    assert cache.pop_lru()
    assert cache.offloads == offs + 1
    _conservation(pool, cache, held=0)


def test_failed_probe_rearms_breaker():
    """A half-open probe that FAILS (the host copy rotted while the
    tier was down) re-arms the open breaker instead of closing it."""
    pool = _FakePool(8)
    cache = RadixPrefixCache(
        pool, max_device_blocks=2, host_capacity_blocks=4,
        breaker_failures=1, breaker_probe_ops=2,
    )
    hot = [1, 2, 3, 4]
    _insert(pool, cache, hot)
    assert cache.lookup(hot + [9]) is not None
    assert cache.pop_lru()
    held = [pool.seed_block(_payload((0, 0, 0, 0)))
            for _ in range(pool.allocator.n_free)]
    assert cache.lookup(hot + [9]) is None  # 1 failure: trips at K=1
    assert cache.breaker_state == 1
    node = next(n for n in cache._walk() if n.host is not None)
    node.host[0].flat[0] += 1  # rot while down
    while cache.breaker_state != 2:
        cache.lookup([7, 7, 7, 7, 7])
    trips_rf = cache.restore_failures
    assert cache.lookup(hot + [9]) is None  # the probe fails typed
    assert cache.integrity_failures == 1
    assert cache.restore_failures == trips_rf + 1
    assert cache.breaker_state == 1, "failed probe must re-arm"
    pool.free_stored(held)
    _conservation(pool, cache, held=0)


# -- engine level: the port alone ----------------------------------------------


def _prompts():
    rs = np.random.default_rng(11)
    shared = [int(t) for t in rs.integers(1, 256, 20)]
    return [shared[:9], shared[:17] + [3, 1, 4], shared[:17] + [5, 9],
            [5, 3, 2, 9, 1, 4]]


@pytest.fixture(scope="module")
def model():
    return GPTLM(tiny_test(), device="cpu", seed=1).eval()


def _go(eng, api, prompt, tag, n_new=4, overlap=False):
    out = eng.add_request(api.Request(request_id=tag, prompt=prompt, max_new_tokens=n_new))
    eng.run(max_ticks=200, overlap=overlap)
    assert out.status == FINISHED
    return list(out.tokens)


def _tight(model, **kw):
    """The JAX tests' tight hierarchy: 2 slots, 4-token blocks, a device
    budget of 2 blocks over a 16-block host tier."""
    kw = dict(dict(decode_steps_per_tick=1), **kw)
    return ServingEngine(
        model, n_slots=2, scheduler=SchedulerConfig(max_prefills_per_tick=2),
        kv_block_tokens=4, prefix_cache_size=2, kv_host_blocks=16, kv_radix_cache=True, **kw)


def _headers(seed, n=4):
    rnd = np.random.RandomState(seed)
    return [[int(t) for t in rnd.randint(1, 256, 8)] for _ in range(n)]


def test_radix_host_offload_restore_bitwise(model):
    """Warm-tier round trip: a device budget of 2 blocks forces every
    earlier tenant to spill; re-requesting it restores through the pool's
    import and the continuation is bitwise identical (zero restore
    failures, a counted hit).  Each header is hit once before the pressure
    arrives: only evicted-but-WARM blocks spill."""
    import tpu_parallel_torch.serving as api

    headers = _headers(3)
    eng = _tight(model)
    first = []
    for i, h in enumerate(headers):
        first.append(_go(eng, api, h + [7, 9], f"a{i}"))
        _go(eng, api, h + [7, 9], f"w{i}")
    assert eng._radix.offloads > 0, "no spill under a 2-block budget"
    hits0 = eng._radix.hits
    again = _go(eng, api, headers[0] + [7, 9], "b0")
    assert eng._radix.restored_blocks > 0, "revisit never restored"
    assert eng._radix.restore_failures == 0
    assert eng._radix.hits > hits0
    assert again == first[0], "restored continuation diverged"
    eng.pool.allocator.check()
    s = eng.metrics.summary()
    assert s["kv_host_restored_blocks"] > 0
    assert s["kv_host_restore_failures"] == 0
    assert s["prefix_hit_rate"] > 0


def _mk(model):
    return ServingEngine(
        model, n_slots=2, decode_steps_per_tick=1,
        scheduler=SchedulerConfig(max_prefills_per_tick=2),
        kv_block_tokens=4, prefix_cache_size=16, kv_radix_cache=True,
    )


def test_export_import_prefix_roundtrip(model):
    """The migration primitive alone: export a mid-flight request's blocks
    from engine A, import into engine B, and B's forced-prefix
    continuation HITS and matches A's uninterrupted generation bitwise.  A
    cross-version import refuses typed."""
    prompt = _prompts()[1]
    base_eng = _mk(model)
    base = base_eng.add_request(Request(request_id="base", prompt=prompt, max_new_tokens=10))
    base_eng.run(max_ticks=200)
    ref = list(base.tokens)

    a = _mk(model)
    out = a.add_request(Request(request_id="mid", prompt=prompt, max_new_tokens=10))
    for _ in range(5):  # partway through decode
        a.step()
    assert out.status == "running" and len(out.tokens) >= 2
    export = a.export_prefix("mid")
    assert export is not None and export.n_blocks >= 2
    delivered = list(out.tokens)

    b = _mk(model)
    assert b.import_prefix(export) == MIGRATE_IMPORTED
    hits0 = b._radix.hits
    cont = b.add_request(Request(request_id="cont", prompt=list(prompt) + delivered,
                                 max_new_tokens=10 - len(delivered)))
    b.run(max_ticks=200)
    assert cont.status == FINISHED
    assert delivered + list(cont.tokens) == ref, (
        "migrated continuation diverged from the uninterrupted baseline")
    assert b._radix.hits > hits0, "the import never produced a hit"
    b.pool.allocator.check()

    c = _mk(model)
    c.weights_version = "v2"
    assert c.import_prefix(export) == MIGRATE_WEIGHTS_VERSION


def test_breaker_engine_level_device_only_bitwise(model):
    """K consecutive checksum-failed restores disable the offload tier on
    a LIVE engine; serving continues BITWISE (recompute) against the
    tier-up outputs; after the probe window a fresh spill + restore closes
    the breaker again."""
    import tpu_parallel_torch.serving as api

    headers = _headers(11)
    eng = _tight(model)
    radix = eng._radix
    radix.breaker_failures = 2
    radix.breaker_probe_ops = 4

    def go(h, tag):
        return _go(eng, api, h + [7, 9], tag)

    first = []
    for i, h in enumerate(headers[:3]):
        first.append(go(h, f"a{i}"))
        go(h, f"w{i}")
    assert radix.offloads > 0
    for n in radix._walk():  # media rot: every spilled host copy
        if n.host is not None:
            rotted = [leaf.copy() for leaf in n.host]
            rotted[0].flat[0] += 1
            n.host = rotted
    assert go(headers[0], "b0") == first[0]
    assert go(headers[1], "b1") == first[1]
    assert radix.integrity_failures >= 2
    assert not radix.host_tier_up and radix.breaker_trips == 1
    s = eng.metrics.summary()
    assert s["kv_integrity_failures"] >= 2
    assert s["kv_host_breaker_state"] == 1
    assert s["kv_host_breaker_trips"] == 1
    offs = radix.offloads
    assert go(headers[2], "b2") == first[2]
    assert radix.offloads == offs, "spilled while down"
    for n in list(radix._walk()):
        if n.host is not None:
            radix._drop_subtree(n)
    while radix.breaker_state != 2:
        radix.lookup([9, 9, 9, 9, 9])
    fresh = go(headers[3], "a3")
    go(headers[3], "w3")
    go(headers[0], "c0")
    assert radix.offloads > offs, "half-open state never spilled"
    restored = radix.restored_blocks
    assert go(headers[3], "b3") == fresh
    assert radix.restored_blocks > restored
    assert radix.host_tier_up, "successful probe must close the breaker"
    eng.pool.allocator.check()


def test_import_prefix_integrity_refusal(model):
    """A corrupted export refuses TYPED at import: nothing lands in the
    target pool and the verdict is ``integrity``."""
    prompt = _prompts()[1]
    a = _mk(model)
    a.add_request(Request(request_id="mid", prompt=prompt, max_new_tokens=10))
    for _ in range(5):
        a.step()
    export = a.export_prefix("mid")
    assert export is not None and export.checksums
    assert export.verified()
    rotted = [leaf.copy() for leaf in export.leaves]
    rotted[0].flat[0] += 1
    export = dataclasses.replace(export, leaves=tuple(rotted))
    assert not export.verified()
    b = _mk(model)
    before = b.pool.allocator.in_use
    assert b.import_prefix(export) == MIGRATE_INTEGRITY
    assert b.pool.allocator.in_use == before
    assert b._radix.lookup(list(prompt)) is None
    b.pool.allocator.check()


def test_import_prefix_into_aligned_lru_target(model):
    """An aligned-LRU (paged, no radix) target stores an import under the
    largest bucket key it covers: ``imported``, the forced-prefix
    continuation hits and equals the uninterrupted generation; an export
    shorter than every bucket is a typed ``no_key``."""
    prompt = _prompts()[1]
    base_eng = _mk(model)
    base = base_eng.add_request(Request(request_id="base", prompt=prompt, max_new_tokens=10))
    base_eng.run(max_ticks=200)
    a = _mk(model)
    out = a.add_request(Request(request_id="mid", prompt=prompt, max_new_tokens=10))
    for _ in range(5):
        a.step()
    export = a.export_prefix("mid")
    delivered = list(out.tokens)

    def lru(buckets):
        return ServingEngine(model, n_slots=2, decode_steps_per_tick=1, prefill_buckets=buckets,
                             scheduler=SchedulerConfig(max_prefills_per_tick=2),
                             kv_block_tokens=4, prefix_cache_size=4)

    b = lru((4, 8, 16, 32))
    assert b.import_prefix(export) == MIGRATE_IMPORTED
    assert b.import_prefix(export) == "already_cached"
    cont = b.add_request(Request(request_id="cont", prompt=list(prompt) + delivered,
                                 max_new_tokens=10 - len(delivered)))
    b.run(max_ticks=200)
    assert b.metrics.summary()["prefix_hits"] == 1
    assert delivered + list(cont.tokens) == list(base.tokens)
    assert lru((28, 32)).import_prefix(export) == "no_key"


def test_restore_writes_true_positions_in_place(model):
    """The pool's exchange half keeps its addresses and its positions: an
    export of live blocks imported into fresh blocks of the same pool
    reads back the same K/V bytes and the same positions (not -1), and no
    pool tensor was reallocated."""
    eng = _mk(model)
    out = eng.add_request(Request(request_id="r", prompt=_prompts()[1], max_new_tokens=3))
    eng.step()
    blocks = [int(b) for b in eng.pool.block_table[0, :4]]
    ptrs = [(c.key_store.data_ptr(), c.value_store.data_ptr(), c.pos_store.data_ptr())
            for c in eng.pool.cache]
    rows = eng.pool.export_blocks(blocks)
    fresh = eng.pool.import_stored(rows, len(blocks), checksums=block_checksums(rows, 4))
    back = eng.pool.export_blocks(list(fresh))
    for got, want in zip(back, rows):
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    pos = rows[1]  # scanned: key, pos, value; [k, layers, block_tokens]
    np.testing.assert_array_equal(pos[:, 0], np.arange(16).reshape(4, 4))
    assert ptrs == [(c.key_store.data_ptr(), c.value_store.data_ptr(), c.pos_store.data_ptr())
                    for c in eng.pool.cache]
    eng.pool.free_stored(fresh)
    eng.run()
    assert out.status == FINISHED


# -- engine level: against the JAX package -------------------------------------

CONFIGS = {
    "scanned": dict(),
    "gqa": dict(n_kv_heads=2),
    "unrolled": dict(scan_layers=False),
}


@pytest.fixture(scope="module")
def bridged():
    """config name -> (JAX side, port side) on one flax init bridged into
    the port's GPTLM (cached per config; the JAX model object is shared so
    its engine jits are)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from tpu_parallel import serving as jserving
    from tpu_parallel.models import GPTLM as JaxGPTLM
    from tpu_parallel.models import tiny_test as jax_tiny_test
    from tpu_parallel_torch import serving as tserving
    from tpu_parallel_torch.models.convert import params_from_jax

    made = {}

    def get(name):
        if name not in made:
            kw = CONFIGS[name]
            jm = JaxGPTLM(jax_tiny_test(dtype=jnp.float32, remat=False, **kw))
            params = jm.init({"params": jax.random.PRNGKey(1)}, jnp.zeros((1, 20), jnp.int32),
                             train=False)["params"]
            cfg = tiny_test(**kw)
            port = GPTLM(cfg, device="cpu")
            port.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), cfg))
            port.eval()
            made[name] = (
                types.SimpleNamespace(api=jserving, model=jm, params=params,
                                      make=lambda **k: jserving.ServingEngine(jm, params, **k)),
                types.SimpleNamespace(api=tserving, model=port,
                                      make=lambda **k: tserving.ServingEngine(port, **k)))
        return made[name]

    return get


COUNTERS = ("hits", "misses", "evictions", "offloads", "restored_blocks", "host_evictions",
            "restore_failures", "integrity_failures", "breaker_trips", "disk_spills",
            "disk_restores", "disk_restore_failures", "disk_evictions", "disk_seeded_blocks",
            "device_blocks", "host_blocks_in_use")
MODES = {
    "per_step": dict(),
    "fused": dict(decode_steps_per_tick=4),
    "chunked": dict(prefill_chunk_tokens=8),
}


def _run(side, n_new=8, overlap=False, **kw):
    """The JAX test's request loop: four prompts, one tick after each, then run."""
    kwargs = dict(n_slots=4, scheduler=side.api.SchedulerConfig(max_prefills_per_tick=4),
                  decode_steps_per_tick=1)
    kwargs.update(kw)
    eng = side.make(**kwargs)
    outs = []
    for i, p in enumerate(_prompts()):
        outs.append(eng.add_request(side.api.Request(request_id=f"r{i}", prompt=p,
                                                     max_new_tokens=n_new)))
        eng.step()
    eng.run(max_ticks=500, overlap=overlap)
    assert all(o.status == FINISHED for o in outs)
    return [list(o.tokens) for o in outs], eng


def _counters(eng):
    return {c: getattr(eng._radix, c) for c in COUNTERS}


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("mode", ["per_step", "fused", "chunked"])
def test_radix_engine_greedy_parity(bridged, mode, config):
    """The radix hierarchy is a pure cache layout: the port's greedy
    output is bitwise identical to its fixed-slot engine's and to the JAX
    fixed-slot engine's (which JAX's own contract holds its radix engine
    to), with real block-granular hits, zero copy-on-writes, the same radix
    counters as the JAX radix engine and the same ``export_meta``.

    The tokens are held to the JAX FIXED-SLOT engine: under a loaded host
    the JAX radix engine (chunked, unrolled layers) was seen to give other
    tokens between identical runs in one process, while its counters,
    the fixed-slot engines of both packages and the port's radix engine
    stayed steady (a reference-side fault, ROADMAP section C)."""
    jax_side, port_side = bridged(config)
    kw = MODES[mode]
    fixed, _ = _run(port_side, **kw)
    radix_kw = dict(kv_block_tokens=4, prefix_cache_size=16, kv_radix_cache=True, **kw)
    radix, eng = _run(port_side, **radix_kw)
    want, _ = _run(jax_side, **kw)
    _, jeng = _run(jax_side, **radix_kw)
    assert fixed == radix, f"radix {mode} diverged from fixed-slot"
    assert radix == want, f"radix {mode} diverged from the JAX fixed-slot engine"
    assert _counters(eng) == _counters(jeng)
    assert eng._radix.hits > 0
    assert eng.pool.cow_copies == 0
    assert eng._cow_reserve == 0
    assert eng.pool.export_meta == jeng.pool.export_meta
    eng.pool.allocator.check()


KNOBS = {
    "radix": dict(),
    "radix_host": dict(kv_host_blocks=16),
    "radix_host_disk": dict(kv_host_blocks=2, kv_disk_blocks=32),
}


@pytest.mark.parametrize("knobs", sorted(KNOBS))
@pytest.mark.parametrize("mode", ["per_step", "fused", "chunked", "fused_overlap"])
def test_hierarchy_knobs_match_jax(bridged, tmp_path, knobs, mode):
    """Each hierarchy knob under pressure (device budget 2 blocks, warm
    headers revisited after others): the port engine's greedy tokens and
    its radix, host and disk counters equal the JAX engine's, tick mode by
    tick mode (``fused_overlap``: ``run(overlap=True)`` on both sides)."""
    overlap = mode == "fused_overlap"
    kw = dict(MODES["fused" if overlap else mode], kv_block_tokens=4, prefix_cache_size=2,
              kv_radix_cache=True, **KNOBS[knobs])
    headers = _headers(5)
    visits = [h for h in headers for _ in (0, 1)] + headers
    got = {}
    for side, sub in zip(bridged("scanned"), ("jax", "port")):
        if "kv_disk_blocks" in kw:
            kw["kv_disk_dir"] = str(tmp_path / sub)
        eng = side.make(n_slots=2, scheduler=side.api.SchedulerConfig(max_prefills_per_tick=2),
                        **dict(dict(decode_steps_per_tick=1), **kw))
        toks = [_go(eng, side.api, h + [7, 9], f"a{i}", overlap=overlap)
                for i, h in enumerate(visits)]
        got[sub] = (toks, _counters(eng))
        eng.pool.allocator.check()
    assert got["port"][0] == got["jax"][0]
    assert got["port"][1] == got["jax"][1]
    assert got["port"][1]["hits"] > 0
    if knobs != "radix":
        assert got["port"][1]["restored_blocks"] > 0
    if knobs == "radix_host_disk":
        assert got["port"][1]["disk_restores"] > 0


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("config", ["scanned", "unrolled"])
def test_prefix_moves_between_packages(bridged, direction, config):
    """Export a mid-flight request from one package's engine, encode it and
    decode it with the other package's codec, import it into the other's
    engine: ``"imported"``, the next admission hits, and the continuation's
    greedy tokens equal the exporter's own.  Both packages' exports of the
    same request agree (K/V within the fp32 tolerance, positions exactly,
    same meta)."""
    from tpu_parallel.serving import kv_wire as jax_wire

    jax_side, port_side = bridged(config)
    src, dst = (jax_side, port_side) if direction == "jax_to_port" else (port_side, jax_side)
    encode = jax_wire.encode_export if src is jax_side else encode_export
    decode = decode_export if dst is port_side else jax_wire.decode_export
    prompt = _prompts()[1]

    def mk(side):
        return side.make(n_slots=2, decode_steps_per_tick=1,
                         scheduler=side.api.SchedulerConfig(max_prefills_per_tick=2),
                         kv_block_tokens=4, prefix_cache_size=16, kv_radix_cache=True)

    exports, delivered, refs = {}, {}, {}
    for side in (jax_side, port_side):
        base = mk(side)
        ref = base.add_request(side.api.Request(request_id="base", prompt=prompt,
                                                max_new_tokens=10))
        base.run(max_ticks=200)
        refs[id(side)] = list(ref.tokens)
        a = mk(side)
        out = a.add_request(side.api.Request(request_id="mid", prompt=prompt, max_new_tokens=10))
        for _ in range(5):
            a.step()
        exports[id(side)] = a.export_prefix("mid")
        delivered[id(side)] = list(out.tokens)
    assert refs[id(jax_side)] == refs[id(port_side)]
    je, pe = exports[id(jax_side)], exports[id(port_side)]
    assert je.tokens == pe.tokens and je.meta == pe.meta and len(je.leaves) == len(pe.leaves)
    for (name, _, _), j, p in zip(pe.meta, je.leaves, pe.leaves):
        if name == "cached_pos":
            np.testing.assert_array_equal(np.asarray(j), p)
        else:
            np.testing.assert_allclose(p, np.asarray(j), **TOL)

    moved = decode(encode(exports[id(src)]))
    b = mk(dst)
    assert b.import_prefix(moved) == MIGRATE_IMPORTED
    hits0 = b._radix.hits
    done = delivered[id(src)]
    cont = b.add_request(dst.api.Request(request_id="cont", prompt=list(prompt) + done,
                                         max_new_tokens=10 - len(done)))
    b.run(max_ticks=200)
    assert cont.status == FINISHED
    assert b._radix.hits > hits0, "the import never produced a hit"
    assert done + list(cont.tokens) == refs[id(src)]
    b.pool.allocator.check()


def test_export_meta_matches_jax_for_twelve_unrolled_layers():
    """Unrolled leaves follow flax's flatten order, whose layer names sort
    as strings (``layer_10`` before ``layer_2``): the meta of a 12-layer
    unrolled pool, and of a bf16 one, equals the JAX pool's."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    import torch

    from tpu_parallel.models import GPTLM as JaxGPTLM
    from tpu_parallel.models import tiny_test as jax_tiny_test
    from tpu_parallel.serving import PagedCachePool as JaxPool
    from tpu_parallel_torch.serving import PagedCachePool

    for kw, jdtype, tdtype in ((dict(n_layers=12, scan_layers=False), jnp.float32, torch.float32),
                               (dict(n_kv_heads=2), jnp.bfloat16, torch.bfloat16)):
        jm = JaxGPTLM(jax_tiny_test(dtype=jdtype, remat=False, kv_block_tokens=4,
                                    kv_pool_blocks=8, **kw))
        params = jm.init({"params": jax.random.PRNGKey(1)}, jnp.zeros((1, 5), jnp.int32),
                         train=False)["params"]
        port = PagedCachePool(GPTLM(tiny_test(dtype=tdtype, **kw), device="cpu"), 2,
                              block_tokens=4, n_blocks=8)
        assert port.export_meta == JaxPool(jm, params, 2).export_meta


@pytest.mark.gpu
def test_hierarchy_under_captured_ticks_on_card():
    """On the card: a tight radix + host hierarchy over a bf16 pool spills
    and restores under eager fused bodies, captured ones, and captured ones
    under ``run(overlap=True)``; the three give the same greedy tokens, the
    pool keeps its addresses (the graphs keep writing it), and an export of
    live blocks re-imported into fresh blocks reads back bitwise (bf16 as
    its raw bits)."""
    import torch

    import tpu_parallel_torch.serving as api

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the captured ticks have no CPU mode")
    model = GPTLM(tiny_test(dtype=torch.bfloat16), device="cuda", seed=5).eval()
    headers = _headers(3)
    visits = [h for h in headers for _ in (0, 1)] + headers
    results = {}
    for name, eager, overlap in (("eager", True, False), ("graph", False, False),
                                 ("graph_overlap", False, True)):
        eng = _tight(model, rng=torch.Generator(device="cuda").manual_seed(0),
                     decode_steps_per_tick=4)
        if eager:
            eng._run_fused_eagerly()
        ptrs = [(c.key_store.data_ptr(), c.pos_store.data_ptr()) for c in eng.pool.cache]
        toks = [_go(eng, api, h + [7, 9], f"v{i}", overlap=overlap) for i, h in enumerate(visits)]
        radix = eng._radix
        assert radix.offloads > 0 and radix.restored_blocks > 0
        assert radix.restore_failures == radix.integrity_failures == 0
        assert ptrs == [(c.key_store.data_ptr(), c.pos_store.data_ptr()) for c in eng.pool.cache]
        results[name] = (toks, eng.graph_captures)
        eng.pool.allocator.check()
    assert results["eager"][0] == results["graph"][0] == results["graph_overlap"][0]
    assert [results[n][1] for n in ("eager", "graph", "graph_overlap")] == [0, 1, 1]

    eng = _mk(model)
    eng.add_request(Request(request_id="r", prompt=_prompts()[1], max_new_tokens=3))
    eng.step()
    blocks = [int(b) for b in eng.pool.block_table[0, :4]]
    rows = eng.pool.export_blocks(blocks)
    assert rows[0].dtype.metadata == {"dtype": "bfloat16"}
    fresh = eng.pool.import_stored(rows, 4, checksums=block_checksums(rows, 4))
    back = eng.pool.export_blocks(list(fresh))
    assert all(g.tobytes() == w.tobytes() for g, w in zip(back, rows))
