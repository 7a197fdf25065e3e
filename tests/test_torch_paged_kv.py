"""Port parity for the block-paged KV pool: ``BlockAllocator``, the block
helpers, ``PagedCachePool`` with copy-on-write, the paged write and read
of ``Attention`` and the engine's paged path, against the JAX package.

``tiny_test`` in fp32 on the CPU (seq_len 32), weights bridged from a
flax init, prompts from a numpy seed.  The allocator units run one op
sequence through both allocators and compare their states.  The engine
cases compare the port's paged engine with JAX's (tokens and the stream
of events, exactly) and with the port's own contiguous engine (greedy
tokens, bitwise).  Hidden states and cached K/V within atol = rtol =
1e-5; positions, tables and refcounts exact.  Every paged engine ends
with ``allocator.check()`` passing and its blocks back on the free list
(prefix-cache entries released).

The JAX side is imported inside fixtures, so the ``gpu`` case at the end
runs on the card without JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_paged_kv.py
"""

import types

import numpy as np
import pytest
import torch

from tpu_parallel_torch.models import GPTLM, tiny_test
from tpu_parallel_torch.models import generate as tgen
from tpu_parallel_torch.models.layers import PagedKVCache
from tpu_parallel_torch.serving import (
    FINISHED,
    REJECTED,
    BlockAllocator,
    PagedCachePool,
    Request,
    SchedulerConfig,
    ServingEngine,
)
from tpu_parallel_torch.serving import cache_pool

# one torch intra-op thread per test process: under pytest-xdist several
# processes share the cores, and torch's default (a thread per core in each)
# oversubscribes them
torch.set_num_threads(1)

BT = 8  # block tokens used throughout (divides tiny_test's seq_len 32)
SEQ = 32
VOCAB = 256
TOL = dict(atol=1e-5, rtol=1e-5)


def _prompts():
    """Mixed lengths with a long shared header, so prefix sharing and the
    copy-on-write paths run."""
    rs = np.random.default_rng(11)
    shared = [int(t) for t in rs.integers(1, VOCAB, 20)]
    return [shared[:9], shared[:17] + [3, 1, 4], shared[:17] + [5, 9],
            [int(t) for t in rs.integers(1, VOCAB, 6)]]


@pytest.fixture(scope="module")
def pair():
    """(JAX side, port side): one flax init bridged into the port's GPTLM;
    the JAX model object is shared so its engine jits are."""
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
    model = GPTLM(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), cfg))
    model.eval()
    jax_side = types.SimpleNamespace(
        api=jserving, jax=jax, model=jm, params=params,
        make=lambda **kw: jserving.ServingEngine(jm, params, **kw))
    port_side = types.SimpleNamespace(
        api=tserving, model=model, make=lambda **kw: tserving.ServingEngine(model, **kw))
    return jax_side, port_side


@pytest.fixture(scope="module")
def model():
    return GPTLM(tiny_test(), device="cpu", seed=3).eval()


def _drained(eng):
    """The engine's allocator audit after a run: check() passes and, once
    the prefix cache's entries are released, every block is free."""
    pool = eng.pool
    pool.allocator.check()
    if eng._prefix is not None:
        held = {b for blocks, _ in eng._prefix.values() for b in blocks}
        assert pool.blocks_in_use == len(held)
        for blocks, _ in list(eng._prefix.values()):
            pool.free_stored(blocks)
    pool.allocator.check()
    assert pool.blocks_in_use == 0 and pool.blocks_free == pool.n_blocks
    assert (pool.block_table == -1).all()


# -- BlockAllocator: one op sequence through both allocators --------------------

def _allocators(pair, n):
    jax_side, _ = pair
    return jax_side.api.BlockAllocator(n), BlockAllocator(n)


def _same_state(ja, ta):
    assert sorted(ja._free) == sorted(ta._free)
    np.testing.assert_array_equal(np.asarray(ja._ref), ta._ref)
    assert (ja.n_free, ja.in_use) == (ta.n_free, ta.in_use)


def test_allocator_refcounts_and_double_free(pair):
    """Refcounts never go negative: freeing an unreferenced block raises
    (the double-free guard), as does sharing one; a shared block returns
    to the free list only when its LAST reference drops."""
    for al in _allocators(pair, 4):
        a = al.alloc()
        assert al.refcount(a) == 1 and al.in_use == 1
        al.share(a)
        assert al.refcount(a) == 2
        assert al.free(a) is False
        assert al.free(a) is True
        with pytest.raises(ValueError, match="double free"):
            al.free(a)
        with pytest.raises(ValueError, match="share of unallocated"):
            al.share(a)
        with pytest.raises(ValueError):
            al.free(99)
        al.check()
        assert al.n_free == 4
    _same_state(*_allocators(pair, 4))


def test_allocator_exhaustion_raises(pair):
    ja, ta = _allocators(pair, 2)
    assert [ja.alloc(), ja.alloc()] == [ta.alloc(), ta.alloc()]
    _same_state(ja, ta)
    for al in (ja, ta):
        with pytest.raises(RuntimeError, match="exhausted"):
            al.alloc()


def test_allocator_fragmentation_round_trip(pair):
    """A seeded alloc/share/free storm: the two allocators hand out the
    same blocks and hold the same state after every op, every state passes
    the audit, and the storm ends with all 16 blocks free."""
    ja, ta = _allocators(pair, 16)
    rng = np.random.RandomState(0)
    held = []  # [block, references held]
    for _ in range(600):
        op = rng.randint(3)
        if op == 0 and ta.n_free:
            block = ta.alloc()
            assert ja.alloc() == block
            held.append([block, 1])
        elif op == 1 and held:
            ent = held[rng.randint(len(held))]
            ta.share(ent[0])
            ja.share(ent[0])
            ent[1] += 1
        elif held:
            i = rng.randint(len(held))
            blk, refs = held[i]
            assert ta.free(blk) == ja.free(blk) == (refs == 1)
            if refs == 1:
                held.pop(i)
            else:
                held[i][1] -= 1
        ta.check()
        _same_state(ja, ta)
    for blk, refs in held:
        for _ in range(refs):
            ta.free(blk)
            ja.free(blk)
    ta.check()
    _same_state(ja, ta)
    assert ta.n_free == 16 and ta.in_use == 0


# -- the block helpers and the pool -------------------------------------------------

def _paged_model_cfg(n_blocks=8):
    return tiny_test(kv_block_tokens=BT, kv_pool_blocks=n_blocks)


def test_paged_config_and_init_cache():
    """``kv_block_tokens`` > 0 makes ``init_cache`` return the row-count
    free paged pool, one ``PagedKVCache`` per layer with its scratch
    block; the fields are validated."""
    cfg = _paged_model_cfg(n_blocks=4)
    cache = GPTLM(cfg, device="cpu").init_cache(3)
    assert len(cache) == cfg.n_layers and all(isinstance(c, PagedKVCache) for c in cache)
    assert (cache[0].n_blocks, cache[0].block_tokens) == (4, BT)
    assert cache[0].key_store.shape == (4, 5, BT, 8) and cache[0].key.shape == (4, BT, 4, 8)
    assert (cache[0].pos == -1).all()
    with pytest.raises(ValueError, match="kv_pool_blocks"):
        tiny_test(kv_block_tokens=BT)
    with pytest.raises(ValueError, match="divide seq_len"):
        tiny_test(kv_block_tokens=5, kv_pool_blocks=4)


def test_block_helpers_in_place(model):
    """copy_block copies one block in every layer; free_block_pos sets its
    positions to -1 and leaves the payloads; the pool's export of block
    rows and their import into blocks round-trips, positions included;
    storage never moves."""
    pool = PagedCachePool(model, 2, block_tokens=BT, n_blocks=8)
    cache = pool.cache
    gen = torch.Generator().manual_seed(0)
    for c in cache:
        c.key_store.copy_(torch.randn(c.key_store.shape, generator=gen))
        c.value_store.copy_(torch.randn(c.value_store.shape, generator=gen))
        c.pos_store.copy_(torch.arange(c.pos_store.numel(), dtype=torch.int32).view_as(
            c.pos_store))
    ptrs = [(c.key_store.data_ptr(), c.pos_store.data_ptr()) for c in cache]
    rows = pool.export_blocks([2, 5])
    cache_pool.copy_block(cache, 2, 6)
    for c in cache:
        assert torch.equal(c.key_store[:, 6], c.key_store[:, 2])
        assert torch.equal(c.pos_store[6], c.pos_store[2])
    before = [c.key_store.clone() for c in cache]
    cache_pool.free_block_pos(cache, [2, 6])
    for c, k in zip(cache, before):
        assert (c.pos[[2, 6]] == -1).all() and (c.pos[3] >= 0).all()
        assert torch.equal(c.key_store, k)
    pool._write_blocks(rows, [2, 7])  # block 5's rows land in block 7
    for c, k in zip(cache, before):
        assert torch.equal(c.pos[2], torch.arange(2 * BT, 3 * BT, dtype=torch.int32))
        assert torch.equal(c.key_store[:, 2], k[:, 2]) and (c.pos[6] == -1).all()
        assert torch.equal(c.key_store[:, 7], k[:, 5]) and torch.equal(c.pos[7], c.pos[5])
    # the JAX layout, scanned: [k, layers, block_tokens, kv_heads, head_dim], [k, layers, bt]
    assert rows[0].shape == (2, 4, BT, 4, 8) and rows[1].shape == (2, 4, BT)
    assert [(c.key_store.data_ptr(), c.pos_store.data_ptr()) for c in cache] == ptrs


def test_paged_pool_cow_isolates_sharers(pair):
    """Pool-level copy-on-write, the same op sequence on both pools: two
    slots mapping one shared block diverge on first write; the writer gets
    a fresh block, the other sharer and the stored entry keep the
    original.  Tables and refcounts equal JAX's after every step."""
    import dataclasses

    jax_side, port_side = pair
    jcfg = dataclasses.replace(jax_side.model.config, kv_block_tokens=BT, kv_pool_blocks=8)
    jpool = jax_side.api.PagedCachePool(type(jax_side.model)(jcfg), jax_side.params, n_slots=2)
    tpool = PagedCachePool(port_side.model, n_slots=2, block_tokens=BT, n_blocks=8)

    def same():
        np.testing.assert_array_equal(tpool.block_table, np.asarray(jpool.block_table))
        _same_state(jpool.allocator, tpool.allocator)
        assert tpool.cow_copies == jpool.cow_copies

    for pool in (jpool, tpool):
        assert pool.acquire() == 0 and pool.acquire() == 1
        pool.begin_slot(0, 2 * BT)
        pool.ensure_writable(0, 0, BT)
    same()
    blocks = tpool.snapshot_blocks(0, BT)
    assert jpool.snapshot_blocks(0, BT) == blocks
    for pool in (jpool, tpool):
        pool.map_prefix(1, blocks, BT)
    shared = int(tpool.block_table[1, 0])
    assert shared == int(tpool.block_table[0, 0]) and tpool.allocator.refcount(shared) == 3
    same()
    for pool in (jpool, tpool):
        pool.ensure_writable(1, 0, BT)
    same()
    assert tpool.cow_copies == 1 and int(tpool.block_table[1, 0]) != shared
    assert tpool.allocator.refcount(shared) == 2
    for pool in (jpool, tpool):
        pool.release(1)
        pool.release(0)
        pool.free_stored(blocks)
    same()
    tpool.allocator.check()
    assert tpool.allocator.n_free == 8
    assert tpool.outstanding_blocks() == 0 and tpool.blocks_available() == 8


# -- the paged write and read of Attention -----------------------------------------

def _jax_paged_pool_layer(cache, i):
    import jax

    return jax.tree.map(lambda x: x[i], cache["blocks"]["layers"]["block"]["attn"])


def test_paged_extend_and_decode_match_jax(pair):
    """A ragged extend through block tables (one row with an unmapped
    block its pad tail runs into, one dummy row with an all -1 table),
    then a decode step with one parked row: hidden states and the whole
    pool (positions exact, written K/V within TOL) equal JAX's paged
    model; the storage keeps its address."""
    import dataclasses

    jax_side, port_side = pair
    jnp = jax_side.jax.numpy
    from tpu_parallel.models import generate as jgen

    n_blocks = 10
    jm = type(jax_side.model)(dataclasses.replace(
        jax_side.model.config, kv_block_tokens=BT, kv_pool_blocks=n_blocks))
    j_cache = jax_side.api.PagedCachePool(jm, jax_side.params, n_slots=3).cache
    table = np.array([[3, 7, -1, -1], [0, 1, 2, -1], [-1, -1, -1, -1]], np.int32)
    rs = np.random.default_rng(5)
    tokens = rs.integers(1, VOCAB, (3, 12)).astype(np.int32)
    start = np.array([0, 5, 0], np.int32)
    positions = start[:, None] + np.arange(12, dtype=np.int32)[None, :]
    positions[0, 10:] = -1  # row 0's pad tail
    hid_j, j_cache = jgen.prefill_extend_step(jm, jax_side.params, j_cache, jnp.asarray(tokens),
                                              jnp.asarray(positions), jnp.asarray(start),
                                              block_table=jnp.asarray(table))
    model = port_side.model
    paged_cfg = tiny_test(kv_block_tokens=BT, kv_pool_blocks=n_blocks)
    t_cache = [PagedKVCache.empty(paged_cfg, "cpu") for _ in range(paged_cfg.n_layers)]
    ptrs = [c.key_store.data_ptr() for c in t_cache]
    t_table = torch.from_numpy(table).long()
    with torch.no_grad():
        hid_t, _ = tgen.prefill_extend_step(model, t_cache, torch.from_numpy(tokens).long(),
                                            torch.from_numpy(positions).long(),
                                            torch.from_numpy(start).long(), block_table=t_table)
    real = (positions >= 0) & (table[:, :1] >= 0)
    np.testing.assert_allclose(hid_t.numpy()[real], np.asarray(hid_j)[real], **TOL)
    tok = np.array([17, 18, 19], np.int32)
    pos = np.array([10, 17, 0], np.int32)
    widx = np.array([10, 17, SEQ], np.int32)
    hid_j, j_cache = jgen.decode_step(jm, jax_side.params, j_cache, jnp.asarray(tok),
                                      jnp.asarray(pos), write_index=jnp.asarray(widx),
                                      block_table=jnp.asarray(table))
    with torch.no_grad():
        hid_t, _ = tgen.decode_step(model, t_cache, torch.from_numpy(tok).long(),
                                    torch.from_numpy(pos).long(),
                                    write_index=torch.from_numpy(widx).long(), block_table=t_table)
    np.testing.assert_allclose(hid_t.numpy()[:2], np.asarray(hid_j)[:2], **TOL)
    for i, c in enumerate(t_cache):
        ref = _jax_paged_pool_layer(j_cache, i)
        stored = np.asarray(ref["cached_pos"])
        np.testing.assert_array_equal(c.pos.numpy(), stored)
        written = stored >= 0
        for name, mine in (("cached_key", c.key), ("cached_value", c.value)):
            np.testing.assert_allclose(mine.numpy()[written], np.asarray(ref[name])[written],
                                       **TOL)
    assert [c.key_store.data_ptr() for c in t_cache] == ptrs


def _count_copies(fn, min_numel):
    """Dispatched ops of ``fn`` that write a new tensor or an in-place
    destination of at least ``min_numel`` elements, by op name."""
    from torch.utils._python_dispatch import TorchDispatchMode

    copies = {}

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types_, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__
            if name in ("copy_", "clone", "_to_copy", "index_select", "contiguous", "cat",
                        "index", "gather", "_reshape_copy"):
                t = out if isinstance(out, torch.Tensor) else None
                if t is not None and t.numel() >= min_numel:
                    copies[name] = copies.get(name, 0) + 1
            return out

    with Count():
        fn()
    return copies


def test_decode_read_makes_no_second_copy(model):
    """One decode step over 4 slots: the contiguous cache's read makes no
    cache-sized copy; the paged read makes exactly one per payload per
    layer, its gather (``index_select``), and no other."""
    cfg = model.config
    n = 4
    cache_numel = cfg.n_heads * n * SEQ * cfg.head_dim
    tok = torch.tensor([5, 6, 7, 8])
    pos = torch.tensor([3, 9, 0, 20])
    contiguous = model.init_cache(n)
    paged = PagedCachePool(model, n, block_tokens=BT, n_blocks=n * SEQ // BT)
    for slot in range(n):
        paged.acquire()
        paged.ensure_writable(slot, 0, SEQ)
    table = torch.from_numpy(paged.block_table).long()
    with torch.no_grad():
        got = _count_copies(lambda: tgen.decode_step(model, contiguous, tok, pos,
                                                     write_index=pos), cache_numel)
        assert got == {}
        got = _count_copies(lambda: tgen.decode_step(model, paged.cache, tok, pos,
                                                     write_index=pos, block_table=table),
                            cache_numel)
        assert got == {"index_select": 2 * cfg.n_layers}


# -- the engine's paged path: parity with JAX and with the contiguous pool ------------

MODES = {
    "per_step": dict(),
    "fused": dict(decode_steps_per_tick=4),
    "chunked": dict(prefill_chunk_tokens=8, prefill_buckets=(8, 16, 32), prefix_cache_size=4),
    "bucketed_prefix": dict(prefill_buckets=(8, 16, 32), prefix_cache_size=4),
    "fused_prefix": dict(decode_steps_per_tick=4, prefill_buckets=(8, 16, 32),
                         prefix_cache_size=4),
}


def _drive(side, paged=True, n_new=8, **kw):
    """The JAX test's staggered script: one request per tick, then run;
    returns (outputs, events, engine)."""
    kwargs = dict(n_slots=4, scheduler=side.api.SchedulerConfig(max_prefills_per_tick=4),
                  decode_steps_per_tick=1, clock=lambda: 0.0)
    kwargs.update(kw)
    if paged:
        kwargs.setdefault("kv_block_tokens", BT)
    eng = side.make(**kwargs)
    outs, events = [], []
    for i, p in enumerate(_prompts()):
        outs.append(eng.add_request(side.api.Request(request_id=str(i), prompt=p,
                                                     max_new_tokens=n_new)))
        events += eng.step()
    events += eng.run(max_ticks=500)
    assert all(o.status == FINISHED for o in outs)
    return outs, events, eng


def _record(outs, events):
    return ([(o.status, o.finish_reason, list(o.tokens)) for o in outs],
            [(e.request_id, e.token, e.index, e.finished, e.finish_reason) for e in events])


@pytest.mark.parametrize("mode", sorted(MODES))
def test_paged_engine_matches_jax_and_contiguous(pair, mode):
    """The port's paged engine against JAX's paged engine (tokens and
    events) and against the port's contiguous engine (greedy tokens,
    bitwise): the paged write and gather are a pure relayout."""
    jax_side, port_side = pair
    j_outs, j_events, _ = _drive(jax_side, **MODES[mode])
    outs, events, eng = _drive(port_side, **MODES[mode])
    assert _record(outs, events) == _record(j_outs, j_events)
    fixed, _, _ = _drive(port_side, paged=False, **MODES[mode])
    assert [o.tokens for o in fixed] == [o.tokens for o in outs]
    if "prefix_cache_size" in MODES[mode] and "prefill_chunk_tokens" not in MODES[mode]:
        # block-aligned buckets: hits are table writes, never a block copy
        assert eng.metrics.prefix_hits > 0 and eng.pool.shared_block_maps > 0
        assert eng.metrics.prefix_shared_blocks > 0 and eng.pool.cow_copies == 0
    _drained(eng)


def test_paged_cow_under_concurrent_sharers(pair):
    """Blocks of 16 coarser than the bucket quantum 8: stored prefixes end
    mid-block, so the owner's decode and every hitter's remainder write
    into SHARED blocks; each sharer copy-on-writes its own copy and the
    greedy tokens still equal the contiguous engine's and JAX's."""
    jax_side, port_side = pair
    kw = dict(kv_block_tokens=16, prefill_buckets=(8, 16, 32), prefix_cache_size=4)
    outs, events, eng = _drive(port_side, **kw)
    j_outs, j_events, j_eng = _drive(jax_side, **kw)
    assert _record(outs, events) == _record(j_outs, j_events)
    fixed, _, _ = _drive(port_side, paged=False, prefill_buckets=(8, 16, 32),
                         prefix_cache_size=4)
    assert [o.tokens for o in fixed] == [o.tokens for o in outs]
    assert eng.pool.cow_copies == j_eng.pool.cow_copies > 0
    _drained(eng)


def test_paged_release_returns_all_blocks(pair):
    """After a full run the only live blocks are the prefix cache's
    entries; releasing them returns the pool to capacity."""
    _, port_side = pair
    _, _, eng = _drive(port_side, prefill_buckets=(8, 16, 32), prefix_cache_size=4)
    assert eng.pool.blocks_in_use > 0
    _drained(eng)


def test_paged_capacity_decoupled_from_seq_len(model):
    """At EQUAL pool bytes the paged engine runs 4x the short requests at
    once: 2 fixed slots of seq_len 32 against 8 blocks of 8 tokens."""
    short = [[7, 3, 5]] * 8  # 3 + 4 new = 7 tokens = 1 block
    fixed = ServingEngine(model, n_slots=2, decode_steps_per_tick=1,
                          scheduler=SchedulerConfig(max_prefills_per_tick=8))
    paged = ServingEngine(model, n_slots=8, kv_block_tokens=BT, kv_pool_blocks=8,
                          decode_steps_per_tick=1,
                          scheduler=SchedulerConfig(max_prefills_per_tick=8))
    pool_bytes = lambda eng: sum(c.key.nbytes + c.value.nbytes for c in eng.pool.cache)
    assert pool_bytes(fixed) == pool_bytes(paged)
    outs = {}
    for name, eng in (("fixed", fixed), ("paged", paged)):
        outs[name] = [eng.add_request(Request(request_id=str(i), prompt=p, max_new_tokens=4))
                      for i, p in enumerate(short)]
        assert all(o.status != REJECTED for o in outs[name])
        eng.step()
    assert fixed.in_flight == 2 and paged.in_flight == 8
    paged.run(max_ticks=200)
    fixed.run(max_ticks=200)
    assert [o.tokens for o in outs["paged"]] == [o.tokens for o in outs["fixed"]]
    _drained(paged)


def test_paged_block_gate_holds_head_until_blocks_free(model):
    """Transient block exhaustion QUEUES the head instead of rejecting it:
    it admits once a running request retires its blocks."""
    eng = ServingEngine(model, n_slots=4, kv_block_tokens=BT, kv_pool_blocks=2,
                        scheduler=SchedulerConfig(max_prefills_per_tick=4))
    outs = [eng.add_request(Request(request_id=str(i), prompt=[5, 3], max_new_tokens=12))
            for i in range(3)]  # 14 tokens = 2 blocks: one fits at a time
    eng.step()
    assert eng.in_flight == 1 and eng.scheduler.depth == 2
    eng.run(max_ticks=500)
    assert all(o.status == FINISHED for o in outs)
    assert outs[0].tokens == outs[1].tokens == outs[2].tokens
    _drained(eng)


def test_paged_cow_cannot_exhaust_pool_midtick(model):
    """Buckets NOT aligned to the block size: sharing lands mid-block and
    sharers' writes copy-on-write, each claiming a block the plain
    estimate cannot see.  The gate's COW reserve and its eviction of LRU
    prefix entries keep a tight pool from running dry inside a tick."""
    eng = ServingEngine(model, n_slots=2, decode_steps_per_tick=1, prefill_buckets=(12, 24),
                        prefix_cache_size=4, kv_block_tokens=8, kv_pool_blocks=5)
    assert eng._cow_reserve > 0
    rs = np.random.RandomState(0)
    outs = [eng.add_request(Request(request_id=str(i),
                                    prompt=[int(t) for t in rs.randint(1, VOCAB, 14)],
                                    max_new_tokens=n_new))
            for i, n_new in enumerate((10, 2, 6))]
    eng.run(max_ticks=800)
    assert all(o.status == FINISHED for o in outs)
    assert eng.pool.cow_copies > 0 and eng._prefix.evictions > 0
    _drained(eng)


def test_paged_first_token_finish_seeds_prefix(model):
    """A request finishing on its first token retires inside admission;
    the prefix store snapshots its blocks BEFORE the release wipes its
    table, for the bucketed and the chunked completion paths."""
    prompts = _prompts()
    eng = ServingEngine(model, n_slots=2, scheduler=SchedulerConfig(max_prefills_per_tick=2),
                        decode_steps_per_tick=1, kv_block_tokens=BT, prefill_buckets=(8, 16),
                        prefix_cache_size=4)
    one = eng.add_request(Request(prompt=prompts[0], max_new_tokens=1))
    eng.run(max_ticks=50)
    assert one.status == FINISHED and len(one.tokens) == 1
    hits = eng.metrics.prefix_hits
    again = eng.add_request(Request(prompt=prompts[0], max_new_tokens=4))
    eng.run(max_ticks=100)
    assert again.status == FINISHED and eng.metrics.prefix_hits > hits
    assert again.tokens[:1] == one.tokens
    _drained(eng)
    engc = ServingEngine(model, n_slots=2, scheduler=SchedulerConfig(max_prefills_per_tick=2),
                         decode_steps_per_tick=1, kv_block_tokens=BT, prefill_buckets=(8, 16),
                         prefix_cache_size=4, prefill_chunk_tokens=6)
    outc = engc.add_request(Request(prompt=prompts[1], max_new_tokens=1))
    engc.run(max_ticks=50)
    assert outc.status == FINISHED and len(outc.tokens) == 1
    _drained(engc)


def test_paged_prefix_pin_survives_same_tick_eviction(model):
    """With a one-entry prefix cache, an earlier admission group's store
    evicts the entry a later group of the same tick looked up; the
    admission pin keeps its blocks alive until they are mapped."""
    prompt = _prompts()[0][:5]
    eng = ServingEngine(model, n_slots=4, scheduler=SchedulerConfig(max_prefills_per_tick=4),
                        decode_steps_per_tick=1, kv_block_tokens=4, prefill_buckets=(4, 8),
                        prefix_cache_size=1)
    seed = eng.add_request(Request(prompt=prompt, max_new_tokens=6))
    eng.run(max_ticks=100)
    a = eng.add_request(Request(prompt=[7, 7, 5, 2, 9], max_new_tokens=6))
    b = eng.add_request(Request(prompt=prompt, max_new_tokens=6))
    eng.run(max_ticks=100)
    assert seed.status == a.status == b.status == FINISHED
    assert b.tokens == seed.tokens and eng.metrics.prefix_hits >= 1
    _drained(eng)


def test_paged_admission_rejects_impossible_request(model):
    """A request whose worst case exceeds the WHOLE pool can never admit:
    a typed capacity reject at submit."""
    eng = ServingEngine(model, n_slots=2, kv_block_tokens=BT, kv_pool_blocks=2)
    out = eng.add_request(Request(prompt=[1] * 20, max_new_tokens=10))
    assert out.status == REJECTED and out.finish_reason == "capacity"
    assert "KV blocks" in out.detail


def test_paged_device_table_keeps_its_address(model):
    """The port's counterpart of JAX's compile-count pin: the device block
    table is rewritten in place when the host table moves (at the next
    launch, or on demand), never reallocated (the captured graphs read
    it); on the CPU nothing is captured."""
    eng = ServingEngine(model, n_slots=4, decode_steps_per_tick=4, kv_block_tokens=BT,
                        prefill_buckets=(8, 16, 32), prefix_cache_size=2,
                        scheduler=SchedulerConfig(max_prefills_per_tick=2))
    ptr = eng._dev_table.data_ptr()
    outs, versions = [], set()
    for i, p in enumerate(_prompts()):
        outs.append(eng.add_request(Request(request_id=str(i), prompt=p, max_new_tokens=6 + i)))
        eng.step()
        versions.add(eng.pool.table_version)
        assert eng._device_table().data_ptr() == ptr
        assert torch.equal(eng._dev_table, torch.from_numpy(eng.pool.block_table).long())
    eng.run(max_ticks=300)
    assert all(o.status == FINISHED for o in outs) and len(versions) > 2
    assert eng._dev_table.data_ptr() == ptr and eng.graph_captures == 0
    _drained(eng)


# -- on the card ------------------------------------------------------------------------

@pytest.mark.gpu
def test_captured_paged_ticks_equal_eager_and_contiguous():
    """On the card: the paged engine's captured fused and unified ticks
    give the eager bodies' tokens bitwise, and the contiguous engine's;
    one capture per tick body; every block back at the end."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the captured ticks have no CPU mode")
    model = GPTLM(tiny_test(seq_len=64), device="cuda", seed=5).eval()
    rs = np.random.default_rng(30)
    prompts = [[int(t) for t in rs.integers(1, VOCAB, n)] for n in (5, 19, 3, 27, 9)]
    results = {}
    for name, kw, eager in (("paged_eager", dict(kv_block_tokens=8), True),
                            ("paged_graph", dict(kv_block_tokens=8), False),
                            ("contiguous_graph", {}, False)):
        eng = ServingEngine(model, n_slots=4, scheduler=SchedulerConfig(max_prefills_per_tick=4),
                            rng=torch.Generator(device="cuda").manual_seed(0),
                            decode_steps_per_tick=4, prefill_chunk_tokens=8,
                            prefill_buckets=(8, 16, 32, 64), **kw)
        if eager:
            eng._run_fused_eagerly()
        outs = [eng.add_request(Request(prompt=p, max_new_tokens=13)) for p in prompts]
        eng.run()
        assert all(o.status == FINISHED for o in outs)
        results[name] = ([o.tokens for o in outs], eng.graph_captures)
        if "kv_block_tokens" in kw:
            _drained(eng)
    assert results["paged_eager"][1] == 0
    assert results["paged_graph"][1] == results["contiguous_graph"][1] == 2
    assert results["paged_eager"][0] == results["paged_graph"][0] == results["contiguous_graph"][0]
