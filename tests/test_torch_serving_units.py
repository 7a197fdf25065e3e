"""Port parity for the serving engine's parts: the slot-indexed cache writes
(``write_index``), ``prefill_extend_step``, the sampler and its filters
against the JAX functions; the host-only modules (scheduler, prefix cache,
metrics) with the bodies of the JAX package's own tests; and the pool's
in-place row ops.

``tiny_test`` in fp32 on the CPU, weights bridged from a flax init.
Tokens, positions and masks exact; hidden states, logits and cached K/V
within atol = rtol = 1e-5.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_parallel.models import generate as jgen
from tpu_parallel.models import gpt as jgpt
from tpu_parallel.serving import engine as jengine
from tpu_parallel.serving import spec_decode as jspec
from tpu_parallel_torch.models import GPTLM, tiny_test
from tpu_parallel_torch.models import generate as tgen
from tpu_parallel_torch.models.convert import params_from_jax
from tpu_parallel_torch.serving import (
    EXPIRED,
    NON_FINITE_TOKEN,
    FIFOScheduler,
    PrefixCache,
    Request,
    RequestOutput,
    SchedulerConfig,
    ServingMetrics,
    default_prefill_buckets,
    percentile,
    sample_tokens,
)
from tpu_parallel_torch.serving import cache_pool
from tpu_parallel_torch.serving.sampling import filter_logits

# one torch intra-op thread per test process: under pytest-xdist several
# processes share the cores, and torch's default (a thread per core in each)
# oversubscribes them
torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)
SEQ = 32


@pytest.fixture(scope="module")
def pair():
    jm = jgpt.GPTLM(jgpt.tiny_test(dtype=jnp.float32, remat=False))
    params = jm.init({"params": jax.random.PRNGKey(1)}, jnp.zeros((1, 5), jnp.int32),
                     train=False)["params"]
    cfg = tiny_test()
    model = GPTLM(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), cfg))
    return jm, params, model.eval()


def _jax_layer(cache, i):
    return jax.tree.map(lambda x: x[i], cache["blocks"]["layers"]["block"]["attn"])


def _assert_caches_equal(cache_t, cache_j):
    """Position tables exact; K/V within TOL where a position was written
    (pad columns hold garbage K/V on both sides)."""
    for i, layer in enumerate(cache_t):
        ref = _jax_layer(cache_j, i)
        stored = np.asarray(ref["cached_pos"])
        np.testing.assert_array_equal(layer.pos.numpy(), stored)
        written = stored >= 0
        for name, mine in (("cached_key", layer.key), ("cached_value", layer.value)):
            np.testing.assert_allclose(mine.numpy()[written], np.asarray(ref[name])[written], **TOL)


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(1, 256, size=shape).astype(np.int32)


def _prefilled(pair, lengths, width=8, seed=0):
    """Both sides' caches after one right-padded prefill of ``lengths``."""
    jm, params, model = pair
    tokens = _tokens(seed, (len(lengths), width))
    pos_j, _ = jgen.padded_prefill_inputs(lengths, width)
    _, cache_j = jgen.prefill_step(jm, params, jnp.asarray(tokens), pos_j)
    pos_t, _ = tgen.padded_prefill_inputs(lengths, width)
    with torch.no_grad():
        _, cache_t = tgen.prefill_step(model, torch.from_numpy(tokens).long(), pos_t)
    return cache_j, cache_t


def test_write_index_single_token_matches_jax(pair):
    """One decode step with per-row write indices, one row parked at
    column seq_len: hidden states and every layer's cache agree."""
    jm, params, model = pair
    cache_j, cache_t = _prefilled(pair, [5, 8, 3])
    tok = np.array([11, 12, 13], np.int32)
    pos = np.array([5, 8, 3], np.int32)
    widx = np.array([5, 8, SEQ], np.int32)
    hid_j, cache_j = jgen.decode_step(jm, params, cache_j, jnp.asarray(tok), jnp.asarray(pos),
                                      write_index=jnp.asarray(widx))
    with torch.no_grad():
        hid_t, cache_t = tgen.decode_step(model, cache_t, torch.from_numpy(tok).long(),
                                          torch.from_numpy(pos).long(),
                                          write_index=torch.from_numpy(widx).long())
    np.testing.assert_allclose(hid_t.numpy()[:2], np.asarray(hid_j)[:2], **TOL)
    _assert_caches_equal(cache_t, cache_j)


def test_write_index_multi_token_matches_jax(pair):
    """A 4-token extend per row at its own start; the last row's tail runs
    past seq_len and is dropped on both sides."""
    jm, params, model = pair
    cache_j, cache_t = _prefilled(pair, [5, 8, 3], seed=1)
    tokens = _tokens(2, (3, 4))
    start = np.array([5, 8, SEQ - 2], np.int32)
    positions = start[:, None] + np.arange(4, dtype=np.int32)[None, :]
    positions[0, 3] = -1  # a pad in row 0's chunk
    positions[2, 2:] = -1  # row 2's padded tail, whose columns lie beyond seq_len
    hid_j, cache_j = jgen.prefill_extend_step(jm, params, cache_j, jnp.asarray(tokens),
                                              jnp.asarray(positions), jnp.asarray(start))
    with torch.no_grad():
        hid_t, cache_t = tgen.prefill_extend_step(
            model, cache_t, torch.from_numpy(tokens).long(), torch.from_numpy(positions).long(),
            torch.from_numpy(start).long())
    real = positions >= 0
    np.testing.assert_allclose(hid_t.numpy()[real], np.asarray(hid_j)[real], **TOL)
    _assert_caches_equal(cache_t, cache_j)


@pytest.mark.parametrize("start, t", [(SEQ, 1), (SEQ, 3), (SEQ + 5, 2), (SEQ - 1, 3)])
def test_parked_and_out_of_range_writes_leave_cache_unchanged(pair, start, t):
    """Targets at or beyond seq_len are dropped: the visible cache is
    bitwise unchanged apart from the in-range columns; no index error."""
    _, _, model = pair
    _, cache = _prefilled(pair, [6, 2])
    before = [(c.key.clone(), c.value.clone(), c.pos.clone()) for c in cache]
    ptrs = [c.key_store.data_ptr() for c in cache]
    tokens = torch.from_numpy(_tokens(3, (2, t))).long()
    positions = torch.arange(t).expand(2, t) + 10  # a parked row's stale, valid positions
    with torch.no_grad():
        tgen.prefill_extend_step(model, cache, tokens, positions, torch.tensor([start, start]))
    in_range = [col for col in range(start, start + t) if col < SEQ]
    for c, (k, v, p), ptr in zip(cache, before, ptrs):
        assert c.key_store.data_ptr() == ptr
        keep = [col for col in range(SEQ) if col not in in_range]
        assert torch.equal(c.key[:, keep], k[:, keep])
        assert torch.equal(c.value[:, keep], v[:, keep])
        assert torch.equal(c.pos[:, keep], p[:, keep])
        for col in in_range:
            assert (c.pos[:, col] == col - start + 10).all()


def test_prefill_extend_chunks_equal_monolithic_prefill(pair):
    """A 13-token prompt prefilled in chunks of 5 through
    prefill_extend_step gives the monolithic prefill's hidden states and
    cache, and the JAX prefill's last logits."""
    jm, params, model = pair
    tokens = _tokens(4, (1, 13))
    with torch.no_grad():
        full_h, full_cache = tgen.prefill_step(model, torch.from_numpy(tokens).long(),
                                               torch.arange(13).expand(1, 13))
        cache = model.init_cache(1)
        hs = []
        for off in range(0, 13, 5):
            chunk = torch.zeros(1, 5, dtype=torch.long)
            take = min(5, 13 - off)
            chunk[0, :take] = torch.from_numpy(tokens[0, off:off + take]).long()
            pos = torch.where(torch.arange(5) < take, torch.arange(5) + off, -1)[None]
            h, cache = tgen.prefill_extend_step(model, cache, chunk, pos, torch.tensor([off]))
            hs.append(h[:, :take])
        chunked_h = torch.cat(hs, dim=1)
        logits = model.lm_head(chunked_h[:, -1])
    np.testing.assert_allclose(chunked_h.numpy(), full_h.numpy(), **TOL)
    for a, b in zip(cache, full_cache):
        assert torch.equal(a.pos, b.pos)
        np.testing.assert_allclose(a.key[:, :13].numpy(), b.key[:, :13].numpy(), **TOL)
    want = jm.apply({"params": params}, jnp.asarray(tokens), train=False)[0, -1]
    np.testing.assert_allclose(logits[0].numpy(), np.asarray(want), **TOL)


def _knobs():
    temp = np.array([0.0, 1.0, 0.7, 1.3, 0.0, 0.9], np.float32)
    topk = np.array([0, 1, 0, 5, 0, 0], np.int32)
    topp = np.array([0.0, 0.0, 1e-6, 0.8, 0.5, 0.0], np.float32)
    return temp, topk, topp


def _logits(seed=0, rows=6, vocab=64):
    return np.random.default_rng(seed).standard_normal((rows, vocab)).astype(np.float32) * 3


def test_filter_logits_matches_jax():
    logits = _logits()
    temp, topk, topp = _knobs()
    want = np.asarray(jspec.filter_logits(jnp.asarray(logits), jnp.asarray(temp),
                                          jnp.asarray(topk), jnp.asarray(topp)))
    got = filter_logits(torch.from_numpy(logits), torch.from_numpy(temp),
                        torch.from_numpy(topk).long(), torch.from_numpy(topp)).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got[np.isfinite(got)], want[np.isfinite(want)], **TOL)


def test_sample_tokens_deterministic_rows_and_sentinel():
    """Greedy rows, top_k=1 and a vanishing top_p are the argmax (the JAX
    sampler's token); a row holding NaN or Inf gives the sentinel; sampled
    rows stay inside their filter."""
    logits = _logits(1)
    logits[4, 7] = np.nan
    logits[5, 3] = np.inf
    temp, topk, topp = _knobs()
    want = np.asarray(jengine.sample_tokens(jnp.asarray(logits), jax.random.PRNGKey(0),
                                            jnp.asarray(temp), jnp.asarray(topk),
                                            jnp.asarray(topp)))
    gen = torch.Generator().manual_seed(0)
    for _ in range(5):
        got = sample_tokens(torch.from_numpy(logits), gen, torch.from_numpy(temp),
                            torch.from_numpy(topk).long(), torch.from_numpy(topp)).numpy()
        np.testing.assert_array_equal(got[[0, 1, 2, 4, 5]], want[[0, 1, 2, 4, 5]])
        assert got[0] == logits[0].argmax() and got[1] == logits[1].argmax()
        assert got[2] == logits[2].argmax()
        assert got[4] == got[5] == NON_FINITE_TOKEN
        assert got[3] in np.argsort(logits[3])[-5:]  # top_k=5 row


def test_padded_prefill_inputs_and_buckets():
    pos, last = tgen.padded_prefill_inputs([3, 5, 1], 5)
    np.testing.assert_array_equal(pos.numpy(), [[0, 1, 2, -1, -1], [0, 1, 2, 3, 4],
                                                [0, -1, -1, -1, -1]])
    np.testing.assert_array_equal(last.numpy(), [2, 4, 0])
    for seq_len in (1024, 32, 100):
        assert default_prefill_buckets(seq_len) == jengine.default_prefill_buckets(seq_len)
    assert default_prefill_buckets(1024) == (32, 64, 128, 256, 512, 1024)


# -- host-only modules: the bodies of the JAX package's tests -------------------

def test_scheduler_policies_host_only():
    sched = FIFOScheduler(SchedulerConfig(max_prefills_per_tick=2))
    outs = [RequestOutput(Request(prompt=[1]), arrival_time=float(i)) for i in range(5)]
    for out in outs:
        assert sched.submit(out)
    assert sched.depth == 5
    assert sched.schedule(n_free=4, now=10.0) == outs[:2]
    assert sched.schedule(n_free=1, now=10.0) == outs[2:3]
    timed = FIFOScheduler(SchedulerConfig(max_wait=5.0))
    old = RequestOutput(Request(prompt=[1]), arrival_time=0.0)
    new = RequestOutput(Request(prompt=[1]), arrival_time=8.0)
    timed.submit(old), timed.submit(new)
    assert timed.expire(now=9.0) == [old] and old.status == EXPIRED
    assert timed.schedule(4, 9.0) == [new]


def test_scheduler_injectable_clock():
    t = [0.0]
    sched = FIFOScheduler(SchedulerConfig(max_wait=5.0), clock=lambda: t[0])
    old = RequestOutput(Request(prompt=[1]), arrival_time=0.0)
    new = RequestOutput(Request(prompt=[1]), arrival_time=4.0)
    sched.submit(old), sched.submit(new)
    assert sched.expire() == []
    t[0] = 6.0
    assert sched.expire() == [old] and old.status == EXPIRED
    assert sched.schedule(4) == [new]


def test_scheduler_bucket_grouping():
    sched = FIFOScheduler(SchedulerConfig(max_prefills_per_tick=3))
    outs = [RequestOutput(Request(prompt=[1] * n), arrival_time=0.0) for n in [3, 9, 4, 2, 11]]
    for out in outs:
        sched.submit(out)
    key = lambda o: len(o.request.prompt) <= 4
    assert sched.schedule(8, 0.0, bucket_key=key) == [outs[0], outs[2], outs[3]]
    assert sched.schedule(8, 0.0, bucket_key=key) == [outs[1], outs[4]]
    assert sched.depth == 0


def test_prefix_cache_unit():
    pc = PrefixCache(max_entries=2)
    buckets = (4, 8)
    assert pc.lookup([1, 2, 3, 4, 5], buckets) is None
    assert pc.store([1, 2, 3, 4, 5], buckets, "rowA") == [4]
    assert pc.lookup([1, 2, 3, 4, 9], buckets) == ("rowA", 4)
    assert (pc.hits, pc.misses) == (1, 1)
    assert pc.lookup([1, 2, 3, 4, 5], buckets) == ("rowA", 4)
    pc.store(list(range(10, 19)), buckets, "rowB")
    assert len(pc) == 2 and pc.evictions == 1
    assert pc.lookup([1, 2, 3, 4, 9], buckets) is None
    assert pc.lookup(list(range(10, 19)), buckets) == ("rowB", 8)
    with pytest.raises(ValueError):
        PrefixCache(0)


def test_percentile_helper():
    assert percentile([], 50) is None
    assert percentile([3.0], 95) == 3.0
    assert percentile([1.0, 2.0, 3.0, 4.0], 50) == 2.5
    assert percentile([1.0, 2.0, 3.0, 4.0], 100) == 4.0


def test_metrics_empty_run_summary():
    m = ServingMetrics()
    s = m.summary()
    assert s["finished"] == 0 and s["ttft_ms_p95"] is None
    assert s["prefix_hit_rate"] is None and s["tokens_per_sec"] is None
    json.dumps(s)
    m.record_tick(now=1.0, queue_depth=0, occupancy=0.0, new_tokens=0, prefills=0,
                  decoded=False)
    json.dumps(m.summary())
    assert percentile([None, None], 50) is None
    assert percentile([1.0], 200.0) == 1.0


# -- the pool's row ops ----------------------------------------------------------

def _pool_and_fresh(pair, n_slots=3):
    _, _, model = pair
    pool = cache_pool.empty_pool(model, n_slots)
    _, fresh = _prefilled(pair, [5, 8, 3, 2], seed=5)
    return pool, fresh


def test_scatter_drops_dummy_rows_in_place(pair):
    pool, fresh = _pool_and_fresh(pair)
    ptrs = [(c.key_store.data_ptr(), c.pos_store.data_ptr()) for c in pool]
    before = [c.pos.clone() for c in pool]
    cache_pool.scatter_rows(pool, fresh, [2, 3, 0, 7])  # rows 1 and 3: out of range
    for c, f, b, ptr in zip(pool, fresh, before, ptrs):
        assert (c.key_store.data_ptr(), c.pos_store.data_ptr()) == ptr
        assert torch.equal(c.key[2], f.key[0]) and torch.equal(c.pos[0], f.pos[2])
        assert torch.equal(c.pos[1], b[1])


def test_copy_stack_clear_and_extract(pair):
    pool, fresh = _pool_and_fresh(pair)
    cache_pool.insert_rows(pool, fresh, 1)
    row = cache_pool.extract_rows(pool, 1)
    assert row[0].key_store.data_ptr() != pool[0].key_store.data_ptr()
    assert torch.equal(row[0].pos[0], fresh[0].pos[0])
    cache_pool.copy_prefix_rows(pool, row, 2, 3)
    for c in pool:
        assert c.pos[2, :3].tolist() == [0, 1, 2] and (c.pos[2, 3:] == -1).all()
        assert torch.equal(c.key[2], c.key[1])
    stacked = cache_pool.stack_prefix_rows([row, row], 4)
    assert stacked[0].pos.shape == (2, SEQ)
    assert stacked[0].pos[:, :4].tolist() == [[0, 1, 2, 3]] * 2 and (stacked[0].pos[:, 4:] == -1).all()
    cache_pool.clear_rows(pool, 1)
    assert all((c.pos[1] == -1).all() for c in pool)
    pool_obj = cache_pool.CachePool(pair[2], 2)
    assert [pool_obj.acquire(), pool_obj.acquire(), pool_obj.acquire()] == [0, 1, None]
    pool_obj.release(1)
    with pytest.raises(ValueError):
        pool_obj.release(1)
    pool_obj.assert_slot_aligned(0)
