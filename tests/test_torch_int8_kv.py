"""Port parity for the int8 KV cache (``kv_cache_dtype="int8"``).

- ``decode_attention``'s int8-native read (payloads with K and V scales)
  against JAX's on random int8 inputs;
- static ``generate()`` greedy tokens equal to JAX's over scanned, GQA and
  unrolled configs, and the cache after the prefill and one decode step:
  payloads equal except at elements within 1e-4 of a .5 boundary (the
  port's fp32 K/V may differ from JAX's in the last bit, which can move
  such an element across it; those are counted), scales to rtol 2e-6
  (the worst seen is 1.13e-6: a K that differs from JAX's by about one ulp
  after two layers of GEMMs summed in another order);
- the JAX package's int8 cases (``tests/test_generate.py``,
  ``test_serving.py``, ``test_paged_kv.py``, ``test_spec_decode.py``) re-run
  on the port, against its static int8 ``generate()``;
- the KV exchange of an int8 pool: the same prompt's export through both
  packages' engines (meta equal, positions exact, payloads and scales as
  above), and the same blocks' bytes, checksums and ``KVW1`` frames
  byte-identical across the two packages' pools and codecs.

``tiny_test`` in fp32 on the CPU, weights bridged from a flax init, inputs
from numpy seeds.  The JAX side is imported inside fixtures, so the ``gpu``
cases at the end run on the card without JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_int8_kv.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from tpu_parallel_torch.models import GPTLM, tiny_test
from tpu_parallel_torch.models import layers
from tpu_parallel_torch.models.generate import decode_step, generate, prefill_step
from tpu_parallel_torch.serving import (
    FINISHED,
    PagedCachePool,
    Request,
    SchedulerConfig,
    ServingEngine,
)
from tpu_parallel_torch.serving.cache_pool import block_checksums
from tpu_parallel_torch.serving.kv_wire import decode_export, encode_export
from tpu_parallel_torch.serving.spec_decode import generate_speculative

# one torch intra-op thread per test process: under pytest-xdist several
# processes share the cores, and torch's default (a thread per core in each)
# oversubscribes them
torch.set_num_threads(1)

VOCAB = 256
INT8 = dict(kv_cache_dtype="int8")
# fp32 scales, port against JAX (see the module docstring)
SCALE_RTOL = 2e-6
CONFIGS = {"scanned": dict(), "gqa": dict(n_kv_heads=2), "unrolled": dict(scan_layers=False)}


@pytest.fixture(scope="module")
def bridged():
    """config name -> (JAX model, params, port model) of an int8-cache
    ``tiny_test``, one flax init bridged into the port, built once each."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from tpu_parallel.models import GPTLM as JaxGPTLM
    from tpu_parallel.models import tiny_test as jax_tiny_test
    from tpu_parallel_torch.models.convert import params_from_jax

    made = {}

    def get(name):
        if name not in made:
            kw = dict(CONFIGS[name], **INT8)
            jm = JaxGPTLM(jax_tiny_test(dtype=jnp.float32, remat=False, **kw))
            params = jm.init({"params": jax.random.PRNGKey(1)}, jnp.zeros((1, 5), jnp.int32),
                             train=False)["params"]
            cfg = tiny_test(**kw)
            model = GPTLM(cfg, device="cpu")
            model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), cfg))
            made[name] = (jm, params, model.eval())
        return made[name]

    return get


@pytest.fixture(scope="module")
def model(bridged):
    return bridged("scanned")[2]


def _prompts(seed, lens):
    rs = np.random.default_rng(seed)
    return [[int(t) for t in rs.integers(1, VOCAB, n)] for n in lens]


def _ref(model, prompt, n):
    return generate(model, torch.tensor([prompt]), max_new_tokens=n)[0].tolist()


# -- decode_attention's int8-native read ----------------------------------------------


@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("kv_heads", [4, 2])
def test_decode_attention_scales_match_jax(kv_heads, window):
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from tpu_parallel.models.layers import decode_attention as jax_decode_attention

    rs = np.random.default_rng(kv_heads + window)
    b, nq, h, s, d = 3, 2, 4, 12, 8
    q = rs.standard_normal((b, nq, h, d)).astype(np.float32)
    k = rs.integers(-127, 128, (b, s, kv_heads, d)).astype(np.int8)
    v = rs.integers(-127, 128, (b, s, kv_heads, d)).astype(np.int8)
    ks = (rs.random((b, s, kv_heads, 1)) * 0.05).astype(np.float32)
    vs = (rs.random((b, s, kv_heads, 1)) * 0.05).astype(np.float32)
    ks[:, 3] = 0.0  # an all-zero group
    k_pos = np.tile(np.arange(s, dtype=np.int32), (b, 1))
    k_pos[1, :4] = -1  # a ragged row
    positions = np.array([[9, 10], [10, 11], [5, 6]], np.int32)
    want = jax_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(positions), window=window,
        k_positions=jnp.asarray(k_pos), k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    heads = lambda x: torch.from_numpy(x).permute(2, 0, 1, 3).contiguous()
    got = layers.decode_attention(
        torch.from_numpy(q), heads(k), heads(v), torch.from_numpy(positions), window=window,
        k_positions=torch.from_numpy(k_pos), k_scale=heads(ks), v_scale=heads(vs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


# -- static generate() and its cache against JAX ----------------------------------------


def _jax_leaves(cache, n_layers, scanned):
    """layer -> {leaf name: numpy array [b, S, ...]} of a flax cache."""
    import jax

    out = [dict() for _ in range(n_layers)]
    for path, x in jax.tree_util.tree_leaves_with_path(cache):
        keys = [p.key for p in path]
        name = keys[-1]
        if not name.startswith("cached_"):
            continue
        if scanned:
            for i in range(n_layers):
                out[i][name] = np.asarray(x[i])
        else:
            out[int(keys[1].split("_")[1])][name] = np.asarray(x)
    return out


def _port_leaves(cache):
    logical = lambda h: h.permute(1, 2, 0, 3).numpy()
    return [dict(cached_key=logical(c.key_heads), cached_value=logical(c.value_heads),
                 cached_key_scale=logical(c.heads()[2]), cached_value_scale=logical(c.heads()[3]),
                 cached_pos=c.pos.numpy()) for c in cache]


def _hold_cache(port, want, written):
    """Payloads equal except elements within 1e-4 of a .5 boundary of the
    port's own fp32 ratio (``written``: the K/V each layer's write
    quantized, [b, t, kv_heads, head_dim] at columns [0, t)); scales rtol
    2e-6; positions exact.  Returns the count of boundary elements that
    differ."""
    flipped = 0
    for layer, (got, ref) in enumerate(zip(port, want)):
        np.testing.assert_array_equal(got["cached_pos"], ref["cached_pos"])
        for name, scale_name, new in (("cached_key", "cached_key_scale", written[layer][0]),
                                      ("cached_value", "cached_value_scale", written[layer][1])):
            np.testing.assert_allclose(got[scale_name], ref[scale_name], rtol=SCALE_RTOL,
                                       atol=0, err_msg=f"{scale_name} layer {layer}")
            differ = got[name] != ref[name]
            t = new.shape[1]
            scale = got[scale_name][:, :t]
            ratio = np.abs(new / np.where(scale > 0, scale, 1.0))
            near = np.zeros_like(differ)
            near[:, :t] = np.abs(ratio - np.floor(ratio) - 0.5) < 1e-4
            assert not (differ & ~near).any(), f"{name} layer {layer}: off a .5 boundary"
            assert (np.abs(got[name].astype(int) - ref[name].astype(int)) <= 1).all()
            flipped += int(differ.sum())
    return flipped


@pytest.fixture
def record_writes(monkeypatch):
    """The fp32 K/V each cache write quantizes, in call order."""
    calls = []
    original = layers._kv_entries

    def recording(quantized, k, v):
        calls.append((k.detach().numpy().copy(), v.detach().numpy().copy()))
        return original(quantized, k, v)

    monkeypatch.setattr(layers, "_kv_entries", recording)
    return calls


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_static_int8_generate_and_cache_match_jax(bridged, record_writes, config):
    import jax.numpy as jnp

    from tpu_parallel.models.generate import generate as jax_generate

    jm, params, model = bridged(config)
    cfg = model.config
    prompt = np.random.default_rng(11).integers(1, VOCAB, (2, 7)).astype(np.int32)
    want = np.asarray(jax_generate(jm, params, jnp.asarray(prompt), max_new_tokens=8))
    record_writes.clear()
    got = generate(model, torch.from_numpy(prompt).long(), max_new_tokens=8).numpy()
    np.testing.assert_array_equal(got, want)

    # the prefill's cache, then one decode step's
    logits, jv = jm.apply({"params": params}, jnp.asarray(prompt), train=False, decode=True,
                          mutable=["cache"])
    record_writes.clear()
    with torch.inference_mode():
        _, cache = prefill_step(model, torch.from_numpy(prompt).long(),
                                torch.arange(7).expand(2, 7))
    written = [(k, v) for k, v in record_writes]
    flips = _hold_cache(_port_leaves(cache), _jax_leaves(jv["cache"], cfg.n_layers,
                                                         cfg.scan_layers), written)
    nxt = np.asarray(jnp.argmax(logits[:, -1], axis=-1)).astype(np.int32)
    _, jv = jm.apply({"params": params, **jv}, jnp.asarray(nxt)[:, None], train=False,
                     decode=True, mutable=["cache"])
    record_writes.clear()
    with torch.inference_mode():
        decode_step(model, cache, torch.from_numpy(nxt).long(), torch.full((2,), 7))
    # each layer's stored columns [0, 8): the prefill's 7, then the step's
    written = [(np.concatenate([a[0], b[0]], axis=1), np.concatenate([a[1], b[1]], axis=1))
               for a, b in zip(written, record_writes)]
    flips += _hold_cache(_port_leaves(cache), _jax_leaves(jv["cache"], cfg.n_layers,
                                                          cfg.scan_layers), written)
    assert flips <= 4, f"{flips} payload elements crossed a .5 boundary"


# -- the JAX package's int8 cases, on the port --------------------------------------------


def test_generate_int8_kv_cache_close_to_bf16(model):
    """The int8 cache's prefill and decode logits stay close to the exact
    cache's (tests/test_generate.py's tolerance)."""
    exact = GPTLM(tiny_test(), device="cpu")
    exact.load_state_dict(model.state_dict())
    prompt = torch.from_numpy(np.random.default_rng(3).integers(0, VOCAB, (2, 5))).long()
    out = {}
    with torch.inference_mode():
        for name, m in (("int8", model), ("exact", exact)):
            cache = m.init_cache(2)
            pre = m(prompt, decode=True, cache=cache)[:, -1]
            out[name] = (pre, cache)
        nxt = out["exact"][0].argmax(-1)
        steps = {name: m(nxt[:, None], decode=True, cache=out[name][1])[:, -1]
                 for name, m in (("int8", model), ("exact", exact))}
    np.testing.assert_allclose(out["int8"][0].numpy(), out["exact"][0].numpy(), rtol=0.1,
                               atol=0.05)
    np.testing.assert_allclose(steps["int8"].numpy(), steps["exact"].numpy(), rtol=0.1, atol=0.05)


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_int8_kv_cache_halves_storage(layout):
    """The int8 cache's bytes (payloads, scales, positions) are under 0.65x
    of 2 bytes per K/V element, at head_dim 64."""
    paged = dict(kv_block_tokens=8, kv_pool_blocks=8) if layout == "paged" else {}
    cfg = tiny_test(d_model=256, n_heads=4, **INT8, **paged)
    cache = GPTLM(cfg, device="cpu").init_cache(1)
    total = sum(s.nbytes for c in cache for s in c.stores + [c.pos_store])
    kv_elems = sum(s.numel() for c in cache for s in c.stores if s.dtype == torch.int8)
    assert kv_elems > 0
    assert total < 0.65 * kv_elems * 2, (total, kv_elems * 2)


def _engine(model, prompts, budgets, staggered=False, **kw):
    eng = ServingEngine(model, scheduler=SchedulerConfig(max_prefills_per_tick=2), **kw)
    first = 2 if staggered else len(prompts)
    outs = [eng.add_request(Request(prompt=p, max_new_tokens=n))
            for p, n in zip(prompts[:first], budgets[:first])]
    if staggered:
        eng.step(), eng.step()
        outs += [eng.add_request(Request(prompt=p, max_new_tokens=n))
                 for p, n in zip(prompts[first:], budgets[first:])]
    eng.run()
    return eng, outs


def test_engine_int8_cache_matches_static_int8(model):
    prompts = _prompts(20, [6, 6])
    eng, outs = _engine(model, prompts, [6, 6], n_slots=2)
    for p, o in zip(prompts, outs):
        assert o.tokens == _ref(model, p, 6)


def test_prefix_reuse_int8_cache_exact(model):
    """Prefix reuse and bucketing over an int8 cache: copied quantized rows
    (scales with them) give the static int8 reference."""
    rs = np.random.default_rng(21)
    head = [int(t) for t in rs.integers(1, VOCAB, 8)]
    prompts = [head + [int(t) for t in rs.integers(1, VOCAB, n)] for n in (3, 5, 4, 6)]
    eng = ServingEngine(model, n_slots=2, scheduler=SchedulerConfig(max_prefills_per_tick=2),
                        prefill_buckets=(8, 16), prefix_cache_size=2)
    outs = [eng.add_request(Request(prompt=p, max_new_tokens=6)) for p in prompts]
    eng.run()
    for p, o in zip(prompts, outs):
        assert o.tokens == _ref(model, p, 6)
    assert eng.metrics.prefix_hits >= 2


@pytest.mark.parametrize("mode", ["fused", "unified_chunked", "overlap"])
def test_fused_tick_int8_parity(model, mode):
    """Fused ticks over the int8 cache (per phase, unified with chunks, and
    under ``run(overlap=True)``) equal the per-step int8 engine and the
    static reference."""
    prompts = _prompts(22, [5, 11, 3])
    budgets = [9, 7, 9]
    kw = dict(n_slots=2, prefill_buckets=(4, 8, 16))
    if mode == "unified_chunked":
        kw.update(prefill_chunk_tokens=4)
    _, plain = _engine(model, prompts, budgets, decode_steps_per_tick=1, **kw)
    eng = ServingEngine(model, scheduler=SchedulerConfig(max_prefills_per_tick=2),
                        decode_steps_per_tick=4, unified_tick=mode != "fused", **kw)
    fused = [eng.add_request(Request(prompt=p, max_new_tokens=n))
             for p, n in zip(prompts, budgets)]
    eng.run(overlap=mode == "overlap")
    for p, n, a, b in zip(prompts, budgets, plain, fused):
        assert a.tokens == b.tokens == _ref(model, p, n)
    if mode == "unified_chunked":
        assert eng.metrics.prefill_chunks > 0


def test_paged_int8_parity(model):
    """The paged int8 pool (blocks shared, copied on write, scales with
    them) equals the fixed-slot int8 engine, staggered."""
    prompts = _prompts(23, [3, 9, 6, 12, 5])
    budgets = [6, 5, 7, 4, 6]
    _, fixed = _engine(model, prompts, budgets, staggered=True, n_slots=2)
    eng, paged = _engine(model, prompts, budgets, staggered=True, n_slots=2, kv_block_tokens=4)
    assert [o.tokens for o in fixed] == [o.tokens for o in paged]
    eng.pool.allocator.check()
    assert eng.pool.blocks_in_use == 0
    assert eng.pool.cache[0].key_store.dtype == torch.int8


def test_generate_speculative_int8_cache_parity(model):
    prompt = torch.from_numpy(np.random.default_rng(24).integers(1, VOCAB, (2, 5))).long()
    want = generate(model, prompt, max_new_tokens=8)
    got = generate_speculative(model, prompt, max_new_tokens=8, draft_tokens=3)
    assert torch.equal(got, want)


def test_spec_engine_int8_cache_parity(model):
    prompts = _prompts(25, [6, 6])
    eng, outs = _engine(model, prompts, [8, 8], n_slots=2, draft_tokens=3)
    for p, o in zip(prompts, outs):
        assert o.tokens == _ref(model, p, 8)


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_spec_fused_tick_bitwise_int8(model, layout):
    """Fused speculative verify over the int8 cache: bitwise the per-step
    spec engine's tokens across staggered arrivals, budgets ending
    mid-block."""
    prompts = _prompts(26, [3, 9, 6, 12, 5])
    budgets = [6, 5, 9, 3, 7]
    kw = dict(n_slots=2, prefill_buckets=(4, 8, 16), draft_tokens=3)
    if layout == "paged":
        kw["kv_block_tokens"] = 4
    step_eng, stepped = _engine(model, prompts, budgets, staggered=True,
                                decode_steps_per_tick=1, **kw)
    fused_eng, fused = _engine(model, prompts, budgets, staggered=True,
                               decode_steps_per_tick=4, **kw)
    for a, b in zip(stepped, fused):
        assert a.status == b.status == FINISHED and a.tokens == b.tokens
    assert fused_eng.metrics.host_dispatches < step_eng.metrics.host_dispatches
    assert fused_eng.metrics.tokens_drafted > 0


# -- the KV exchange of an int8 pool -----------------------------------------------------


def test_int8_export_matches_jax(bridged):
    """The same prompt exported mid-flight by both packages' paged int8
    engines: the same meta (five leaves per layer), positions exact,
    payloads within one step, scales to rtol 2e-6.  Each export landed in
    the other package's pool and exported again gives the same bytes, the
    same checksums, and the same ``KVW1`` frame from both codecs; the
    JAX engine's export imported into the port's engine continues to the
    JAX engine's tokens."""
    from tpu_parallel import serving as jserving
    from tpu_parallel.serving import PagedCachePool as JaxPool
    from tpu_parallel.serving import kv_wire as jax_wire
    from tpu_parallel.serving.cache_pool import block_checksums as jax_checksums

    jm, params, model = bridged("scanned")
    prompt = _prompts(27, [14])[0]
    kw = dict(n_slots=2, decode_steps_per_tick=1, kv_block_tokens=4, prefix_cache_size=16,
              kv_radix_cache=True, clock=lambda: 0.0)
    exports, delivered, refs = {}, {}, {}
    for name, api, make in (("jax", jserving, lambda: jserving.ServingEngine(jm, params, **kw)),
                            ("port", None, lambda: ServingEngine(model, **kw))):
        req = (api.Request if api else Request)
        base = make()
        ref = base.add_request(req(request_id="base", prompt=prompt, max_new_tokens=10))
        base.run(max_ticks=200)
        refs[name] = list(ref.tokens)
        eng = make()
        out = eng.add_request(req(request_id="mid", prompt=prompt, max_new_tokens=10))
        for _ in range(5):
            eng.step()
        exports[name] = eng.export_prefix("mid")
        delivered[name] = list(out.tokens)
    je, pe = exports["jax"], exports["port"]
    assert refs["jax"] == refs["port"] and je.tokens == pe.tokens
    assert je.meta == pe.meta and [m[0] for m in pe.meta] == [
        "cached_key", "cached_key_scale", "cached_pos", "cached_value", "cached_value_scale"]
    for (name, _, dtype), j, p in zip(pe.meta, je.leaves, pe.leaves):
        j = np.asarray(j)
        assert str(p.dtype) == str(j.dtype) == dtype
        if name.endswith("_scale"):
            np.testing.assert_allclose(p, j, rtol=SCALE_RTOL, atol=0)
        elif name == "cached_pos":
            np.testing.assert_array_equal(p, j)
        else:
            assert (np.abs(p.astype(int) - j.astype(int)) <= 1).all()
            assert (p != j).sum() <= 4

    # the same blocks through each package's pool and codec: byte-identical
    n = je.length // je.block_tokens
    port_pool = PagedCachePool(model, 2, block_tokens=4, n_blocks=8)
    jax_pool = JaxPool(type(jm)(dataclasses.replace(jm.config, kv_block_tokens=4,
                                                    kv_pool_blocks=8)), params, 2)
    for export in (je, pe):
        leaves = [np.asarray(x) for x in export.leaves]
        again = port_pool.export_blocks(list(port_pool.import_stored(
            leaves, n, checksums=export.checksums)))
        jagain = [np.asarray(x) for x in jax_pool.export_blocks(
            list(jax_pool.import_stored(leaves, n, checksums=export.checksums)))]
        for a, b, c in zip(again, jagain, leaves):
            assert a.dtype == c.dtype and a.tobytes() == b.tobytes() == c.tobytes()
        assert block_checksums(again, n) == jax_checksums(jagain, n) == tuple(export.checksums)
        frame = encode_export(export)
        assert frame[:4] == b"KVW1" and frame == jax_wire.encode_export(export)

    # the JAX engine's prefix, through the wire, continues on the port
    moved = decode_export(jax_wire.encode_export(je))
    b = ServingEngine(model, **kw)
    assert b.import_prefix(moved) == "imported"
    cont = b.add_request(Request(request_id="cont", prompt=prompt + delivered["jax"],
                                 max_new_tokens=10 - len(delivered["jax"])))
    b.run(max_ticks=200)
    assert cont.status == FINISHED
    assert delivered["jax"] + list(cont.tokens) == refs["jax"]
    b.pool.allocator.check()


@pytest.mark.parametrize("tiers", ["host", "host_disk"])
def test_int8_hierarchy_spills_and_restores(model, tmp_path, tiers):
    """An int8 pool under a radix cache with a host tier (and a disk tier):
    its five-leaf exports spill and restore through each tier (and a disk
    directory boots a fresh engine), and the greedy tokens equal the
    engine's without the hierarchy."""
    kw = dict(n_slots=2, scheduler=SchedulerConfig(max_prefills_per_tick=2),
              decode_steps_per_tick=1, kv_block_tokens=4)
    knobs = dict(prefix_cache_size=2, kv_radix_cache=True, kv_host_blocks=16)
    if tiers == "host_disk":
        knobs.update(kv_host_blocks=2, kv_disk_blocks=32, kv_disk_dir=str(tmp_path / "kv"))
    rs = np.random.RandomState(3)
    headers = [[int(t) for t in rs.randint(1, VOCAB, 8)] for _ in range(3)]
    visits = [h for h in headers for _ in (0, 1)] + headers

    def run(eng):
        outs = []
        for i, h in enumerate(visits):
            out = eng.add_request(Request(request_id=f"a{i}", prompt=h + [7, 9],
                                          max_new_tokens=4))
            eng.run(max_ticks=200)
            outs.append(list(out.tokens))
        return outs

    want = run(ServingEngine(model, **kw))
    eng = ServingEngine(model, **kw, **knobs)
    assert run(eng) == want
    radix = eng._radix
    assert radix.hits > 0 and radix.restored_blocks > 0
    eng.pool.allocator.check()
    if tiers == "host_disk":
        assert radix.disk_spills > 0 and radix.disk_restores > 0
        warm = ServingEngine(model, **kw, **knobs)  # boots from the same directory
        out = warm.add_request(Request(request_id="w", prompt=headers[0] + [7, 9],
                                       max_new_tokens=4))
        warm.run(max_ticks=200)
        assert list(out.tokens) == want[0] and warm._radix.disk_restores > 0


# -- on the card ------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the captured ticks have no CPU mode")
    return torch.device("cuda")


def _card_run(model, eager, **kw):
    eng = ServingEngine(model, n_slots=4, scheduler=SchedulerConfig(max_prefills_per_tick=4),
                        prefill_buckets=(8, 16), **kw)
    if eager:
        eng._run_fused_eagerly()
    outs = [eng.add_request(Request(prompt=p, max_new_tokens=n))
            for p, n in zip(_prompts(31, [5, 9, 3, 7, 12, 4]), [13, 9, 11, 6, 8, 10])]
    eng.run()
    return [o.tokens for o in outs], eng


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["fused", "unified", "paged_unified", "spec_fused"])
def test_int8_captured_ticks_equal_per_step(cuda, mode):
    """On the card: each captured int8 tick gives bitwise the per-step int8
    engine's greedy tokens and the eager body's, each graph captured."""
    model = GPTLM(tiny_test(seq_len=64, **INT8), device="cuda", seed=5).eval()
    kw = dict(decode_steps_per_tick=4, unified_tick=mode != "fused")
    if mode in ("unified", "paged_unified"):
        kw["prefill_chunk_tokens"] = 8
    if mode == "paged_unified":
        kw["kv_block_tokens"] = 8
    if mode == "spec_fused":
        kw["draft_tokens"] = 3
    step_kw = dict(kw, decode_steps_per_tick=1, unified_tick=False)
    per_step, _ = _card_run(model, True, **step_kw)
    eager, e_eng = _card_run(model, True, **kw)
    graph, g_eng = _card_run(model, False, **kw)
    assert e_eng.graph_captures == 0 and g_eng.graph_captures >= 1
    assert graph == eager == per_step
