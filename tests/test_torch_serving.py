"""Port parity: the continuous-batching ``ServingEngine`` against
``tpu_parallel.serving.ServingEngine``.

``tiny_test`` in fp32 on the CPU, weights bridged from a flax init with
``models/convert.py:params_from_jax``, prompts from a numpy seed.  Each
case drives both engines through the same script (same requests, ids,
arrival ticks and an injected clock) and holds the port to the JAX engine
exactly: every request's status, ``finish_reason`` and tokens, and the
sequence of ``StreamEvent``s (request id, token, index, finished,
reason).  Both engines run at their defaults (``unified_tick="auto"``:
the unified ragged tick whenever the fused tick is on); the
``*_per_phase`` cases pin both to ``unified_tick=False``.  Sampled tokens are not compared
across the two (a ``torch.Generator`` does not give JAX's random bits);
the port-only cases check them.

The JAX side is imported inside fixtures, so the ``gpu`` cases at the end
run on the card without JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_serving.py
"""

import copy
import types

import numpy as np
import pytest
import torch

from tpu_parallel_torch.models import GPTLM, tiny_test
from tpu_parallel_torch.serving import (
    CANCELLED,
    EXPIRED,
    FAIL_INTEGRITY,
    FAILED,
    FINISHED,
    REJECTED,
    Request,
    SamplingParams,
    SchedulerConfig,
    ServingEngine,
)

# one torch intra-op thread per test process: under pytest-xdist several
# processes share the cores, and torch's default (a thread per core in each)
# oversubscribes them
torch.set_num_threads(1)

VOCAB = 256


def _prompts(seed, lens):
    rs = np.random.default_rng(seed)
    return [[int(t) for t in rs.integers(1, VOCAB, n)] for n in lens]


def _shared_prefix_prompts(seed, prefix_len, suffix_lens):
    rs = np.random.default_rng(seed)
    prefix = [int(t) for t in rs.integers(1, VOCAB, prefix_len)]
    return [prefix + [int(t) for t in rs.integers(1, VOCAB, n)] for n in suffix_lens]


@pytest.fixture(scope="module")
def pair():
    """(JAX side, port side, port model): one flax init bridged into the
    port's GPTLM; the JAX model object is shared so its engine jits are."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from tpu_parallel.models import GPTLM as JaxGPTLM
    from tpu_parallel.models import tiny_test as jax_tiny_test
    from tpu_parallel import serving as jserving
    from tpu_parallel_torch.models.convert import params_from_jax
    from tpu_parallel_torch import serving as tserving

    built = {}

    def bridged(overrides):
        """(JAX model, params, port model) of tiny_test(**overrides), one
        flax init bridged into the port, built once per config."""
        key = tuple(sorted(overrides.items()))
        if key not in built:
            jm = JaxGPTLM(jax_tiny_test(dtype=jnp.float32, remat=False, **overrides))
            params = jm.init({"params": jax.random.PRNGKey(1)}, jnp.zeros((1, 5), jnp.int32),
                             train=False)["params"]
            cfg = tiny_test(**overrides)
            model = GPTLM(cfg, device="cpu")
            model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), cfg))
            built[key] = (jm, params, model.eval())
        return built[key]

    def sides(**overrides):
        jm, params, model = bridged(overrides)
        jax_side = types.SimpleNamespace(
            api=jserving, make=lambda m=None, **kw: jserving.ServingEngine(
                jm, params if m is None else m, **_with_clock(kw)),
            poisoned=jax.tree_util.tree_map(
                lambda x: jnp.full_like(x, jnp.nan) if jnp.issubdtype(x.dtype, jnp.floating)
                else x, params),
            own_weights=lambda: params,
            variant=lambda **o: sides(**o)[0],
        )
        port_side = types.SimpleNamespace(
            api=tserving, make=lambda m=None, **kw: tserving.ServingEngine(
                model if m is None else m, **_with_clock(kw)),
            poisoned=_poisoned(model),
            own_weights=lambda: copy.deepcopy(model),
            variant=lambda **o: sides(**o)[1],
        )
        return jax_side, port_side, model

    return sides()


def _with_clock(kw):
    """Engine kwargs with an injected clock: the case's own, or one frozen
    at 0 (time only feeds expiry and the metrics)."""
    return {"clock": lambda: 0.0, **kw}


def _poisoned(model):
    """A copy of ``model`` with every weight NaN."""
    bad = copy.deepcopy(model)
    with torch.no_grad():
        for p in bad.parameters():
            p.fill_(float("nan"))
    return bad


def _record(outs, events):
    """What the two engines must agree on."""
    return (
        [(o.status, o.finish_reason, list(o.tokens)) for o in outs],
        [(e.request_id, e.token, e.index, e.finished, e.finish_reason) for e in events],
    )


def _req(side, prompt, n, rid, **kw):
    return side.api.Request(prompt=prompt, max_new_tokens=n, request_id=rid, **kw)


def _mixed_on(**overrides):
    """A mixed script on a variant config: staggered arrivals, chunked
    prefill folded into the fused tick, prompts across the window."""
    def case(side):
        return _staggered(side.variant(**overrides), _prompts(15, [3, 14, 9, 11, 6]),
                          [10, 8, 12, 6, 9], n_slots=2, prefill_buckets=(4, 8, 16),
                          prefill_chunk_tokens=5)
    return case


def case_seq_len_prompts_chunked_paged(side):
    """Prompts whose prompt + budget fill seq_len exactly (the last
    logical block and column), chunked, over the paged pool."""
    prompts = _prompts(16, [31, 29, 24, 17])
    eng = side.make(n_slots=2, scheduler=side.api.SchedulerConfig(max_prefills_per_tick=2),
                    prefill_buckets=(8, 16, 32), prefill_chunk_tokens=6,
                    kv_block_tokens="auto")
    outs = [eng.add_request(_req(side, p, 32 - len(p), f"r{i}")) for i, p in enumerate(prompts)]
    return outs, eng.run()


def case_top_k_1_beside_greedy(side):
    """Temperature-1 requests with top_k=1 (their filter leaves the argmax)
    share fused ticks with greedy ones: deterministic on both sides."""
    prompts = _prompts(17, [4, 7, 5, 9])
    eng = side.make(n_slots=4, scheduler=side.api.SchedulerConfig(max_prefills_per_tick=4),
                    decode_steps_per_tick=4)
    knobs = [dict(), dict(temperature=1.0, top_k=1)]
    outs = [eng.add_request(_req(side, p, 10, f"r{i}",
                                 sampling=side.api.SamplingParams(**knobs[i % 2])))
            for i, p in enumerate(prompts)]
    return outs, eng.run()


def _per_phase(case):
    """``case`` with both engines pinned to the per-phase tick."""
    def pinned(side):
        make = side.make
        return case(types.SimpleNamespace(
            **{**vars(side), "make": lambda m=None, **kw: make(m, unified_tick=False, **kw)}))
    return pinned


# -- the cases: each drives one engine through a script and returns
#    (outputs, events); the same script runs on both sides --------------------

def _staggered(side, prompts, budgets, **kw):
    """Two requests, two ticks, a third, one tick, the rest, then run."""
    eng = side.make(scheduler=side.api.SchedulerConfig(max_prefills_per_tick=2), **kw)
    outs = [eng.add_request(_req(side, prompts[i], budgets[i], f"r{i}")) for i in (0, 1)]
    events = eng.step() + eng.step()
    outs.append(eng.add_request(_req(side, prompts[2], budgets[2], "r2")))
    events += eng.step()
    for i in range(3, len(prompts)):
        outs.append(eng.add_request(_req(side, prompts[i], budgets[i], f"r{i}")))
    events += eng.run()
    return outs, events


def case_simultaneous(side):
    prompts = _prompts(1, [5, 5, 5])
    eng = side.make(n_slots=4, scheduler=side.api.SchedulerConfig(max_prefills_per_tick=3))
    outs = [eng.add_request(_req(side, p, 8, f"r{i}")) for i, p in enumerate(prompts)]
    return outs, eng.run()


def case_staggered_pool_of_2(side):
    prompts = _prompts(2, [3, 5, 4, 6])
    eng = side.make(n_slots=2)
    outs = [eng.add_request(_req(side, prompts[i], n, f"r{i}")) for i, n in ((0, 6), (1, 4))]
    events = eng.step() + eng.step()
    outs.append(eng.add_request(_req(side, prompts[2], 8, "r2")))
    events += eng.step() + eng.step()
    outs.append(eng.add_request(_req(side, prompts[3], 5, "r3")))
    return outs, events + eng.run()


def case_bucketed_staggered(side):
    return _staggered(side, _prompts(3, [3, 9, 6, 14, 11]), [6, 4, 8, 5, 6], n_slots=2,
                      prefill_buckets=(4, 8, 16))


def _chunked(chunk):
    def case(side):
        prompts = _prompts(4, [9, 13, 4])
        eng = side.make(n_slots=2, scheduler=side.api.SchedulerConfig(max_prefills_per_tick=2),
                        prefill_buckets=(4, 8, 16), prefill_chunk_tokens=chunk)
        outs = [eng.add_request(_req(side, p, 6, f"r{i}")) for i, p in enumerate(prompts)]
        return outs, eng.run()
    return case


def case_prefix_reuse(side):
    prompts = _shared_prefix_prompts(5, 8, [3, 6, 2, 9, 5])
    eng = side.make(n_slots=2, scheduler=side.api.SchedulerConfig(max_prefills_per_tick=2),
                    prefill_buckets=(8, 16), prefix_cache_size=4)
    outs = [eng.add_request(_req(side, prompts[i], 6, f"r{i}")) for i in (0, 1)]
    events = eng.step() + eng.step()
    for i in range(2, 5):
        outs.append(eng.add_request(_req(side, prompts[i], 6, f"r{i}")))
    events += eng.run()
    return outs, events


def case_fused_t4_mid_block_budgets(side):
    return _staggered(side, _prompts(6, [3, 9, 6, 12, 5]), [6, 5, 9, 3, 7], n_slots=2,
                      prefill_buckets=(4, 8, 16), decode_steps_per_tick=4)


def _fused_eos_mid_block(steps):
    def case(side):
        prompt = _prompts(7, [4])[0]
        # the EOS id is the token greedy decoding emits 5th (index 4): a T=8
        # block spans it mid-scan
        probe = side.make(n_slots=1, decode_steps_per_tick=1)
        ref = probe.add_request(_req(side, prompt, 12, "probe"))
        probe.run()
        eos = next(t for i, t in enumerate(ref.tokens) if i >= 2 and t not in ref.tokens[:i])
        eng = side.make(n_slots=1, decode_steps_per_tick=steps)
        outs = [eng.add_request(_req(side, prompt, 12, "r0", eos_token_id=eos))]
        events = eng.run()
        # the slot is reusable and unpolluted after the mid-block retire
        outs.append(eng.add_request(_req(side, prompt, 4, "r1")))
        return outs, events + eng.run()
    return case


def case_fused_chunked_interleave(side):
    short, long = _prompts(8, [3, 12])
    eng = side.make(n_slots=2, prefill_buckets=(4, 8, 16), prefill_chunk_tokens=4,
                    decode_steps_per_tick=4)
    outs = [eng.add_request(_req(side, short, 11, "short"))]
    events = eng.step()
    outs.append(eng.add_request(_req(side, long, 5, "long")))
    return outs, events + eng.run()


def case_cancel_from_stream_callback(side):
    prompts = _prompts(9, [5, 5])
    eng = side.make(n_slots=2, scheduler=side.api.SchedulerConfig(max_prefills_per_tick=2),
                    decode_steps_per_tick=8)
    got, outs = [], {}

    def disconnect(ev):
        got.append(ev.token)
        if len(got) == 3:  # mid-block of an 8-token tick
            assert eng.cancel("victim")

    outs["victim"] = eng.add_request(_req(side, prompts[0], 12, "victim", on_token=disconnect))
    outs["neighbour"] = eng.add_request(_req(side, prompts[1], 12, "neighbour"))
    events = eng.run()
    # a callback cancelling a DIFFERENT slot mid-loop
    eng2 = side.make(n_slots=2, scheduler=side.api.SchedulerConfig(max_prefills_per_tick=2),
                     decode_steps_per_tick=8)

    def shoot_other(ev):
        other = outs.get("b")
        if other is not None and not other.done:
            eng2.cancel("b")

    outs["a"] = eng2.add_request(_req(side, prompts[0], 12, "a", on_token=shoot_other))
    outs["b"] = eng2.add_request(_req(side, prompts[1], 12, "b"))
    events += eng2.run()
    assert eng.pool.n_free == eng2.pool.n_free == 2
    return list(outs.values()), events


def case_queue_timeout(side):
    prompts = _prompts(10, [5, 5])
    t = [0.0]
    eng = side.make(n_slots=1, scheduler=side.api.SchedulerConfig(max_wait=10.0),
                    clock=lambda: t[0])
    seen = []
    outs = [eng.add_request(_req(side, prompts[0], 6, "a")),
            eng.add_request(_req(side, prompts[1], 6, "b", on_token=seen.append))]
    events = eng.step()  # a takes the slot, b queued at t=0
    t[0] = 11.0
    events += eng.run()
    assert len(seen) == 1 and seen[0].token == -1 and seen[0].finish_reason == "max_wait"
    assert eng.metrics.expired == 1 and eng.metrics.tokens_out == 6
    return outs, events


def case_admission_and_capacity_rejection(side):
    prompts = _prompts(11, [5, 5, 5])
    eng = side.make(n_slots=1, scheduler=side.api.SchedulerConfig(max_queue=1))
    outs = [eng.add_request(_req(side, prompts[0], 6, "a"))]
    events = eng.step()
    outs += [eng.add_request(_req(side, prompts[i], 6, rid)) for i, rid in ((1, "b"), (2, "c"))]
    outs.append(eng.add_request(_req(side, prompts[0], 32, "too_long")))
    events += eng.run()
    assert "seq_len" in outs[-1].detail
    return outs, events


def case_nan_sentinel_at_prefill(side):
    eng = side.make(side.poisoned, n_slots=2, decode_steps_per_tick=1)
    seen = []
    out = eng.add_request(_req(side, _prompts(12, [5])[0], 6, "r0", on_token=seen.append))
    events = eng.run(max_ticks=20)
    assert eng.integrity_trips == 1 and eng.metrics.summary()["integrity_trips"] == 1
    assert eng.pool.n_free == eng.pool.n_slots and not eng.has_work()
    assert len(seen) == 1 and seen[0].token == -1
    return [out], events


def case_nan_sentinel_mid_fused_tick(side):
    eng = side.make(side.own_weights(), n_slots=2, decode_steps_per_tick=4)
    out = eng.add_request(_req(side, _prompts(13, [5])[0], 12, "r0"))
    events = eng.step()
    assert out.status == "running" and len(out.tokens) >= 1
    # the weights rot mid-flight
    if side.api.__name__.startswith("tpu_parallel_torch"):
        with torch.no_grad():
            for dst, src in zip(eng.model.parameters(), side.poisoned.parameters()):
                dst.copy_(src)
    else:
        eng.params = side.poisoned
    events += eng.run(max_ticks=10)
    assert eng.integrity_trips == 1 and not eng.has_work()
    assert eng.pool.n_free == eng.pool.n_slots
    return [out], events


def _overlap(overlap):
    def case(side):
        prompts = _prompts(14, [3, 5, 9, 4])
        eng = side.make(n_slots=2, scheduler=side.api.SchedulerConfig(max_prefills_per_tick=2))
        outs = [eng.add_request(_req(side, p, n, f"r{i}"))
                for i, (p, n) in enumerate(zip(prompts, [12, 9, 11, 10]))]
        events = eng.run(overlap=overlap)
        s = eng.metrics.summary()
        assert (s["overlapped_dispatches"] > 0) == overlap
        return outs, events
    return case


CASES = {
    "simultaneous": case_simultaneous,
    "staggered_pool_of_2": case_staggered_pool_of_2,
    "bucketed_staggered": case_bucketed_staggered,
    "chunked_3": _chunked(3),
    "chunked_5": _chunked(5),
    "prefix_reuse": case_prefix_reuse,
    "fused_t4_mid_block_budgets": case_fused_t4_mid_block_budgets,
    "fused_t8_eos_mid_block": _fused_eos_mid_block(8),
    "per_step_eos": _fused_eos_mid_block(1),
    "fused_chunked_interleave": case_fused_chunked_interleave,
    "cancel_from_stream_callback": case_cancel_from_stream_callback,
    "queue_timeout": case_queue_timeout,
    "admission_and_capacity_rejection": case_admission_and_capacity_rejection,
    "nan_sentinel_at_prefill": case_nan_sentinel_at_prefill,
    "nan_sentinel_mid_fused_tick": case_nan_sentinel_mid_fused_tick,
    "sequential_run": _overlap(False),
    "overlap_run": _overlap(True),
    "attn_window": _mixed_on(attn_window=6),
    "gqa_window": _mixed_on(n_kv_heads=2, attn_window=6),
    "seq_len_prompts_chunked_paged": case_seq_len_prompts_chunked_paged,
    "top_k_1_beside_greedy": case_top_k_1_beside_greedy,
    "chunked_3_per_phase": _per_phase(_chunked(3)),
    "fused_chunked_interleave_per_phase": _per_phase(case_fused_chunked_interleave),
}

# what each case must show on the port's side besides agreeing with JAX
EXPECT = {
    "simultaneous": dict(statuses={FINISHED}),
    "bucketed_staggered": dict(statuses={FINISHED}),
    "prefix_reuse": dict(statuses={FINISHED}),
    "attn_window": dict(statuses={FINISHED}),
    "gqa_window": dict(statuses={FINISHED}),
    "seq_len_prompts_chunked_paged": dict(statuses={FINISHED}),
    "top_k_1_beside_greedy": dict(statuses={FINISHED}),
    "fused_t8_eos_mid_block": dict(reasons={"eos", "length"}),
    "cancel_from_stream_callback": dict(statuses={FINISHED, CANCELLED}),
    "queue_timeout": dict(statuses={FINISHED, EXPIRED}),
    "admission_and_capacity_rejection": dict(statuses={FINISHED, REJECTED}),
    "nan_sentinel_at_prefill": dict(statuses={FAILED}, reasons={FAIL_INTEGRITY}),
    "nan_sentinel_mid_fused_tick": dict(statuses={FAILED}, reasons={FAIL_INTEGRITY}),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_engine_matches_jax_engine(pair, name):
    jax_side, port_side, _ = pair
    want = _record(*CASES[name](jax_side))
    got = _record(*CASES[name](port_side))
    assert got[0] == want[0], f"{name}: outputs differ"
    assert got[1] == want[1], f"{name}: stream events differ"
    expect = EXPECT.get(name, {})
    if "statuses" in expect:
        assert {s for s, _, _ in got[0]} == expect["statuses"]
    if "reasons" in expect:
        assert {r for _, r, _ in got[0]} == expect["reasons"]


def test_overlap_run_bitwise_equal_to_sequential(pair):
    _, port_side, _ = pair
    seq = _record(*CASES["sequential_run"](port_side))
    ov = _record(*CASES["overlap_run"](port_side))
    assert ov[0] == seq[0]
    assert sorted(ov[1]) == sorted(seq[1])


def test_chunked_prefill_really_chunks(pair):
    _, port_side, model = pair
    eng = ServingEngine(model, n_slots=2, scheduler=SchedulerConfig(max_prefills_per_tick=2),
                        prefill_buckets=(4, 8, 16), prefill_chunk_tokens=3)
    for i, p in enumerate(_prompts(4, [9, 13, 4])):
        eng.add_request(Request(prompt=p, max_new_tokens=6))
    eng.run()
    assert eng.metrics.prefill_chunks >= 3 + 5
    assert eng.prefill_compiles <= 4


# -- port-only cases -----------------------------------------------------------

@pytest.fixture(scope="module")
def model():
    return GPTLM(tiny_test(), device="cpu", seed=3).eval()


def test_per_request_sampling_isolation(model):
    """A greedy request, a temperature request with top_k=1 (its row's
    filter makes it the argmax) and a hot one share ticks; the two
    deterministic rows equal the greedy reference."""
    from tpu_parallel_torch.models.generate import generate

    prompt = _prompts(20, [5])[0]
    ref = generate(model, torch.tensor([prompt]), max_new_tokens=6)[0].tolist()
    eng = ServingEngine(model, n_slots=4, scheduler=SchedulerConfig(max_prefills_per_tick=4),
                        rng=torch.Generator().manual_seed(3))
    greedy = eng.add_request(Request(prompt=prompt, max_new_tokens=6))
    topk1 = eng.add_request(Request(prompt=prompt, max_new_tokens=6,
                                    sampling=SamplingParams(temperature=1.0, top_k=1)))
    hot = eng.add_request(Request(prompt=prompt, max_new_tokens=6,
                                  sampling=SamplingParams(temperature=4.0)))
    eng.run()
    assert greedy.tokens == ref and topk1.tokens == ref
    assert len(hot.tokens) == 6 and all(0 <= t < VOCAB for t in hot.tokens)


def _sampled_stream(model, seed, steps):
    eng = ServingEngine(model, n_slots=4, scheduler=SchedulerConfig(max_prefills_per_tick=4),
                        rng=torch.Generator(device=model.device).manual_seed(seed),
                        decode_steps_per_tick=steps)
    outs = [eng.add_request(Request(prompt=p, max_new_tokens=12,
                                    sampling=SamplingParams(temperature=1.5, top_p=0.95)))
            for p in _prompts(21, [4, 6, 5])]
    eng.run()
    return [o.tokens for o in outs]


@pytest.mark.parametrize("steps", [1, 4])
def test_same_seed_same_sampled_stream(model, steps):
    a, b = _sampled_stream(model, 7, steps), _sampled_stream(model, 7, steps)
    assert a == b
    assert all(0 <= t < VOCAB for row in a for t in row)
    assert _sampled_stream(model, 8, steps) != a


# knobs that hold JAX's limits: under a mesh (a gloo world of one here; the
# tensor-parallel runs are tests/test_torch_tp.py's) the paged pool and
# decode_steps_per_tick > 1 raise the JAX engine's NotImplementedError, and
# the engine decodes per-step with neither the unified tick nor a graph
REFUSED = {
    "mesh": (dict(kv_block_tokens=8), dict(decode_steps_per_tick=4)),
}


def _mesh_limits(plain, tmp_path):
    import torch.distributed as dist

    from tpu_parallel_torch.runtime import MeshConfig, make_mesh

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rendezvous'}",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh(MeshConfig(data=1))
        model = GPTLM(tiny_test(), device="cpu", seed=3, mesh=mesh).eval()
        with pytest.raises(ValueError, match="the mesh the model was built on"):
            ServingEngine(plain, n_slots=2, mesh=mesh)
        for bad in REFUSED["mesh"]:
            with pytest.raises(NotImplementedError, match="under a mesh"):
                ServingEngine(model, n_slots=2, mesh=mesh, **bad)
        eng = ServingEngine(model, n_slots=2, mesh=mesh)
        assert eng.decode_steps_per_tick == 1 and not eng.unified_tick
        ref = ServingEngine(plain, n_slots=2, decode_steps_per_tick=1)
        prompt = _prompts(30, [5])[0]
        outs = [e.add_request(Request(prompt=prompt, max_new_tokens=5)) for e in (eng, ref)]
        eng.run()
        ref.run()
        assert outs[0].tokens == outs[1].tokens and eng.graph_captures == 0
    finally:
        dist.destroy_process_group()


class _EchoDrafter:
    """A custom drafter: proposes the context's last token."""

    def draft(self, context, k):
        return list(context[-1:]) * k


# the speculative knobs (ported): each raises what the JAX engine raises on
# a misuse (a negative draft_tokens; a custom drafter under an explicit
# T > 1, which fuses on the device) and builds otherwise
SPEC_KNOBS = {
    "draft_tokens": (dict(draft_tokens=-1), ValueError, "draft_tokens", dict(draft_tokens=2)),
    "draft_tokens_paged": (dict(draft_tokens=-2, kv_block_tokens=8), ValueError, "draft_tokens",
                           dict(draft_tokens=2, kv_block_tokens=8)),
    "drafter": (dict(drafter=_EchoDrafter(), draft_tokens=2, decode_steps_per_tick=4),
                NotImplementedError, "drafter _EchoDrafter",
                dict(drafter=_EchoDrafter(), draft_tokens=2)),
}
# knobs the port has: each raises the JAX engine's ValueError when its
# prerequisite is missing (the hierarchy indexes physical blocks, the disk
# tier sits under a host tier) and builds its tier when configured
PORTED = {
    "kv_radix_cache": (dict(kv_radix_cache=True), dict(kv_block_tokens=8, prefix_cache_size=4)),
    "kv_host_blocks": (dict(kv_host_blocks=4), dict(kv_block_tokens=8, prefix_cache_size=4)),
    "kv_disk": (dict(kv_disk_dir="kv", kv_disk_blocks=4),
                dict(kv_block_tokens=8, prefix_cache_size=4, kv_host_blocks=4)),
}


@pytest.mark.parametrize("knob", sorted(REFUSED) + sorted(PORTED) + sorted(SPEC_KNOBS))
def test_refused_knob_raises(model, knob, tmp_path):
    if knob in REFUSED:
        _mesh_limits(model, tmp_path)
        return
    if knob in SPEC_KNOBS:
        bad, error, match, good = SPEC_KNOBS[knob]
        with pytest.raises(error, match=match):
            ServingEngine(model, n_slots=2, **bad)
        eng = ServingEngine(model, n_slots=2, **good)
        assert eng._spec_width == 2 and eng.decode_steps_per_tick == 1
        out = eng.add_request(Request(prompt=[5, 6, 5, 6, 5], max_new_tokens=6))
        eng.run()
        assert out.status == FINISHED and eng.metrics.spec_slot_ticks > 0  # verify ticks ran
        return
    knobs, prerequisites = PORTED[knob]
    if knob == "kv_disk":
        knobs = dict(knobs, kv_disk_dir=str(tmp_path / "kv"))
    with pytest.raises(ValueError, match="kv_"):
        ServingEngine(model, n_slots=2, **knobs)
    eng = ServingEngine(model, n_slots=2, **knobs, **prerequisites)
    assert eng._radix is not None and eng._prefix is eng._radix
    assert eng._radix.host_capacity == knobs.get("kv_host_blocks", prerequisites.get(
        "kv_host_blocks", 0))
    assert (eng._radix.disk is not None) == (knob == "kv_disk")


def test_refused_int8_cache_and_prefix_export(model):
    """The int8 cache serves (its parity cases are in
    ``tests/test_torch_int8_kv.py``); a cache dtype that is neither bf16
    nor int8 is refused, as the JAX layer refuses it.  Prefix export and
    import exist and answer a fixed-slot engine as the JAX engine does
    (nothing to export, a typed ``not_paged`` verdict)."""
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        tiny_test(kv_cache_dtype="fp8")
    int8 = ServingEngine(GPTLM(tiny_test(kv_cache_dtype="int8"), device="cpu"), n_slots=2)
    assert int8.pool.cache[0].key_store.dtype == torch.int8
    eng = ServingEngine(model, n_slots=2)
    assert eng.export_prefix("r0") is None
    assert eng.import_prefix(None) == "not_paged"
    assert eng.export_hot_prefixes() == []
    assert eng.decode_steps_per_tick == 8 and eng.unified_tick is True
    assert eng.graph_captures == 0  # the CPU runs the fused body eagerly


def test_rebind_params_copies_in_place(model):
    served = copy.deepcopy(model)
    eng = ServingEngine(served, n_slots=2)
    ptrs = [p.data_ptr() for p in served.parameters()]
    other = GPTLM(tiny_test(), device="cpu", seed=4)
    eng.rebind_params(other.state_dict(), version="v2")
    assert [p.data_ptr() for p in served.parameters()] == ptrs
    assert all(torch.equal(a, b) for a, b in zip(served.parameters(), other.parameters()))
    assert eng.weights_version == "v2"
    with pytest.raises(ValueError, match="same-shape"):
        eng.rebind_params({k: v[..., :1] for k, v in other.state_dict().items()})
    eng.add_request(Request(prompt=[1, 2, 3], max_new_tokens=4))
    with pytest.raises(RuntimeError, match="in flight"):
        eng.rebind_params(other.state_dict())


def test_launch_ahead_collects_in_order(model):
    """The launch/collect halves: a pure-decode tick may launch before the
    pending one is collected, and each collect delivers its own tick."""
    eng = ServingEngine(model, n_slots=1)
    out = eng.add_request(Request(prompt=[1, 2, 3], max_new_tokens=28))
    eng.step()  # admission + the first fused tick
    assert eng._can_launch_ahead()
    p1 = eng.launch()
    assert eng._can_launch_ahead()
    p2 = eng.launch(ahead=True)
    ev1, ev2 = eng.collect(p1), eng.collect(p2)
    assert len(ev1) == len(ev2) == eng.decode_steps_per_tick
    assert [e.index for e in ev1 + ev2] == list(range(9, 25))
    eng.run()
    assert out.status == FINISHED and len(out.tokens) == 28
    assert eng.metrics.summary()["overlapped_dispatches"] == 1


def test_drain_in_flight_and_pending_prefill_tokens(model):
    eng = ServingEngine(model, n_slots=2, prefill_buckets=(4, 8, 16), prefill_chunk_tokens=4,
                        decode_steps_per_tick=1)
    long = eng.add_request(Request(prompt=list(range(1, 13)), max_new_tokens=3))
    queued = eng.add_request(Request(prompt=[5, 6, 7], max_new_tokens=3))
    assert eng.pending_prefill_tokens == 15 and eng.in_flight == 0
    eng.step()  # the long prompt claims a slot and runs its first chunk
    assert eng.in_flight == 1 and eng.pending_prefill_tokens == 3 + 8
    eng.step()  # its second chunk; the short prompt is admitted
    assert eng.in_flight == 2 and eng.pending_prefill_tokens == 4
    eng.begin_drain()
    assert eng.draining
    refused = eng.add_request(Request(prompt=[1, 2], max_new_tokens=2))
    assert refused.status == REJECTED and refused.finish_reason == "draining"
    eng.run()
    assert long.status == queued.status == FINISHED
    assert eng.in_flight == 0 and eng.pending_prefill_tokens == 0


def test_reset_metrics_rewires_scheduler_registry(model):
    eng = ServingEngine(model, n_slots=1)
    assert eng.scheduler.registry is eng.registry
    old_registry = eng.registry
    eng.add_request(Request(prompt=[1, 2, 3], max_new_tokens=3))
    eng.run()
    fresh = eng.reset_metrics()
    assert fresh is eng.metrics and eng.registry is fresh.registry is not old_registry
    assert eng.scheduler.registry is eng.registry and eng.metrics.ticks == 0
    out = eng.add_request(Request(prompt=[1, 2, 3], max_new_tokens=3))
    eng.run()
    assert out.status == FINISHED and eng.metrics.finished == 1


def test_trace_span_chain_per_request(model):
    """Under a Tracer each request leaves one chain, queue -> prefill[chunk]
    -> decode, and one finish instant, on per-slot tracks; a prefix hit
    marks its prefill span; the stall counters cover the run."""
    from tpu_parallel_torch.obs import Tracer

    t = [0.0]

    def clock():
        t[0] += 0.25
        return t[0]

    tracer = Tracer(clock=clock)
    eng = ServingEngine(model, n_slots=2, scheduler=SchedulerConfig(max_prefills_per_tick=2),
                        tracer=tracer, clock=clock, prefill_buckets=(8, 16),
                        prefill_chunk_tokens=9, prefix_cache_size=2, decode_steps_per_tick=1)
    shared = [7, 3, 5, 2, 9, 4, 6, 1]
    prompts = [list(range(20, 32)), shared + [5], shared + [8]]
    outs = [eng.add_request(Request(prompt=p, max_new_tokens=5)) for p in prompts]
    eng.run()
    assert all(out.status == FINISHED for out in outs)
    assert tracer.tracks() == ["scheduler", "slot 0", "slot 1"]
    for out in outs:
        rid = out.request.request_id
        spans = [sp for sp in tracer.spans if sp.attrs.get("request_id") == rid]
        chain = [sp.name for sp in spans]
        assert chain[0] == "queue" and "decode" in chain, chain
        assert any(name.startswith("prefill") for name in chain), chain
        assert [sp.start for sp in spans] == sorted(sp.start for sp in spans)
        finishes = [ev for ev in tracer.instants if ev["attrs"].get("request_id") == rid]
        assert [ev["name"] for ev in finishes] == ["finish"]
    chunks = [sp for sp in tracer.spans if sp.name == "prefill_chunk"]
    assert [sp.attrs["chunk"] for sp in chunks] == [0, 1] and chunks[-1].attrs["final"]
    prefills = {sp.attrs["request_id"]: sp for sp in tracer.spans if sp.name == "prefill"}
    hit = prefills[outs[2].request.request_id]
    assert hit.attrs["cache_hit"] is True and hit.attrs["prefix_len"] == len(shared)
    stalls = {row["labels"]["cause"]: row["value"]
              for row in eng.registry.snapshot()["counters"]
              if row["name"] == "serving_tick_stall_total"}
    assert stalls["prefill"] >= 2 and stalls["none"] >= 1


# -- on the card ----------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused tick's CUDA graph has no CPU mode")
    return torch.device("cuda")


def _card_engine(model, eager, seed=0, temperature=0.0):
    eng = ServingEngine(model, n_slots=4, scheduler=SchedulerConfig(max_prefills_per_tick=4),
                        rng=torch.Generator(device="cuda").manual_seed(seed),
                        decode_steps_per_tick=4)
    if eager:
        eng._run_fused_eagerly()
    outs = [eng.add_request(Request(prompt=p, max_new_tokens=13,
                                    sampling=SamplingParams(temperature=temperature)))
            for p in _prompts(30, [5, 9, 3, 7])]
    return eng, outs


@pytest.mark.gpu
def test_captured_fused_tick_equals_eager(cuda):
    """Three fused ticks (the first admits; 13 tokens = 1 + 3 x 4): the
    replayed graph gives bitwise the eager body's tokens and cache."""
    model = GPTLM(tiny_test(seq_len=64), device="cuda", seed=5).eval()
    results = []
    for eager in (True, False):
        eng, outs = _card_engine(model, eager)
        for _ in range(3):
            eng.step()
        results.append(([o.tokens for o in outs], [c.key.clone() for c in eng.pool.cache],
                        eng.graph_captures))
    (eager_toks, eager_cache, n0), (graph_toks, graph_cache, n1) = results
    assert (n0, n1) == (0, 1)
    assert graph_toks == eager_toks and all(len(t) == 13 for t in graph_toks)
    assert all(torch.equal(a, b) for a, b in zip(graph_cache, eager_cache))


@pytest.mark.gpu
def test_graph_replays_draw_new_noise_and_seed_repeats(cuda):
    """At temperature 1, two replays from the same slot state draw
    different tokens (the engine's generator is registered with the
    graph), and the same seed gives the same stream."""
    model = GPTLM(tiny_test(seq_len=64), device="cuda", seed=5).eval()
    eng, _ = _card_engine(model, eager=False, temperature=1.0)
    eng.step()  # admits, captures, replays once
    saved = [t.clone() for t in eng._dev_state]
    blocks = []
    for _ in range(2):
        for dst, src in zip(eng._dev_state, saved):
            dst.copy_(src)
        eng._graphs["fused"].replay()
        blocks.append(eng._dev_out.clone())
    assert not torch.equal(blocks[0], blocks[1])
    runs = []
    for seed in (1, 1, 2):
        eng, outs = _card_engine(model, eager=False, seed=seed, temperature=1.0)
        eng.run()
        assert eng.graph_captures == 1
        runs.append([o.tokens for o in outs])
    assert runs[0] == runs[1] != runs[2]
    assert all(0 <= t < VOCAB for row in runs[0] for t in row)
