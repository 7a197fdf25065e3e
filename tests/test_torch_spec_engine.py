"""Port parity for the speculative serving engine (``ServingEngine`` with
``draft_tokens`` > 0): the spec cases of ``tests/test_serving.py`` and the
``spec`` mode of ``tests/test_paged_kv.py:test_paged_greedy_parity``
re-run against the port (the int8 cache's are in
``tests/test_torch_int8_kv.py``), and the cross-package contract.

- Cross-package: the same script through the JAX spec engine and the
  port's, per-step, fused, unified-chunked, paged and ``run(overlap=True)``,
  over scanned, GQA and unrolled configs: greedy tokens and stream events
  exactly equal, and so are ``tokens_drafted``, the accepted tokens,
  ``spec_wasted_positions`` and the decode ticks; the port's greedy tokens
  also equal its non-spec engine's.
- Port cases: the JAX engine cases' assertions, held against the port's
  static ``generate()`` and its non-spec engine.

``tiny_test`` in fp32 on the CPU, weights bridged from a flax init, prompts
from numpy seeds.  The JAX side is imported inside fixtures, so the ``gpu``
cases at the end run on the card without JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_spec_engine.py
"""

import copy
import types

import numpy as np
import pytest
import torch
from _spec_drafters import AntiOracleDrafter, OracleDrafter, ref_map

from tpu_parallel_torch.models import GPTLM, tiny_test
from tpu_parallel_torch.models.generate import generate
from tpu_parallel_torch.serving import (
    FAIL_INTEGRITY,
    FAILED,
    FINISHED,
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


def _prompts(seed, lens, motif_every=2):
    """Prompts of ``lens``; every ``motif_every``-th one a short motif
    repeated, so the n-gram drafter finds matches."""
    rs = np.random.default_rng(seed)
    out = []
    for i, n in enumerate(lens):
        if i % motif_every == 0:
            motif = [int(t) for t in rs.integers(1, VOCAB, 3)]
            out.append((motif * n)[:n])
        else:
            out.append([int(t) for t in rs.integers(1, VOCAB, n)])
    return out


def _ref(model, prompt, n):
    return generate(model, torch.tensor([prompt]), max_new_tokens=n)[0].tolist()


CONFIGS = {"scanned": dict(), "gqa": dict(n_kv_heads=2), "unrolled": dict(scan_layers=False)}


@pytest.fixture(scope="module")
def bridged():
    """config name -> (JAX side, port side) on one flax init bridged into
    the port's GPTLM (the JAX model object is shared so its jits are)."""
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
            params = jm.init({"params": jax.random.PRNGKey(1)}, jnp.zeros((1, 5), jnp.int32),
                             train=False)["params"]
            cfg = tiny_test(**kw)
            model = GPTLM(cfg, device="cpu")
            model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), cfg))
            model.eval()
            clock = dict(clock=lambda: 0.0)
            made[name] = (
                types.SimpleNamespace(api=jserving, make=lambda **k: jserving.ServingEngine(
                    jm, params, **clock, **k)),
                types.SimpleNamespace(api=tserving, model=model,
                                      make=lambda **k: tserving.ServingEngine(model, **clock, **k)))
        return made[name]

    return get


@pytest.fixture(scope="module")
def model(bridged):
    return bridged("scanned")[1].model


# -- against the JAX spec engine -----------------------------------------------------

SPEC = dict(draft_tokens=3)
FUSED = dict(SPEC, decode_steps_per_tick=4)
MODES = {
    "per_step": SPEC,
    "fused": FUSED,
    "unified_chunked": dict(FUSED, prefill_chunk_tokens=4, prefill_buckets=(4, 8, 16)),
    "paged": dict(FUSED, kv_block_tokens=4),
    "overlap": FUSED,
}


def _script(side, overlap=False, **kw):
    """Staggered arrivals into reused slots, budgets ending mid-block, a
    prompt long enough to chunk; returns (outputs, events, engine)."""
    prompts = _prompts(40, [9, 5, 12, 7, 10])
    budgets = [8, 6, 7, 9, 5]
    eng = side.make(n_slots=2, scheduler=side.api.SchedulerConfig(max_prefills_per_tick=2), **kw)
    req = lambda i: side.api.Request(prompt=prompts[i], max_new_tokens=budgets[i],
                                     request_id=f"r{i}")
    outs = [eng.add_request(req(0)), eng.add_request(req(1))]
    events = eng.step()
    outs.append(eng.add_request(req(2)))
    events += eng.step()
    outs += [eng.add_request(req(i)) for i in (3, 4)]
    events += eng.run(overlap=overlap)
    return outs, events, eng


def _record(outs, events):
    return ([(o.status, o.finish_reason, list(o.tokens)) for o in outs],
            [(e.request_id, e.token, e.index, e.finished, e.finish_reason) for e in events])


def _spec_counters(eng):
    m = eng.metrics
    return dict(drafted=m.tokens_drafted, accepted=m.tokens_accepted,
                wasted=m.spec_wasted_positions, decode_ticks=m.decode_ticks)


@pytest.fixture(scope="module")
def plain_tokens(bridged):
    """config name -> the port's non-spec engine's tokens on the script:
    the same run for every mode, made once per config."""
    made = {}

    def get(config):
        if config not in made:
            made[config] = [o.tokens for o in _script(bridged(config)[1])[0]]
        return made[config]

    return get


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("mode", sorted(MODES))
def test_spec_engine_matches_jax(bridged, plain_tokens, mode, config):
    jax_side, port_side = bridged(config)
    overlap = mode == "overlap"
    j_outs, j_events, jeng = _script(jax_side, overlap, **MODES[mode])
    outs, events, eng = _script(port_side, overlap, **MODES[mode])
    assert _record(outs, events) == _record(j_outs, j_events)
    assert _spec_counters(eng) == _spec_counters(jeng)
    assert eng.metrics.tokens_drafted > 0 and eng.metrics.tokens_accepted > 0
    assert {o.status for o in outs} == {FINISHED}
    assert plain_tokens(config) == [o.tokens for o in outs]
    if overlap:
        assert eng.metrics.summary()["overlapped_dispatches"] > 0
    if mode == "paged":
        eng.pool.allocator.check()
        assert eng.pool.blocks_in_use == 0


# -- the JAX engine cases, against the port -------------------------------------------


def _drive(model, prompts, budgets, staggered=False, **kw):
    eng = ServingEngine(model, scheduler=SchedulerConfig(max_prefills_per_tick=2), **kw)
    if staggered:
        outs = [eng.add_request(Request(prompt=prompts[i], max_new_tokens=budgets[i]))
                for i in (0, 1)]
        eng.step(), eng.step()
        outs.append(eng.add_request(Request(prompt=prompts[2], max_new_tokens=budgets[2])))
        eng.step()
        outs += [eng.add_request(Request(prompt=p, max_new_tokens=n))
                 for p, n in zip(prompts[3:], budgets[3:])]
    else:
        outs = [eng.add_request(Request(prompt=p, max_new_tokens=n))
                for p, n in zip(prompts, budgets)]
    eng.run()
    return eng, outs


def test_spec_engine_greedy_parity_staggered(model):
    """The spec engine (n-gram drafter, adaptive K, bucketed prefill)
    equals the non-spec engine and static generate() across staggered
    arrivals into reused slots."""
    prompts, budgets = _prompts(50, [3, 9, 6, 12, 5]), [8, 6, 8, 5, 7]
    refs = [_ref(model, p, n) for p, n in zip(prompts, budgets)]
    kw = dict(n_slots=2, prefill_buckets=(4, 8, 16))
    _, plain = _drive(model, prompts, budgets, staggered=True, **kw)
    eng, spec = _drive(model, prompts, budgets, staggered=True, draft_tokens=3,
                       spec_check_invariants=True, **kw)
    for a, b, ref in zip(plain, spec, refs):
        assert a.status == b.status == FINISHED
        assert a.tokens == ref and b.tokens == ref
    s = eng.metrics.summary()
    assert s["tokens_drafted"] > 0 and s["spec_acceptance_rate"] is not None


def test_spec_engine_adversarial_drafter_exact(model):
    prompts = _prompts(51, [5, 5], motif_every=9)
    want = [_ref(model, p, 8) for p in prompts]
    eng, outs = _drive(model, prompts, [8, 8], n_slots=2, draft_tokens=3, spec_adaptive=False,
                       drafter=AntiOracleDrafter(ref_map(prompts, want), VOCAB),
                       spec_check_invariants=True)
    assert [o.tokens for o in outs] == want
    s = eng.metrics.summary()
    assert s["tokens_drafted"] > 0 and s["tokens_accepted"] == 0
    assert s["spec_acceptance_rate"] == 0.0 and s["spec_wasted_positions"] > 0


def test_spec_engine_eos_mid_verify_block(model):
    """EOS inside an accepted verify block cuts delivery there with
    finish_reason "eos", as the non-spec engine does."""
    prompt = _prompts(52, [4], motif_every=9)[0]
    ref = _ref(model, prompt, 10)
    eos_idx = next(i for i in range(2, 7) if ref[i] not in ref[:i])
    eos = ref[eos_idx]

    def drive(**kw):
        eng = ServingEngine(model, n_slots=1, **kw)
        out = eng.add_request(Request(prompt=prompt, max_new_tokens=10, eos_token_id=eos))
        eng.run()
        return eng, out

    _, plain = drive()
    eng, spec = drive(draft_tokens=6, drafter=OracleDrafter(ref_map([prompt], [ref])),
                      spec_check_invariants=True)
    assert plain.finish_reason == spec.finish_reason == "eos"
    assert spec.tokens == ref[:eos_idx + 1] == plain.tokens
    assert eng.metrics.spec_wasted_positions > 0
    assert eng.pool.n_free == 1


def test_spec_engine_oracle_fewer_decode_ticks(model):
    """With a perfect drafter the same workload takes far fewer decode
    ticks than one token per tick (the deterministic form of the win)."""
    n_new = 12
    prompts = _prompts(53, [5, 5], motif_every=9)
    want = [_ref(model, p, n_new) for p in prompts]
    plain, outs = _drive(model, prompts, [n_new] * 2, n_slots=2, decode_steps_per_tick=1)
    assert [o.tokens for o in outs] == want
    spec, outs = _drive(model, prompts, [n_new] * 2, n_slots=2, draft_tokens=4,
                        drafter=OracleDrafter(ref_map(prompts, want)))
    assert [o.tokens for o in outs] == want
    assert plain.metrics.decode_ticks == n_new - 1
    assert spec.metrics.decode_ticks <= 3
    assert spec.metrics.tokens_accepted > 0
    assert (spec.metrics.summary()["tokens_per_decode_tick"]
            > plain.metrics.summary()["tokens_per_decode_tick"])


def test_spec_engine_per_request_knobs(model):
    """A request's draft_tokens=0 opts it out of drafting (it still rides
    the verify ticks); a hot-temperature request rides along."""
    prompt = _prompts(54, [5])[0]
    ref = _ref(model, prompt, 6)
    eng = ServingEngine(model, n_slots=4, scheduler=SchedulerConfig(max_prefills_per_tick=4),
                        draft_tokens=3, rng=torch.Generator().manual_seed(3))
    on = eng.add_request(Request(prompt=prompt, max_new_tokens=6))
    off = eng.add_request(Request(prompt=prompt, max_new_tokens=6, draft_tokens=0))
    hot = eng.add_request(Request(prompt=prompt, max_new_tokens=6,
                                  sampling=SamplingParams(temperature=4.0)))
    eng.run()
    assert on.tokens == ref and off.tokens == ref
    assert len(hot.tokens) == 6 and all(0 <= t < VOCAB for t in hot.tokens)
    with pytest.raises(ValueError, match="draft_tokens"):
        Request(prompt=[1], draft_tokens=-1)


def test_spec_engine_chunked_prefill_interleaves(model):
    """Spec ticks and chunked prefill coexist: a long prompt's chunks ride
    separate ticks while the running request keeps producing."""
    short, long = _prompts(55, [3, 12])
    refs = [_ref(model, short, 10), _ref(model, long, 4)]
    eng = ServingEngine(model, n_slots=2, prefill_buckets=(4, 8, 16), prefill_chunk_tokens=4,
                        draft_tokens=3)
    a = eng.add_request(Request(prompt=short, max_new_tokens=10))
    eng.step()
    b = eng.add_request(Request(prompt=long, max_new_tokens=4))
    n_before = len(a.tokens)
    eng.step(), eng.step()
    assert len(b.tokens) == 0
    assert len(a.tokens) >= n_before + 2
    eng.run()
    assert a.tokens == refs[0] and b.tokens == refs[1]


@pytest.mark.parametrize("variant", ["plain", "paged"])
def test_spec_fused_tick_bitwise(model, variant):
    """T verify blocks per tick with in-body n-gram drafting equal the
    per-step spec engine and static generate() across staggered arrivals,
    budgets ending mid-block, per layout."""
    layout = dict(kv_block_tokens="auto") if variant == "paged" else {}
    prompts, budgets = _prompts(60, [3, 9, 6, 12, 5]), [6, 5, 9, 3, 7]
    kw = dict(n_slots=2, prefill_buckets=(4, 8, 16), draft_tokens=3, **layout)
    step_eng, stepped = _drive(model, prompts, budgets, True, decode_steps_per_tick=1, **kw)
    fused_eng, fused = _drive(model, prompts, budgets, True, decode_steps_per_tick=4, **kw)
    for a, b, p, n in zip(stepped, fused, prompts, budgets):
        assert a.status == b.status == FINISHED
        assert a.tokens == b.tokens == _ref(model, p, n)
    assert fused_eng.metrics.host_dispatches < step_eng.metrics.host_dispatches
    assert fused_eng.metrics.tokens_drafted > 0
    assert fused_eng.pool.n_free == 2


def test_spec_fused_eos_mid_block_and_chunked(model):
    """The unified spec tick (chunks folded in) with EOS mid-block equals
    the per-step spec engine."""
    short, long = _prompts(61, [4, 12])
    ref = _ref(model, short, 12)
    eos_idx = next(i for i in range(2, 7) if ref[i] not in ref[:i])

    def drive(steps):
        eng = ServingEngine(model, n_slots=2, scheduler=SchedulerConfig(max_prefills_per_tick=2),
                            prefill_buckets=(4, 8, 16), prefill_chunk_tokens=4, draft_tokens=3,
                            decode_steps_per_tick=steps)
        a = eng.add_request(Request(prompt=short, max_new_tokens=12, eos_token_id=ref[eos_idx]))
        eng.step()
        b = eng.add_request(Request(prompt=long, max_new_tokens=5))
        eng.run()
        return a, b

    a1, b1 = drive(1)
    a4, b4 = drive(4)
    assert a1.finish_reason == a4.finish_reason == "eos"
    assert a4.tokens == a1.tokens == ref[:eos_idx + 1]
    assert b4.tokens == b1.tokens and b1.status == FINISHED


@pytest.mark.parametrize("spec_steps", [1, 2])
def test_nan_sentinel_spec_verify_path(model, spec_steps):
    """Weights rotting mid-stream under draft-verify ticks (per-step and
    fused) fail the request typed instead of delivering garbage."""
    served = copy.deepcopy(model)
    eng = ServingEngine(served, n_slots=2, draft_tokens=3, decode_steps_per_tick=spec_steps)
    out = eng.add_request(Request(prompt=_prompts(62, [5])[0], max_new_tokens=12))
    eng.step()
    assert out.status == "running" and len(out.tokens) >= 1
    delivered = list(out.tokens)
    with torch.no_grad():
        for p in served.parameters():
            p.fill_(float("nan"))
    eng.run(max_ticks=10)
    assert out.status == FAILED and out.finish_reason == FAIL_INTEGRITY
    assert out.tokens == delivered
    assert eng.integrity_trips == 1
    assert eng.pool.n_free == eng.pool.n_slots and not eng.has_work()


def test_spec_knob_validation(model):
    """JAX's refusals: a custom drafter under an explicit T > 1 raises
    naming the drafter; the n-gram drafter fuses; "auto" resolves to 8
    plain and 1 speculative; a negative draft_tokens raises."""
    with pytest.raises(NotImplementedError, match="drafter OracleDrafter"):
        ServingEngine(model, n_slots=1, decode_steps_per_tick=4, draft_tokens=2,
                      drafter=OracleDrafter({}))
    with pytest.raises(ValueError, match="draft_tokens"):
        ServingEngine(model, n_slots=1, draft_tokens=-1)
    fused = ServingEngine(model, n_slots=1, decode_steps_per_tick=4, draft_tokens=2)
    assert fused.decode_steps_per_tick == 4 and fused._spec_fused
    assert ServingEngine(model, n_slots=1).decode_steps_per_tick == 8
    assert ServingEngine(model, n_slots=1, draft_tokens=2).decode_steps_per_tick == 1
    assert ServingEngine(model, n_slots=1, draft_tokens=2,
                         drafter=OracleDrafter({}))._spec_width == 2


def test_paged_spec_greedy_parity(model):
    """``test_paged_greedy_parity``'s spec mode: the paged spec engine's
    greedy tokens equal the fixed-slot spec engine's, staggered."""
    prompts = _prompts(63, [9, 17, 19, 6])

    def run(paged):
        kw = dict(kv_block_tokens=8) if paged else {}
        eng = ServingEngine(model, n_slots=4, scheduler=SchedulerConfig(max_prefills_per_tick=4),
                            decode_steps_per_tick=1, draft_tokens=4, **kw)
        outs = []
        for p in prompts:
            outs.append(eng.add_request(Request(prompt=p, max_new_tokens=8)))
            eng.step()
        eng.run(max_ticks=500)
        return [o.tokens for o in outs], eng

    fixed, _ = run(False)
    paged, eng = run(True)
    assert fixed == paged
    eng.pool.allocator.check()


def test_spec_cancel_from_stream_callback(model):
    """A callback cancelling ANOTHER slot mid-delivery of a verify tick:
    the cancelled slot's block dies with it, the neighbour finishes."""
    prompts = _prompts(64, [5, 5])
    eng = ServingEngine(model, n_slots=2, scheduler=SchedulerConfig(max_prefills_per_tick=2),
                        draft_tokens=3)
    outs = {}

    def shoot(ev):
        other = outs.get("b")
        if other is not None and not other.done:
            eng.cancel(other.request.request_id)

    outs["a"] = eng.add_request(Request(prompt=prompts[0], max_new_tokens=12, on_token=shoot))
    outs["b"] = eng.add_request(Request(prompt=prompts[1], max_new_tokens=12))
    eng.run()
    assert outs["a"].status == FINISHED and outs["b"].status == "cancelled"
    assert eng.pool.n_free == 2


# -- on the card ------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the spec ticks' CUDA graphs have no CPU mode")
    return torch.device("cuda")


def _card_run(model, eager, **kw):
    eng = ServingEngine(model, n_slots=4, scheduler=SchedulerConfig(max_prefills_per_tick=4),
                        rng=torch.Generator(device="cuda").manual_seed(0), draft_tokens=3,
                        decode_steps_per_tick=4, prefill_buckets=(8, 16, 32, 64), **kw)
    if eager:
        eng._run_fused_eagerly()
    kinds = []
    replay = eng._replay
    eng._replay = lambda kind, body: (kinds.append(kind), replay(kind, body))[1]
    hot = SamplingParams(temperature=1.0)
    outs = [eng.add_request(Request(prompt=p, max_new_tokens=13,
                                    sampling=hot if i == 3 else SamplingParams()))
            for i, p in enumerate(_prompts(70, [5, 9, 20, 7]))]
    eng.run()
    return [o.tokens for o in outs[:3]], eng, kinds


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_captured_spec_graphs_equal_eager(cuda, layout):
    """The fused and unified spec bodies (greedy and sampled variants) are
    each captured once and replay bitwise the eager bodies' greedy tokens."""
    model = GPTLM(tiny_test(seq_len=64), device="cuda", seed=5).eval()
    kw = dict(prefill_chunk_tokens=8)
    if layout == "paged":
        kw["kv_block_tokens"] = 8
    eager, e_eng, e_kinds = _card_run(model, True, **kw)
    graph, g_eng, g_kinds = _card_run(model, False, **kw)
    assert e_eng.graph_captures == 0
    assert g_eng.graph_captures == len(set(g_kinds)) == len(g_eng._graphs)
    assert {k.replace("_sampled", "") for k in g_kinds} == {"spec_fused", "spec_unified"}
    assert graph == eager and e_kinds == g_kinds
    assert g_eng.metrics.tokens_drafted > 0
