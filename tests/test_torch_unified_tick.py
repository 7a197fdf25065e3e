"""Port parity for the unified ragged tick: every in-flight chunked
prefill folded into the fused tick's body (one ``[n_slots, chunk]``
extend, in-body activation of the slots whose prompt completes, then the
T decode steps), over the contiguous and the paged pool.

``tiny_test`` in fp32 on the CPU, weights bridged from a flax init,
prompts from a numpy seed.  The port's unified engine is held bitwise to
its own per-phase engine (greedy tokens, chunk counts) and exactly to
JAX's unified engine (tokens and the stream of events); the regressions
of ``tests/test_serving.py`` (chunk-only progress, EOS at activation and
mid-block, chunk starts batching) run on the port against static
``generate()``.

The JAX side is imported inside fixtures, so the ``gpu`` case at the end
runs on the card without JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_unified_tick.py
"""

import types

import numpy as np
import pytest
import torch

from tpu_parallel_torch.models import GPTLM, tiny_test
from tpu_parallel_torch.models.generate import generate
from tpu_parallel_torch.serving import FINISHED, Request, SchedulerConfig, ServingEngine

# one torch intra-op thread per test process: under pytest-xdist several
# processes share the cores, and torch's default (a thread per core in each)
# oversubscribes them
torch.set_num_threads(1)

VOCAB = 256


def _prompt(seed, n):
    return [int(t) for t in np.random.default_rng(seed).integers(1, VOCAB, n)]


@pytest.fixture(scope="module")
def pair():
    """(JAX side, port side) on one flax init bridged into the port."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from tpu_parallel import serving as jserving
    from tpu_parallel.models import GPTLM as JaxGPTLM
    from tpu_parallel.models import tiny_test as jax_tiny_test
    from tpu_parallel_torch import serving as tserving
    from tpu_parallel_torch.models.convert import params_from_jax

    jm = JaxGPTLM(jax_tiny_test(dtype=jnp.float32, remat=False))
    params = jm.init({"params": jax.random.PRNGKey(1)}, jnp.zeros((1, 5), jnp.int32),
                     train=False)["params"]
    cfg = tiny_test()
    model = GPTLM(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), cfg))
    model.eval()
    return (types.SimpleNamespace(api=jserving,
                                  make=lambda **kw: jserving.ServingEngine(jm, params, **kw)),
            types.SimpleNamespace(api=tserving,
                                  make=lambda **kw: tserving.ServingEngine(model, **kw)))


@pytest.fixture(scope="module")
def model():
    return GPTLM(tiny_test(), device="cpu", seed=3).eval()


def _reference(model, prompt, n):
    return generate(model, torch.tensor([prompt]), max_new_tokens=n)[0].tolist()


def _drive_interleaved(side, prompts, budgets, **kw):
    """JAX's interleaving script: submit one prompt per tick so chunked
    prefills interleave running decodes, then run to idle.  Returns
    (engine, outputs, events)."""
    eng = side.make(scheduler=side.api.SchedulerConfig(max_prefills_per_tick=2),
                    clock=lambda: 0.0, **kw)
    outs = [eng.add_request(side.api.Request(prompt=prompts[0], max_new_tokens=budgets[0],
                                             request_id="r0"))]
    events = eng.step()
    for i, (p, n) in enumerate(zip(prompts[1:], budgets[1:]), 1):
        outs.append(eng.add_request(side.api.Request(prompt=p, max_new_tokens=n,
                                                     request_id=f"r{i}")))
        events += eng.step()
    events += eng.run()
    return eng, outs, events


def _record(outs, events):
    return ([(o.status, o.finish_reason, list(o.tokens)) for o in outs],
            [(e.request_id, e.token, e.index, e.finished, e.finish_reason) for e in events])


LAYOUTS = {
    "plain": dict(),
    "paged": dict(kv_block_tokens="auto"),
    "paged_prefix": dict(kv_block_tokens="auto", prefix_cache_size=2),
}
LENS, BUDGETS = [3, 12, 9, 14, 5], [9, 5, 7, 4, 6]


@pytest.mark.parametrize("variant", sorted(LAYOUTS))
def test_unified_tick_bitwise_vs_per_phase(pair, variant):
    """The port's unified tick gives its per-phase tick's greedy tokens,
    bitwise, across staggered arrivals, chunk + decode interleave and slot
    reuse, with the same chunk count and fewer host dispatches; every
    slot is free at the end (and, paged, every block outside the prefix
    cache)."""
    _, port = pair
    prompts = [_prompt(20 + i, n) for i, n in enumerate(LENS)]
    kw = dict(n_slots=2, prefill_buckets=(4, 8, 16), prefill_chunk_tokens=4,
              decode_steps_per_tick=4, **LAYOUTS[variant])
    phase_eng, phased, _ = _drive_interleaved(port, prompts, BUDGETS, unified_tick=False, **kw)
    uni_eng, unified, _ = _drive_interleaved(port, prompts, BUDGETS, **kw)
    assert uni_eng.unified_tick and not phase_eng.unified_tick
    assert all(o.status == FINISHED for o in phased + unified)
    assert [o.tokens for o in unified] == [o.tokens for o in phased]
    assert uni_eng.metrics.prefill_chunks >= 3
    assert phase_eng.metrics.prefill_chunks == uni_eng.metrics.prefill_chunks
    assert uni_eng.metrics.host_dispatches < phase_eng.metrics.host_dispatches
    assert uni_eng.pool.n_free == 2
    if variant != "plain":
        pool = uni_eng.pool
        pool.allocator.check()
        held = {b for blocks, _ in (uni_eng._prefix.values() if uni_eng._prefix else [])
                for b in blocks}
        assert pool.blocks_in_use == len(held)


@pytest.mark.parametrize("variant", sorted(LAYOUTS))
def test_unified_engine_matches_jax_unified_engine(pair, variant):
    """The port's unified engine against JAX's unified engine on the same
    script: statuses, tokens and the stream of events, exactly."""
    jax_side, port = pair
    prompts = [_prompt(20 + i, n) for i, n in enumerate(LENS)]
    kw = dict(n_slots=2, prefill_buckets=(4, 8, 16), prefill_chunk_tokens=4,
              decode_steps_per_tick=4, **LAYOUTS[variant])
    j_eng, j_outs, j_events = _drive_interleaved(jax_side, prompts, BUDGETS, **kw)
    eng, outs, events = _drive_interleaved(port, prompts, BUDGETS, **kw)
    assert j_eng.unified_tick and eng.unified_tick
    assert _record(outs, events) == _record(j_outs, j_events)
    assert eng.metrics.prefill_chunks == j_eng.metrics.prefill_chunks
    assert eng.metrics.host_dispatches == j_eng.metrics.host_dispatches


def test_unified_tick_chunk_only_progress(model):
    """A tick holding ONLY mid-chunk prefill rows (no decode-live slot)
    advances by its chunk alone: no desync error, no spin, nothing
    delivered until the prompt completes."""
    long = _prompt(1, 14)
    ref = _reference(model, long, 4)
    eng = ServingEngine(model, n_slots=1, prefill_buckets=(4, 8, 16), prefill_chunk_tokens=4,
                        decode_steps_per_tick=8)
    assert eng.unified_tick
    out = eng.add_request(Request(prompt=long, max_new_tokens=4))
    for tick in range(3):
        assert eng.step() == [], f"tick {tick} delivered early"
        assert len(out.tokens) == 0
    assert eng.metrics.prefill_chunks == 3
    eng.run()
    assert out.status == FINISHED and out.tokens == ref


def test_unified_tick_eos_at_activation_and_mid_block(model):
    """EOS through the unified tick: an EOS that IS the first token
    (sampled in the body at activation) retires the slot before it ever
    decodes, and an EOS mid-block truncates delivery; both equal the
    per-phase engine, and the slot is clean for reuse."""
    long = _prompt(2, 11)
    ref = _reference(model, long, 12)

    def drive(eos, unified):
        eng = ServingEngine(model, n_slots=1, prefill_buckets=(4, 8, 16),
                            prefill_chunk_tokens=4, decode_steps_per_tick=8,
                            unified_tick=unified)
        out = eng.add_request(Request(prompt=long, max_new_tokens=12, eos_token_id=eos))
        eng.run()
        nxt = eng.add_request(Request(prompt=long, max_new_tokens=3))
        eng.run()
        assert eng.pool.n_free == 1
        return out, nxt

    for eos_idx in (0, 3):
        eos = ref[eos_idx]
        a, a_next = drive(eos, unified=False)
        b, b_next = drive(eos, unified=True)
        assert a.finish_reason == b.finish_reason == "eos"
        assert b.tokens == a.tokens and b.tokens[-1] == eos
        assert b_next.tokens == a_next.tokens == ref[:3]


def test_unified_tick_chunk_starts_batch(model):
    """Under the unified tick chunked prompts share ONE admission group:
    two long prompts admit in the same tick and ride the same chunk
    phase; tokens equal static generate()."""
    longs = [_prompt(40 + i, 11 + i) for i in range(2)]
    refs = [_reference(model, p, 5) for p in longs]
    eng = ServingEngine(model, n_slots=2, scheduler=SchedulerConfig(max_prefills_per_tick=2),
                        prefill_buckets=(4, 8, 16), prefill_chunk_tokens=4,
                        decode_steps_per_tick=4)
    outs = [eng.add_request(Request(prompt=p, max_new_tokens=5)) for p in longs]
    eng.step()
    assert eng.in_flight == 2 and eng.scheduler.depth == 0
    eng.run()
    assert all(o.status == FINISHED for o in outs)
    assert [o.tokens for o in outs] == refs


def test_unified_tick_resolution(model):
    """``unified_tick="auto"`` resolves as JAX's: on with the fused tick,
    off per-step; True needs a fused tick."""
    assert ServingEngine(model, n_slots=1).unified_tick
    assert not ServingEngine(model, n_slots=1, decode_steps_per_tick=1).unified_tick
    assert not ServingEngine(model, n_slots=1, unified_tick=False).unified_tick
    with pytest.raises(ValueError, match="decode_steps_per_tick > 1"):
        ServingEngine(model, n_slots=1, decode_steps_per_tick=1, unified_tick=True)


# -- on the card ------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("paged", [False, True])
def test_captured_unified_tick_equals_eager(paged):
    """On the card: two captured bodies (fused and unified) per engine, the
    same tokens as the eager bodies and as the per-phase captured engine,
    bitwise; the unified engine dispatches less."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the captured ticks have no CPU mode")
    model = GPTLM(tiny_test(seq_len=64), device="cuda", seed=5).eval()
    prompts = [_prompt(50 + i, n) for i, n in enumerate((5, 23, 3, 40, 9, 17))]
    layout = dict(kv_block_tokens=8) if paged else {}
    results = {}
    for name, eager, unified in (("eager", True, True), ("graph", False, True),
                                 ("per_phase", False, False)):
        eng = ServingEngine(model, n_slots=4, scheduler=SchedulerConfig(max_prefills_per_tick=2),
                            rng=torch.Generator(device="cuda").manual_seed(0),
                            prefill_buckets=(8, 16, 32, 64), prefill_chunk_tokens=8,
                            decode_steps_per_tick=4, unified_tick=unified, **layout)
        if eager:
            eng._run_fused_eagerly()
        outs = [eng.add_request(Request(prompt=p, max_new_tokens=11)) for p in prompts[:3]]
        eng.step()
        outs += [eng.add_request(Request(prompt=p, max_new_tokens=11)) for p in prompts[3:]]
        eng.run()
        assert all(o.status == FINISHED for o in outs)
        results[name] = ([o.tokens for o in outs], eng.graph_captures,
                         eng.metrics.host_dispatches)
    assert (results["eager"][1], results["graph"][1], results["per_phase"][1]) == (0, 2, 1)
    assert results["eager"][0] == results["graph"][0] == results["per_phase"][0]
    assert results["graph"][2] < results["per_phase"][2]
