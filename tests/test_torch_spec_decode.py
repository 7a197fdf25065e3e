"""Port parity for speculative decoding's units
(``serving/spec_decode.py``, ``models/generate.py:verify_step``): the cases
of ``tests/test_spec_decode.py`` re-run against the port (the int8
cache's is in ``tests/test_torch_int8_kv.py``), and the cross-package
contract.

- The drafter, acceptance and adaptation units run as in JAX: the same
  arrays, the same asserted values.  ``rejection_verify`` draws from a
  ``torch.Generator``, so its statistical cases hold the port to the same
  laws, not to JAX's random bits.
- Cross-package: ``greedy_verify``, ``_emit`` and ``adapt_draft_len_traced``
  equal JAX's on seeded random arrays; ``ngram_draft_tokens`` equals JAX's
  and the host ``NGramDrafter`` over seeded random histories (hypothesis);
  ``verify_step``'s hidden states and cache within atol = rtol = 1e-5 of
  JAX's (fp32, bridged weights) for scanned and unrolled layers, through a
  contiguous and a paged cache; ``generate_speculative``'s greedy tokens
  equal to JAX's and to the port's ``generate``.

``tiny_test`` in fp32 on the CPU; inputs from numpy seeds.  The JAX side is
imported inside fixtures.
"""

import types

import numpy as np
import pytest
import torch
from _spec_drafters import AntiOracleDrafter, OracleDrafter, ref_map
from hypothesis import given, settings
from hypothesis import strategies as st

from tpu_parallel_torch.models import GPTLM, tiny_test
from tpu_parallel_torch.models import generate as tgen
from tpu_parallel_torch.models.layers import PagedKVCache
from tpu_parallel_torch.serving import spec_decode as sd
from tpu_parallel_torch.serving.spec_decode import (
    NGramDrafter,
    adapt_draft_len,
    generate_speculative,
    greedy_verify,
    rejection_verify,
    verify_tokens,
)

# one torch intra-op thread per test process: under pytest-xdist several
# processes share the cores, and torch's default (a thread per core in each)
# oversubscribes them
torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)
VOCAB = 256


def _t(x, dtype=torch.long):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


def _one_hot(idx, vocab):
    return torch.nn.functional.one_hot(torch.as_tensor(idx), vocab).float()


# -- drafter ------------------------------------------------------------------------


def test_ngram_drafter_cycle():
    d = NGramDrafter(max_ngram=3, min_ngram=1)
    ctx = [1, 2, 3, 1, 2, 3, 1, 2]
    assert d.draft(ctx, 3) == [3, 1, 2]
    assert d.draft(ctx, 1) == [3]
    assert d.draft(ctx, 3) == d.draft(ctx, 3)


def test_ngram_drafter_no_match_and_bounds():
    d = NGramDrafter(max_ngram=3, min_ngram=2)
    assert d.draft([1, 2, 3, 4, 5], 4) == []
    assert d.draft([7], 4) == []
    assert d.draft([1, 2, 1, 2], 0) == []
    # the most RECENT earlier occurrence wins
    assert NGramDrafter(max_ngram=1).draft([5, 9, 5, 8, 5], 1) == [8]
    with pytest.raises(ValueError):
        NGramDrafter(max_ngram=2, min_ngram=3)


def test_ngram_drafter_prefers_longer_match():
    d = NGramDrafter(max_ngram=2, min_ngram=1)
    assert d.draft([1, 2, 7, 4, 2, 9, 1, 2], 1) == [7]


# -- acceptance rules ---------------------------------------------------------------


def test_greedy_verify_longest_prefix_plus_bonus():
    drafts = _t([[5, 6, 7], [5, 6, 7], [1, 1, 1]])
    targets = _t([[5, 6, 9, 4], [5, 6, 7, 8], [2, 3, 4, 5]])
    out, acc = greedy_verify(drafts, _t([3, 3, 2]), targets)
    assert acc.tolist() == [2, 3, 0]
    out = out.numpy()
    assert list(out[0][:3]) == [5, 6, 9]
    assert list(out[1][:4]) == [5, 6, 7, 8]
    assert out[2][0] == 2


def test_greedy_verify_draft_len_caps_acceptance():
    out, acc = greedy_verify(_t([[5, 6, 7]]), _t([1]), _t([[5, 6, 7, 8]]))
    assert int(acc[0]) == 1
    assert list(out.numpy()[0][:2]) == [5, 6]


def test_rejection_verify_pointmass_always_accepts():
    probs = _one_hot([3, 5, 6], 8)[None]
    out, acc = rejection_verify(_t([[3, 5]]), _t([2]), probs, torch.Generator().manual_seed(0))
    assert int(acc[0]) == 2
    assert out.numpy()[0].tolist() == [3, 5, 6]


def test_rejection_verify_zero_prob_always_rejects():
    p = torch.full((1, 2, 8), 1.0 / 8)
    p[0, 0, 3] = 0.0
    p = p / p.sum(-1, keepdim=True)
    for seed in range(5):
        out, acc = rejection_verify(_t([[3]]), _t([1]), p, torch.Generator().manual_seed(seed))
        assert int(acc[0]) == 0
        assert int(out[0, 0]) != 3


def test_rejection_verify_first_token_distribution():
    """The marginal of the first emitted token equals the target
    distribution p whatever was drafted (accept with p(d), else resample
    from the residual), over many parallel rows."""
    n, vocab = 4000, 4
    p_row = torch.tensor([0.1, 0.2, 0.3, 0.4])
    probs = p_row.expand(n, 2, vocab)
    out, _ = rejection_verify(torch.full((n, 1), 3, dtype=torch.long),
                              torch.ones(n, dtype=torch.long), probs,
                              torch.Generator().manual_seed(7))
    emp = np.bincount(out[:, 0].numpy(), minlength=vocab) / n
    np.testing.assert_allclose(emp, p_row.numpy(), atol=0.03)


def test_verify_tokens_mixed_greedy_and_sampled():
    rows = torch.stack([_one_hot([2, 4, 1], 6) + 1e-6] * 2)
    logits = rows.log()
    for sampled in (None, True):
        out, acc = verify_tokens(_t([[2, 4], [2, 9]]), _t([2, 2]), logits,
                                 torch.Generator().manual_seed(0), torch.tensor([0.0, 0.5]),
                                 torch.zeros(2, dtype=torch.long), torch.zeros(2), sampled=sampled)
        assert int(acc[0]) == 2 and out[0].tolist() == [2, 4, 1]
        assert int(acc[1]) == 1 and out[1, :2].tolist() == [2, 4]


def test_verify_tokens_greedy_batch_skips_sampling():
    """An all-greedy batch never draws: the generator's state is untouched,
    so the engine's greedy graph variant consumes no randomness."""
    gen = torch.Generator().manual_seed(3)
    before = gen.get_state()
    logits = torch.randn(3, 4, 16, generator=torch.Generator().manual_seed(1))
    out, acc = verify_tokens(_t([[1, 2, 3]] * 3), _t([3, 1, 0]), logits, gen, torch.zeros(3),
                             torch.zeros(3, dtype=torch.long), torch.zeros(3), sampled=False)
    want, want_acc = greedy_verify(_t([[1, 2, 3]] * 3), _t([3, 1, 0]), logits.argmax(-1))
    assert torch.equal(out, want) and torch.equal(acc, want_acc)
    assert torch.equal(gen.get_state(), before)


def test_adapt_draft_len_rule():
    assert adapt_draft_len(4, drafted=4, accepted=4, k_max=8) == 5
    assert adapt_draft_len(8, drafted=8, accepted=8, k_max=8) == 8
    assert adapt_draft_len(8, drafted=8, accepted=2, k_max=8) == 3
    assert adapt_draft_len(4, drafted=4, accepted=0, k_max=8) == 1
    assert adapt_draft_len(3, drafted=0, accepted=0, k_max=8) == 3


# -- against the JAX package --------------------------------------------------------


@pytest.fixture(scope="module")
def jspec():
    pytest.importorskip("jax")
    from tpu_parallel.serving import spec_decode

    return spec_decode


@pytest.mark.parametrize("seed", range(4))
def test_greedy_verify_emit_and_adaptation_match_jax(jspec, seed):
    import jax.numpy as jnp

    rs = np.random.default_rng(seed)
    n, k = 12, 4
    drafts = rs.integers(0, 3, (n, k)).astype(np.int32)
    dlen = rs.integers(0, k + 1, n).astype(np.int32)
    targets = rs.integers(0, 3, (n, k + 1)).astype(np.int32)
    want_tok, want_acc = jspec.greedy_verify(jnp.asarray(drafts), jnp.asarray(dlen),
                                             jnp.asarray(targets))
    got_tok, got_acc = greedy_verify(_t(drafts), _t(dlen), _t(targets))
    np.testing.assert_array_equal(got_tok.numpy(), np.asarray(want_tok))
    np.testing.assert_array_equal(got_acc.numpy(), np.asarray(want_acc))
    accepted = rs.integers(0, k + 1, n).astype(np.int32)
    bonus = rs.integers(0, VOCAB, n).astype(np.int32)
    np.testing.assert_array_equal(
        sd._emit(_t(drafts), _t(accepted), _t(bonus)).numpy(),
        np.asarray(jspec._emit(jnp.asarray(drafts), jnp.asarray(accepted), jnp.asarray(bonus))))
    keff = rs.integers(1, k + 1, n).astype(np.int32)
    kmax = rs.integers(0, k + 1, n).astype(np.int32)
    acc = np.minimum(accepted, dlen)
    np.testing.assert_array_equal(
        sd.adapt_draft_len_traced(_t(keff), _t(dlen), _t(acc), _t(kmax)).numpy(),
        np.asarray(jspec.adapt_draft_len_traced(jnp.asarray(keff), jnp.asarray(dlen),
                                                jnp.asarray(acc), jnp.asarray(kmax))))


def test_ngram_device_drafter_matches_host():
    """JAX's sweep: the tensor twin is token-identical to the host drafter
    over random histories, caps and n-gram ladders."""
    rng = np.random.default_rng(0)
    L, k = 24, 4
    for max_ngram, min_ngram in ((3, 1), (2, 2), (4, 1)):
        host = NGramDrafter(max_ngram=max_ngram, min_ngram=min_ngram)
        hist = np.zeros((64, L), np.int64)
        hlen = np.zeros(64, np.int64)
        cap = np.zeros(64, np.int64)
        want_drafts = np.zeros((64, k), np.int64)
        want_dlen = np.zeros(64, np.int64)
        for r in range(64):
            n = int(rng.integers(1, L + 1))
            ctx = rng.integers(0, 4, size=n)
            hist[r, :n] = ctx
            hlen[r] = n
            cap[r] = int(rng.integers(0, k + 1))
            d = list(host.draft([int(t) for t in ctx], int(cap[r])))[:int(cap[r])]
            want_dlen[r] = len(d)
            want_drafts[r, :len(d)] = d
        drafts, dlen = sd.ngram_draft_tokens(_t(hist), _t(hlen), _t(cap), k, max_ngram=max_ngram,
                                             min_ngram=min_ngram)
        np.testing.assert_array_equal(dlen.numpy(), want_dlen)
        np.testing.assert_array_equal(drafts.numpy(), want_drafts)


@settings(max_examples=12, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), ladder=st.sampled_from([(3, 1), (2, 2), (4, 1), (1, 1)]),
       k=st.integers(1, 5), vocab=st.integers(2, 6))
def test_ngram_draft_tokens_matches_jax_and_host(jspec, seed, ladder, k, vocab):
    """Over seeded random histories (garbage beyond each row's length,
    which neither side may read) the tensor drafter equals JAX's and the
    host drafter's block."""
    import jax.numpy as jnp

    max_ngram, min_ngram = ladder
    rs = np.random.default_rng(seed)
    rows, L = 16, 20
    hist = rs.integers(0, vocab, (rows, L)).astype(np.int32)
    hlen = rs.integers(1, L + 1, rows).astype(np.int32)
    cap = rs.integers(-1, k + 1, rows).astype(np.int32)
    drafts, dlen = sd.ngram_draft_tokens(_t(hist), _t(hlen), _t(cap), k, max_ngram, min_ngram)
    j_drafts, j_dlen = jspec.ngram_draft_tokens(jnp.asarray(hist), jnp.asarray(hlen),
                                                jnp.asarray(cap), k, max_ngram, min_ngram)
    np.testing.assert_array_equal(drafts.numpy(), np.asarray(j_drafts))
    np.testing.assert_array_equal(dlen.numpy(), np.asarray(j_dlen))
    host = NGramDrafter(max_ngram, min_ngram)
    for r in range(rows):
        d = host.draft([int(t) for t in hist[r, :hlen[r]]], int(cap[r]))[:max(int(cap[r]), 0)]
        assert dlen[r] == len(d) and drafts[r, :len(d)].tolist() == d
        assert not drafts[r, len(d):].any()


# -- verify_step and generate_speculative against JAX --------------------------------


CONFIGS = {"scanned": dict(), "unrolled": dict(scan_layers=False)}


@pytest.fixture(scope="module")
def bridged():
    """config name -> (JAX model, params, port model) on one flax init."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from tpu_parallel.models import GPTLM as JaxGPTLM
    from tpu_parallel.models import tiny_test as jax_tiny_test
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
            made[name] = types.SimpleNamespace(jax=jax, jm=jm, params=params, model=model.eval(),
                                               kw=kw)
        return made[name]

    return get


def _verify_inputs():
    """Three rows: a full draft block, a short one (pad offsets at -1) and
    a parked row (write index seq_len)."""
    rs = np.random.default_rng(21)
    prompt = rs.integers(1, VOCAB, (3, 9)).astype(np.int32)
    tokens = rs.integers(1, VOCAB, (3, 5)).astype(np.int32)
    positions = 9 + np.arange(5, dtype=np.int32)[None, :].repeat(3, 0)
    positions[1, 3:] = -1
    widx = np.array([9, 9, 32], np.int32)
    return prompt, tokens, positions, widx


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_verify_step_matches_jax_contiguous(bridged, config):
    b = bridged(config)
    jnp = b.jax.numpy
    from tpu_parallel.models import generate as jgen

    prompt, tokens, positions, widx = _verify_inputs()
    ppos = np.arange(9, dtype=np.int32)[None, :].repeat(3, 0)
    _, j_cache = jgen.prefill_step(b.jm, b.params, jnp.asarray(prompt), jnp.asarray(ppos))
    hid_j, j_cache = jgen.verify_step(b.jm, b.params, j_cache, jnp.asarray(tokens),
                                      jnp.asarray(positions), jnp.asarray(widx))
    with torch.no_grad():
        _, t_cache = tgen.prefill_step(b.model, _t(prompt), _t(ppos))
        hid_t, _ = tgen.verify_step(b.model, t_cache, _t(tokens), _t(positions), _t(widx))
    real = positions >= 0
    real[2] = False  # the parked row's outputs are never read
    np.testing.assert_allclose(hid_t.numpy()[real], np.asarray(hid_j)[real], **TOL)
    j_layers = b.jax.tree.leaves(j_cache)
    j_pos = [x for x in j_layers if x.dtype == jnp.int32 and x.ndim >= 2]
    stored = np.asarray(j_pos[0])
    stored = stored[0] if stored.ndim == 3 else stored  # scanned: [layers, b, seq]
    np.testing.assert_array_equal(t_cache[0].pos.numpy(), stored)


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_verify_step_matches_jax_paged(bridged, config):
    import dataclasses

    b = bridged(config)
    jnp = b.jax.numpy
    from tpu_parallel import serving as jserving
    from tpu_parallel.models import generate as jgen

    bt, n_blocks = 8, 10
    jm = type(b.jm)(dataclasses.replace(b.jm.config, kv_block_tokens=bt, kv_pool_blocks=n_blocks))
    j_cache = jserving.PagedCachePool(jm, b.params, n_slots=3).cache
    table = np.array([[3, 7, -1, -1], [0, 1, -1, -1], [2, -1, -1, -1]], np.int32)
    prompt, tokens, positions, widx = _verify_inputs()
    ppos = np.arange(9, dtype=np.int32)[None, :].repeat(3, 0)
    start = np.zeros(3, np.int32)
    _, j_cache = jgen.prefill_extend_step(jm, b.params, j_cache, jnp.asarray(prompt),
                                          jnp.asarray(ppos), jnp.asarray(start),
                                          block_table=jnp.asarray(table))
    hid_j, j_cache = jgen.verify_step(jm, b.params, j_cache, jnp.asarray(tokens),
                                      jnp.asarray(positions), jnp.asarray(widx),
                                      block_table=jnp.asarray(table))
    cfg = tiny_test(kv_block_tokens=bt, kv_pool_blocks=n_blocks, **b.kw)
    t_cache = [PagedKVCache.empty(cfg, "cpu") for _ in range(cfg.n_layers)]
    t_table = _t(table)
    with torch.no_grad():
        tgen.prefill_extend_step(b.model, t_cache, _t(prompt), _t(ppos), _t(start),
                                 block_table=t_table)
        hid_t, _ = tgen.verify_step(b.model, t_cache, _t(tokens), _t(positions), _t(widx),
                                    block_table=t_table)
    real = positions >= 0
    real[2] = False
    np.testing.assert_allclose(hid_t.numpy()[real], np.asarray(hid_j)[real], **TOL)


def _gen_setup(b, n_rows, seed=0):
    prompt = np.random.default_rng(seed).integers(1, VOCAB, (n_rows, 5)).astype(np.int32)
    return prompt


@pytest.mark.parametrize("draft_tokens", [0, 3])
def test_generate_speculative_greedy_parity(bridged, draft_tokens):
    """Greedy draft-verify decoding equals the port's ``generate()`` and
    JAX's ``generate_speculative`` token for token (draft_tokens=0: the
    per-token host loop)."""
    b = bridged("scanned")
    jnp = b.jax.numpy
    from tpu_parallel.serving.spec_decode import generate_speculative as jgen_spec

    prompt = _gen_setup(b, 3)
    want = tgen.generate(b.model, _t(prompt), max_new_tokens=10).numpy()
    got = generate_speculative(b.model, _t(prompt), max_new_tokens=10,
                               draft_tokens=draft_tokens).numpy()
    np.testing.assert_array_equal(got, want)
    j = jgen_spec(b.jm, b.params, jnp.asarray(prompt), max_new_tokens=10,
                  draft_tokens=draft_tokens)
    np.testing.assert_array_equal(got, np.asarray(j))


def test_generate_speculative_stats_match_jax(bridged):
    """Same drafts, same acceptance, same adaptation: the standalone loop's
    stats equal JAX's on the unrolled config."""
    b = bridged("unrolled")
    jnp = b.jax.numpy
    from tpu_parallel.serving.spec_decode import generate_speculative as jgen_spec

    motif = [7, 9, 11]
    prompt = np.array([motif * 3, [5, 6, 7, 5, 6, 7, 5, 6, 8]], np.int32)
    got, stats = generate_speculative(b.model, _t(prompt), max_new_tokens=12, draft_tokens=3,
                                      return_stats=True)
    want, j_stats = jgen_spec(b.jm, b.params, jnp.asarray(prompt), max_new_tokens=12,
                              draft_tokens=3, return_stats=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert stats == j_stats and stats["drafted"] > 0


def test_generate_speculative_adversarial_drafter_exact(bridged):
    b = bridged("scanned")
    prompt = _gen_setup(b, 2, seed=1)
    want = tgen.generate(b.model, _t(prompt), max_new_tokens=8).numpy()
    drafter = AntiOracleDrafter(ref_map(list(prompt), want), VOCAB)
    got, stats = generate_speculative(b.model, _t(prompt), max_new_tokens=8, draft_tokens=3,
                                      drafter=drafter, return_stats=True)
    np.testing.assert_array_equal(got.numpy(), want)
    assert stats["drafted"] > 0 and stats["accepted"] == 0
    assert stats["acceptance_rate"] == 0.0


def test_generate_speculative_oracle_multi_token_ticks(bridged):
    b = bridged("scanned")
    prompt = _gen_setup(b, 2, seed=2)
    want = tgen.generate(b.model, _t(prompt), max_new_tokens=12).numpy()
    got, stats = generate_speculative(b.model, _t(prompt), max_new_tokens=12, draft_tokens=4,
                                      drafter=OracleDrafter(ref_map(list(prompt), want)),
                                      return_stats=True)
    np.testing.assert_array_equal(got.numpy(), want)
    assert stats["ticks"] <= 4
    assert stats["acceptance_rate"] == 1.0
    assert stats["tokens_per_tick"] > 2.0


def test_generate_speculative_rejects_overlong():
    model = GPTLM(tiny_test(), device="cpu", seed=3).eval()
    prompt = torch.ones(2, 5, dtype=torch.long)
    with pytest.raises(ValueError, match="seq_len"):
        generate_speculative(model, prompt, max_new_tokens=model.config.seq_len)
    with pytest.raises(ValueError, match="draft_tokens"):
        generate_speculative(model, prompt, max_new_tokens=4, draft_tokens=-1)


def test_generate_speculative_sampled_stays_in_vocab_and_seeds_repeat():
    """Sampled speculative decoding: tokens in the vocabulary, the same
    seed gives the same stream (the rejection rule draws only from the
    generator it is given)."""
    model = GPTLM(tiny_test(), device="cpu", seed=3).eval()
    prompt = torch.tensor([[3, 4, 3, 4, 3, 4], [9, 8, 7, 6, 5, 4]])

    def run(seed):
        return generate_speculative(model, prompt, torch.Generator().manual_seed(seed),
                                    max_new_tokens=10, draft_tokens=3, temperature=1.0,
                                    top_p=0.9).tolist()

    a = run(5)
    assert a == run(5)
    assert all(0 <= t < VOCAB for row in a for t in row)
