"""Port parity for beam search: ``models/generate.py:generate_beam`` (lazy,
through per-slot ``beam_src`` tables and ``beam_decode_attention``, and
eager, the cache reordered every step) and the layers' lazy beam read.

The JAX package's beam cases of ``tests/test_generate.py`` re-run on the
port, and the cross-package contract: ``generate_beam`` tokens equal to
JAX's and scores within 1e-5, lazy and eager; ``beam_decode_attention``
against JAX's on random inputs; and JAX's top-k tie order (the lower index
first among equal values), planted in the top-k itself and in a model
whose logits all tie.  ``tiny_test`` in fp32 on the CPU, weights bridged
from a flax init, inputs from numpy seeds; JAX is imported inside
fixtures.
"""

import itertools

import numpy as np
import pytest
import torch

from tpu_parallel_torch.models import GPTLM, tiny_test
from tpu_parallel_torch.models import layers
from tpu_parallel_torch.models.generate import _top_k, generate, generate_beam

# one torch intra-op thread per test process: under pytest-xdist several
# processes share the cores, and torch's default (a thread per core in each)
# oversubscribes them
torch.set_num_threads(1)

VOCAB = 256
VARIANTS = {"mha": dict(), "gqa": dict(n_kv_heads=2), "int8": dict(kv_cache_dtype="int8"),
            "unrolled": dict(scan_layers=False)}


def _seq_logprob(model, prompt, new_tokens):
    """Each row's log-probability of ``new_tokens`` after ``prompt``,
    teacher-forced through the plain forward."""
    with torch.no_grad():
        logits = model(torch.cat([prompt, new_tokens], dim=1)).float()
    logp = torch.log_softmax(logits, dim=-1)[:, prompt.shape[1] - 1:-1]
    return logp.gather(2, new_tokens[:, :, None])[:, :, 0].sum(dim=1)


def _prompt(seed, shape, vocab=VOCAB):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, vocab, shape)).long()


# -- the JAX package's cases, on the port ----------------------------------------------


def test_beam_search_beats_or_matches_greedy():
    """The winning beam's sequence log-prob is >= greedy's, and the reported
    score is the recomputed sequence log-prob."""
    model = GPTLM(tiny_test(), device="cpu", seed=1).eval()
    prompt = _prompt(0, (2, 4))
    greedy = generate(model, prompt, max_new_tokens=5)
    beam, scores = generate_beam(model, prompt, max_new_tokens=5, num_beams=4)
    lp_greedy = _seq_logprob(model, prompt, greedy)
    lp_beam = _seq_logprob(model, prompt, beam)
    assert (lp_beam >= lp_greedy - 1e-5).all()
    np.testing.assert_allclose(scores.numpy(), lp_beam.numpy(), rtol=1e-4, atol=1e-4)


def test_beam_search_exact_with_full_beam():
    """At horizon 2 with num_beams = vocab_size beam search is exhaustive:
    the result is the brute-force optimum."""
    cfg = tiny_test(vocab_size=6, d_model=16, n_heads=2, n_layers=2, seq_len=16)
    model = GPTLM(cfg, device="cpu", seed=2).eval()
    prompt = torch.tensor([[1, 2]])
    beam, score = generate_beam(model, prompt, max_new_tokens=2, num_beams=6)
    pairs = torch.tensor(list(itertools.product(range(6), repeat=2)))
    lps = _seq_logprob(model, prompt.expand(len(pairs), 2), pairs)
    best = int(lps.argmax())
    assert beam[0].tolist() == pairs[best].tolist()
    np.testing.assert_allclose(float(score[0]), float(lps[best]), rtol=1e-4)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_beam_lazy_matches_eager(variant):
    """Lazy (source-row tables) and eager (per-step reorder) beams give the
    same tokens, scores within 1e-5, over MHA, GQA, the int8 cache (lazy
    dequantizes, eager reads int8-natively) and unrolled layers."""
    model = GPTLM(tiny_test(**VARIANTS[variant]), device="cpu", seed=7).eval()
    prompt = _prompt(1, (3, 5))
    lazy_toks, lazy_scores = generate_beam(model, prompt, max_new_tokens=8, num_beams=4,
                                           lazy=True)
    eager_toks, eager_scores = generate_beam(model, prompt, max_new_tokens=8, num_beams=4,
                                             lazy=False)
    assert torch.equal(lazy_toks, eager_toks)
    np.testing.assert_allclose(lazy_scores.numpy(), eager_scores.numpy(), rtol=1e-5, atol=1e-5)


def test_beam_refuses_paged_cache_and_write_index():
    model = GPTLM(tiny_test(beam_width=2, kv_block_tokens=8, kv_pool_blocks=4), device="cpu")
    with pytest.raises(NotImplementedError, match="beam"):
        model.init_cache(2)
    model = GPTLM(tiny_test(beam_width=2), device="cpu")
    cache = model.init_cache(4)
    assert all(torch.equal(c.beam_src[:, 5], torch.arange(4, dtype=torch.int32)) for c in cache)
    with pytest.raises(NotImplementedError, match="beam"):
        model(torch.zeros(4, 1, dtype=torch.long), decode=True, cache=cache,
              write_index=torch.zeros(4, dtype=torch.long))


# -- against the JAX package ----------------------------------------------------------


@pytest.fixture(scope="module")
def bridged():
    """variant -> (JAX model, params, port model), built once each."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from tpu_parallel.models import GPTLM as JaxGPTLM
    from tpu_parallel.models import tiny_test as jax_tiny_test
    from tpu_parallel_torch.models.convert import params_from_jax

    made = {}

    def get(variant):
        if variant not in made:
            kw = VARIANTS[variant]
            jm = JaxGPTLM(jax_tiny_test(dtype=jnp.float32, remat=False, **kw))
            params = jm.init({"params": jax.random.PRNGKey(7)}, jnp.zeros((1, 5), jnp.int32),
                             train=False)["params"]
            cfg = tiny_test(**kw)
            model = GPTLM(cfg, device="cpu")
            model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), cfg))
            made[variant] = (jm, params, model.eval())
        return made[variant]

    return get


@pytest.mark.parametrize("lazy", [True, False])
@pytest.mark.parametrize("variant", ["gqa", "int8"])
def test_generate_beam_matches_jax(bridged, variant, lazy):
    import jax.numpy as jnp

    from tpu_parallel.models.generate import generate_beam as jax_generate_beam

    jm, params, model = bridged(variant)
    prompt = _prompt(2, (3, 5))
    want_toks, want_scores = jax_generate_beam(jm, params, jnp.asarray(prompt.numpy()),
                                               max_new_tokens=8, num_beams=4, lazy=lazy,
                                               length_penalty=1.0)
    toks, scores = generate_beam(model, prompt, max_new_tokens=8, num_beams=4, lazy=lazy,
                                 length_penalty=1.0)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(want_toks))
    np.testing.assert_allclose(scores.numpy(), np.asarray(want_scores), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("window", [0, 4])
@pytest.mark.parametrize("kv_heads", [4, 2])
def test_beam_decode_attention_matches_jax(kv_heads, window):
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from tpu_parallel.models.layers import beam_decode_attention as jax_beam_attention

    rs = np.random.default_rng(kv_heads * 10 + window)
    b, kb, nq, h, s, d = 2, 3, 1, 4, 10, 8
    rows = b * kb
    q = rs.standard_normal((rows, nq, h, d)).astype(np.float32)
    k = rs.standard_normal((rows, s, kv_heads, d)).astype(np.float32)
    v = rs.standard_normal((rows, s, kv_heads, d)).astype(np.float32)
    # each row's slots held by a random beam of its own prompt's group
    src = (np.arange(rows)[:, None] // kb * kb + rs.integers(0, kb, (rows, s))).astype(np.int32)
    k_pos = np.tile(np.arange(s, dtype=np.int32), (rows, 1))
    k_pos[:, 8:] = -1  # unwritten slots
    positions = np.full((rows, nq), 7, np.int32)
    want = jax_beam_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(positions), jnp.asarray(src), kb, window=window,
                              k_positions=jnp.asarray(k_pos))
    heads = lambda x: torch.from_numpy(x).permute(2, 0, 1, 3).contiguous()
    got = layers.beam_decode_attention(torch.from_numpy(q), heads(k), heads(v),
                                       torch.from_numpy(positions), torch.from_numpy(src), kb,
                                       window=window, k_positions=torch.from_numpy(k_pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    # the same as gathering each slot's K/V from its source row, then
    # attending plainly
    rows_idx = torch.from_numpy(src).long()
    gk = heads(k)[:, rows_idx, torch.arange(s)].contiguous()
    gv = heads(v)[:, rows_idx, torch.arange(s)].contiguous()
    plain = layers.decode_attention(torch.from_numpy(q), gk, gv, torch.from_numpy(positions),
                                    window=window, k_positions=torch.from_numpy(k_pos))
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-5, rtol=1e-5)


def test_top_k_tie_order_matches_jax():
    """Planted ties: the port's top-k returns the lower index first among
    equal values, as ``lax.top_k`` does."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    rs = np.random.default_rng(5)
    x = rs.integers(0, 4, (6, 40)).astype(np.float32)  # many equal values
    x[0] = 0.0  # one row all tied
    x[1, [3, 17, 30]] = 9.0  # three tied winners
    for k in (1, 4, 7):
        want_v, want_i = jax.lax.top_k(jnp.asarray(x), k)
        got_v, got_i = _top_k(torch.from_numpy(x), k)
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


@pytest.mark.parametrize("lazy", [True, False])
def test_generate_beam_all_tied_logits_matches_jax(bridged, lazy):
    """A zero lm_head makes every next token tie at every step: the beams,
    and so the tokens, follow the tie order, as JAX's do."""
    import jax
    import jax.numpy as jnp

    from tpu_parallel.models.generate import generate_beam as jax_generate_beam

    jm, params, model = bridged("gqa")
    params = jax.tree_util.tree_map_with_path(
        lambda p, x: jnp.zeros_like(x) if "lm_head" in jax.tree_util.keystr(p) else x, params)
    tied = GPTLM(model.config, device="cpu")
    tied.load_state_dict(model.state_dict())
    with torch.no_grad():
        tied.lm_head.weight.zero_()
    prompt = _prompt(3, (2, 4))
    want_toks, want_scores = jax_generate_beam(jm, params, jnp.asarray(prompt.numpy()),
                                               max_new_tokens=5, num_beams=4, lazy=lazy)
    toks, scores = generate_beam(tied, prompt, max_new_tokens=5, num_beams=4, lazy=lazy)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(want_toks))
    np.testing.assert_allclose(scores.numpy(), np.asarray(want_scores), rtol=1e-5, atol=1e-5)
    assert (toks == 0).all()  # beam 0 of the tied top-k (token 0) wins every step
