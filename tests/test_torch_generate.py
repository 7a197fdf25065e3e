"""Port parity: KV-cache generation against ``tpu_parallel.models.generate``.

``tiny_test`` in fp32 on the CPU, weights bridged from a flax init.  Greedy
tokens must match exactly; cache K/V and positions within atol = rtol =
1e-4.  Sampling is checked by its filters only: a ``torch.Generator`` does
not give JAX's random bits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_parallel.models import gpt as jgpt
from tpu_parallel.models import generate as jgen
from tpu_parallel_torch.models import GPTLM, tiny_test
from tpu_parallel_torch.models import generate as tgen
from tpu_parallel_torch.models.convert import params_from_jax

# one torch intra-op thread per test process: under pytest-xdist several
# processes share the cores, and torch's default (a thread per core in each)
# oversubscribes them
torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)
VARIANTS = {
    "aligned": dict(),
    "gqa": dict(n_kv_heads=2),
    "window": dict(attn_window=6),
    "unrolled": dict(scan_layers=False),
}


def _pair(seed=1, **overrides):
    port_overrides = {k: v for k, v in overrides.items() if k != "scan_layers"}
    jm = jgpt.GPTLM(jgpt.tiny_test(remat=False, **overrides))
    params = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32), train=False)["params"]
    cfg = tiny_test(**port_overrides)
    model = GPTLM(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), cfg))
    return jm, params, model.eval()


def _prompt(seed, b=3, p=7):
    return np.random.default_rng(seed).integers(0, 256, size=(b, p), dtype=np.int32)


def _ragged_mask(b=3, p=7):
    mask = np.ones((b, p), bool)
    mask[1, :3] = False
    mask[2, :5] = False
    return mask


def _explain_mismatch(jm, params, prompt, got, want):
    """Top-2 logit gap of the JAX model where the first token differs: a
    near tie is rounding, a wide gap is a fault."""
    row, step = map(int, np.argwhere(got != want)[0])
    toks = np.concatenate([prompt[row], want[row, :step]])[None]
    logits = np.asarray(jm.apply({"params": params}, jnp.asarray(toks), train=False))[0, -1]
    top2 = np.sort(logits)[-2:]
    return f"row {row} step {step}: top-2 logit gap {top2[1] - top2[0]:.3g}"


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_greedy_generate_matches_jax(variant, ragged):
    jm, params, model = _pair(**VARIANTS[variant])
    prompt = _prompt(2)
    mask = _ragged_mask() if ragged else None
    want = np.asarray(jgen.generate(
        jm, params, jnp.asarray(prompt), max_new_tokens=10,
        prompt_mask=None if mask is None else jnp.asarray(mask),
    ))
    got = tgen.generate(
        model, torch.from_numpy(prompt).long(), max_new_tokens=10,
        prompt_mask=None if mask is None else torch.from_numpy(mask),
    ).numpy()
    assert got.shape == (3, 10)
    if not np.array_equal(got, want):
        pytest.fail(_explain_mismatch(jm, params, prompt, got, want))


def _jax_layer_cache(cache, i, scanned):
    if scanned:
        return jax.tree.map(lambda x: x[i], cache["blocks"]["layers"]["block"]["attn"])
    return cache["blocks"][f"layer_{i}"]["attn"]


@pytest.mark.parametrize("scanned", [True, False])
def test_prefill_and_decode_cache_match_jax(scanned):
    """Right-padded bucket prefill, then one decode step: K/V at every
    written slot, the position table and the write index agree."""
    jm, params, model = _pair(scan_layers=scanned, n_kv_heads=2)
    tokens = _prompt(3, b=2, p=8)
    lengths = [5, 8]
    pos_j, last_j = jgen.padded_prefill_inputs(lengths, 8)
    pos_t, last_t = tgen.padded_prefill_inputs(lengths, 8)
    np.testing.assert_array_equal(pos_t.numpy(), np.asarray(pos_j))
    np.testing.assert_array_equal(last_t.numpy(), np.asarray(last_j))
    hid_j, cache_j = jgen.prefill_step(jm, params, jnp.asarray(tokens), pos_j)
    with torch.no_grad():
        hid_t, cache_t = tgen.prefill_step(model, torch.from_numpy(tokens).long(), pos_t)
    real = np.asarray(pos_j) >= 0
    np.testing.assert_allclose(hid_t.numpy()[real], np.asarray(hid_j)[real], **TOL)

    tok = np.array([11, 12], np.int32)
    step_pos = np.array(lengths, np.int32)
    hid_j, cache_j = jgen.decode_step(jm, params, cache_j, jnp.asarray(tok), jnp.asarray(step_pos))
    with torch.no_grad():
        hid_t, cache_t = tgen.decode_step(model, cache_t, torch.from_numpy(tok).long(),
                                          torch.from_numpy(step_pos).long())
    np.testing.assert_allclose(hid_t.numpy(), np.asarray(hid_j), **TOL)
    for i, layer in enumerate(cache_t):
        ref = _jax_layer_cache(cache_j, i, scanned)
        stored = np.asarray(ref["cached_pos"])
        np.testing.assert_array_equal(layer.pos.numpy(), stored)
        assert layer.index == int(ref["cache_index"]) == 9
        written = stored >= 0  # pad slots hold garbage K/V on both sides
        for name, mine in (("cached_key", layer.key), ("cached_value", layer.value)):
            np.testing.assert_allclose(mine.numpy()[written], np.asarray(ref[name])[written], **TOL)


def _logits(seed=0, b=4, vocab=64):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal((b, vocab)).astype(np.float32))


@pytest.mark.parametrize("kw", [dict(top_k=1), dict(top_p=1e-6), dict(top_k=3, top_p=1e-6)])
def test_sampling_filters_collapse_to_greedy(kw):
    logits = _logits()
    gen = torch.Generator().manual_seed(0)
    for _ in range(5):
        got = tgen._sample(logits, gen, 1.3, kw.get("top_k", 0), kw.get("top_p", 0.0))
        assert torch.equal(got, logits.argmax(-1))


def test_top_k_samples_stay_in_top_k_set():
    logits = _logits(1)
    allowed = [set(row) for row in logits.topk(5, dim=-1).indices.tolist()]
    gen = torch.Generator().manual_seed(1)
    seen = [set() for _ in allowed]
    for _ in range(200):
        for r, t in enumerate(tgen._sample(logits, gen, 1.0, 5).tolist()):
            assert t in allowed[r]
            seen[r].add(t)
    assert all(len(s) > 1 for s in seen)


def test_top_p_keeps_the_nucleus_only():
    """Logits with a known nucleus: p = 0.5 over masses [.4, .3, .2, .1]
    keeps exactly the first two tokens."""
    logits = torch.log(torch.tensor([[0.4, 0.3, 0.2, 0.1]]))
    gen = torch.Generator().manual_seed(2)
    drawn = {int(tgen._sample(logits, gen, 1.0, 0, 0.5)) for _ in range(200)}
    assert drawn == {0, 1}


def test_sampled_generate_is_seeded():
    _, _, model = _pair()
    prompt = torch.from_numpy(_prompt(4)).long()
    runs = [
        tgen.generate(model, prompt, torch.Generator().manual_seed(s), max_new_tokens=6,
                      temperature=1.0, top_p=0.9)
        for s in (5, 5, 6)
    ]
    assert torch.equal(runs[0], runs[1]) and runs[0].shape == (3, 6)
    assert int(runs[0].min()) >= 0 and int(runs[0].max()) < 256


def test_generate_rejects_overflow_and_device_mismatch():
    _, _, model = _pair()
    with pytest.raises(ValueError, match="exceeds seq_len"):
        tgen.generate(model, torch.zeros(1, 30, dtype=torch.long), max_new_tokens=8)
    with pytest.raises(ValueError, match="is on"):
        tgen.generate(model, torch.zeros(1, 4, dtype=torch.long, device="meta"))


def test_decode_default_positions_match_jax():
    """decode=True without positions continues from the cache's write index,
    as the JAX model's step counter does: prefill then one step."""
    jm, params, model = _pair()
    tokens, nxt = _prompt(6, b=2, p=5), np.array([[3], [4]], np.int32)
    want1, state = jm.apply({"params": params}, jnp.asarray(tokens), train=False,
                            decode=True, mutable=["cache"])
    want2, _ = jm.apply({"params": params, "cache": state["cache"]}, jnp.asarray(nxt),
                        train=False, decode=True, mutable=["cache"])
    cache = model.init_cache(2)
    with torch.no_grad():
        got1 = model(torch.from_numpy(tokens).long(), decode=True, cache=cache)
        got2 = model(torch.from_numpy(nxt).long(), decode=True, cache=cache)
    np.testing.assert_allclose(got1.numpy(), np.asarray(want1), **TOL)
    np.testing.assert_allclose(got2.numpy(), np.asarray(want2), **TOL)


def test_model_refuses_unported_cache_modes_and_overlong_input():
    _, _, model = _pair()
    tokens = torch.zeros(1, 4, dtype=torch.long)
    cache = model.init_cache(1)
    with pytest.raises(ValueError, match="block_table needs the paged KV cache"):
        model(tokens, decode=True, cache=cache, write_index=torch.zeros(1, dtype=torch.long),
              block_table=torch.zeros(1, 4, dtype=torch.long))
    with pytest.raises(ValueError, match="needs a cache"):
        model(tokens, decode=True)
    with pytest.raises(ValueError, match="exceed seq_len"):
        model(torch.zeros(1, 33, dtype=torch.long))
