"""Port parity: the PyTorch GPT-2 forward against the JAX package's GPTLM.

A flax ``tiny_test`` init goes through ``params_from_jax`` into the port;
both run the same tokens (numpy, seeded).  fp32 on the CPU, tolerance
atol = rtol = 1e-4 (fp32 matmuls summed in another order through 4 layers).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_parallel.core.losses import token_cross_entropy as jax_ce
from tpu_parallel.models import gpt as jgpt
from tpu_parallel_torch.core.losses import token_cross_entropy
from tpu_parallel_torch.models import GPTLM, gpt2_125m, tiny_test
from tpu_parallel_torch.models.convert import params_from_jax
from tpu_parallel_torch.utils.profiling import transformer_flops_per_token
from tpu_parallel.utils.profiling import transformer_flops_per_token as jax_flops

TOL = dict(atol=1e-4, rtol=1e-4)
HEADS = {"mha": None, "gqa": 2}


def _jax_model(impl, heads, layout, **extra):
    cfg = jgpt.tiny_test(remat=False, attn_impl=impl, n_kv_heads=HEADS[heads],
                         scan_layers=layout == "scanned", **extra)
    return jgpt.GPTLM(cfg)


def _bridged(jax_model, params, **extra):
    cfg = tiny_test(attn_impl=jax_model.config.attn_impl,
                    n_kv_heads=jax_model.config.n_kv_heads, **extra)
    model = GPTLM(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), cfg))
    return model.eval()


def _tokens(seed, b=2, s=16, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, size=(b, s), dtype=np.int32)


@pytest.mark.parametrize("layout", ["scanned", "unrolled"])
@pytest.mark.parametrize("heads", sorted(HEADS))
@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_logits_and_loss_match_jax(impl, heads, layout):
    jm = _jax_model(impl, heads, layout)
    tokens = _tokens(1)
    params = jm.init(jax.random.PRNGKey(3), jnp.asarray(tokens), train=False)["params"]
    want = jm.apply({"params": params}, jnp.asarray(tokens), train=False)
    model = _bridged(jm, params)
    with torch.no_grad():
        got = model(torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    targets = np.roll(tokens, -1, axis=1)
    np.testing.assert_allclose(
        token_cross_entropy(got, torch.from_numpy(targets)).numpy(),
        np.asarray(jax_ce(want, jnp.asarray(targets))), **TOL,
    )


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_packed_window_forward_matches_jax(impl):
    """Segment ids, explicit positions and a sliding window together."""
    jm = _jax_model(impl, "gqa", "scanned", attn_window=6)
    tokens = _tokens(2)
    seg = np.repeat(np.array([[0] * 7 + [1] * 9]), 2, axis=0).astype(np.int32)
    pos = np.where(seg == 0, np.arange(16), np.arange(16) - 7).astype(np.int32)
    params = jm.init(jax.random.PRNGKey(4), jnp.asarray(tokens), train=False)["params"]
    want = jm.apply({"params": params}, jnp.asarray(tokens), positions=jnp.asarray(pos),
                    segment_ids=jnp.asarray(seg), train=False)
    model = _bridged(jm, params, attn_window=6)
    with torch.no_grad():
        got = model(torch.from_numpy(tokens), positions=torch.from_numpy(pos).long(),
                    segment_ids=torch.from_numpy(seg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_hidden_only_matches_jax():
    jm = _jax_model("xla", "mha", "unrolled")
    tokens = _tokens(5)
    params = jm.init(jax.random.PRNGKey(5), jnp.asarray(tokens), train=False)["params"]
    want = jm.apply({"params": params}, jnp.asarray(tokens), train=False, hidden_only=True)
    with torch.no_grad():
        got = _bridged(jm, params)(torch.from_numpy(tokens), hidden_only=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _tiny_tree():
    jm = _jax_model("xla", "mha", "unrolled")
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32), train=False)["params"]
    return jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("fault", ["missing", "extra", "shape"])
def test_bridge_rejects_mismatched_tree(fault):
    tree = _tiny_tree()
    if fault == "missing":
        del tree["blocks"]["layer_2"]["mlp"]["up"]["shard"]["bias"]
        err = KeyError
    elif fault == "extra":
        tree["blocks"]["layer_0"]["attn"]["rogue"] = {"kernel": np.zeros((2, 2))}
        err = ValueError
    else:
        tree["lm_head"]["shard"]["kernel"] = np.zeros((32, 255), np.float32)
        err = ValueError
    with pytest.raises(err):
        params_from_jax(tree, tiny_test())


def test_bridge_rejects_wrong_config():
    with pytest.raises(KeyError):
        params_from_jax(_tiny_tree(), tiny_test(n_kv_heads=2))


def test_seeded_init_is_deterministic_and_flax_like():
    a = GPTLM(tiny_test(), device="cpu", seed=7).state_dict()
    b = GPTLM(tiny_test(), device="cpu", seed=7).state_dict()
    c = GPTLM(tiny_test(), device="cpu", seed=8).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["lm_head.weight"], c["lm_head.weight"])
    assert torch.equal(a["norm_final.weight"], torch.ones(32))
    assert torch.equal(a["blocks.layer_0.attn.qkv.bias"], torch.zeros(96))
    w = GPTLM(tiny_test(d_model=256, n_heads=4), device="cpu").state_dict()
    # lecun-normal: std sqrt(1 / fan_in) after truncation at two std
    assert abs(w["blocks.layer_0.mlp.up.weight"].std().item() - 256 ** -0.5) < 0.1 * 256 ** -0.5


@pytest.mark.parametrize("field,value", [
    ("positional", "rope"), ("norm", "rmsnorm"), ("prenorm", False),
    ("kv_cache_dtype", "int8"), ("kv_block_tokens", 4), ("beam_width", 2),
    ("bidirectional", True), ("moe_experts", 4), ("mlp", "swiglu"),
    ("attn_impl", "ring"), ("pipe_size", 2),
])
def test_config_refuses_unported_features(field, value):
    with pytest.raises(NotImplementedError):
        tiny_test(**{field: value})


def test_configs_match_jax_fields():
    for port, ref in [(gpt2_125m(), jgpt.gpt2_125m()), (tiny_test(), jgpt.tiny_test())]:
        for name in ("vocab_size", "d_model", "n_layers", "n_heads", "seq_len", "head_dim"):
            assert getattr(port, name) == getattr(ref, name)
        assert transformer_flops_per_token(port) == jax_flops(ref)
    assert gpt2_125m().dtype == torch.bfloat16 and tiny_test().dtype == torch.float32
