"""Port parity for weight-only int8 quantization (``models/quantize.py``)
and the weight bridge's inverse (``convert.params_to_jax``).

The JAX package's ``tests/test_quantize.py`` cases re-run on the port, and
the cross-package contract: ``absmax_int8`` payloads and scales equal to
JAX's on the same arrays (all-zero groups and planted .5 boundaries
included), a ``.npz`` written by either package loads and dequantizes in
the other, and ``params_to_jax`` inverts ``params_from_jax`` bitwise on a
scanned and an unrolled tree.  ``tiny_test`` in fp32 on the CPU, arrays
from numpy seeds; JAX is imported inside fixtures.
"""

import numpy as np
import pytest
import torch

from tpu_parallel_torch.models import GPTLM, tiny_test
from tpu_parallel_torch.models.convert import params_from_jax, params_to_jax
from tpu_parallel_torch.models.generate import generate
from tpu_parallel_torch.models.quantize import (
    QuantizedTensor,
    absmax_int8,
    dequantize_params,
    load_int8_npz,
    quantize_params,
    quantized_nbytes,
    save_int8_npz,
)

# one torch intra-op thread per test process: under pytest-xdist several
# processes share the cores, and torch's default (a thread per core in each)
# oversubscribes them
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jq():
    """The JAX package's quantize module."""
    pytest.importorskip("jax")
    from tpu_parallel.models import quantize

    return quantize


def _normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


# -- the JAX package's cases, on the port ----------------------------------------------


def test_quantize_roundtrip_error_bounded():
    w = torch.from_numpy(_normal(0, (64, 128), 3.0))
    q = quantize_params({"kernel": w}, min_size=1)["kernel"]
    assert isinstance(q, QuantizedTensor) and q.q.dtype == torch.int8
    back = q.dequantize(torch.float32).numpy()
    # per-channel scale bounds the error at scale/2 = max|w_col| / 254
    col_max = np.abs(w.numpy()).max(axis=0)
    assert (np.abs(back - w.numpy()) <= col_max / 254 + 1e-6).all()


def test_small_and_integer_leaves_pass_through():
    tree = {
        "bias": torch.ones(8),  # too small / 1-D
        "ids": torch.arange(10_000),  # integer
        "kernel": torch.from_numpy(_normal(1, (128, 128))),
    }
    q = quantize_params(tree)
    assert q["bias"] is tree["bias"]
    assert q["ids"] is tree["ids"]
    assert isinstance(q["kernel"], QuantizedTensor)


@pytest.mark.parametrize("kv_heads", [None, 2])
def test_quantized_model_generates_close(kv_heads):
    """Dequantized int8 weights give logits close to the originals and
    compress the (fp32, scanned) tree about 4x; generate() runs on them."""
    cfg = tiny_test(n_kv_heads=kv_heads)
    model = GPTLM(cfg, device="cpu", seed=1)
    prompt = torch.from_numpy(np.random.default_rng(2).integers(0, 256, (2, 5))).long()
    params = params_to_jax(model.state_dict(), cfg)
    qparams = quantize_params(params)
    assert quantized_nbytes(qparams) < 0.35 * quantized_nbytes(params)
    restored = GPTLM(cfg, device="cpu")
    restored.load_state_dict(params_from_jax(dequantize_params(qparams, torch.float32), cfg))
    with torch.no_grad():
        np.testing.assert_allclose(restored(prompt).numpy(), model(prompt).numpy(),
                                   rtol=0.3, atol=0.3)
    assert generate(restored, prompt, max_new_tokens=4).shape == (2, 4)


def test_int8_npz_roundtrip(tmp_path):
    """save_int8_npz -> load_int8_npz -> dequantize reproduces the dense
    tree within quantization error."""
    tree = {
        "a": {"kernel": torch.from_numpy(_normal(3, (64, 128))), "bias": torch.ones(8)},
        "b": {"kernel": torch.from_numpy(_normal(4, (128, 64)))},
    }
    q = quantize_params(tree, min_size=1024)
    path = str(tmp_path / "p.npz")
    save_int8_npz(path, q)
    back = dequantize_params(load_int8_npz(path), torch.float32)
    for name in ("a", "b"):
        want = tree[name]["kernel"].numpy()
        np.testing.assert_allclose(back[name]["kernel"].numpy(), want,
                                   atol=float(np.abs(want).max()) / 100)
    np.testing.assert_array_equal(back["a"]["bias"].numpy(), np.ones(8))


# -- against the JAX package ----------------------------------------------------------


def _planted_halves():
    """[6, 16] fp32: each row's max |x| is 127 (scale exactly 1), the rest
    exact .5 boundaries (round half to even), plus an all-zero row."""
    x = np.zeros((6, 16), np.float32)
    halves = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5], np.float32)
    for r in range(5):
        x[r, 0] = 127.0 if r % 2 else -127.0
        x[r, 1:9] = np.roll(halves, r)
        x[r, 9:] = np.round(_normal(10 + r, 7, 40.0)) + 0.5
    return x


ARRAYS = {
    "normal": lambda: _normal(5, (8, 12, 64), 2.0),
    "zero_groups": lambda: _normal(6, (8, 12, 64)) * (np.arange(12) % 3 != 0)[None, :, None],
    "planted_halves": _planted_halves,
    "tiny_values": lambda: _normal(7, (4, 32), 1e-30),
}


@pytest.mark.parametrize("axis", [-1, 0])
@pytest.mark.parametrize("name", sorted(ARRAYS))
def test_absmax_int8_matches_jax(jq, name, axis):
    import jax.numpy as jnp

    x = ARRAYS[name]().astype(np.float32)
    want_q, want_s = jq.absmax_int8(jnp.asarray(x), axis=axis)
    got_q, got_s = absmax_int8(torch.from_numpy(x), axis=axis)
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    if name == "planted_halves" and axis == -1:
        # half to even: 0.5 -> 0, 1.5 -> 2, 2.5 -> 2, 126.5 -> 126
        assert got_q[0, 1:9].tolist() == [0, 2, 2, 0, -2, -2, 126, -126]
        assert (got_q[5] == 0).all() and got_s[5, 0] == 0.0


def test_absmax_int8_bf16_matches_jax(jq):
    import jax.numpy as jnp

    x = _normal(8, (4, 6, 64), 3.0)
    want_q, want_s = jq.absmax_int8(jnp.asarray(x, jnp.bfloat16), axis=-1)
    got_q, got_s = absmax_int8(torch.from_numpy(x).to(torch.bfloat16), axis=-1)
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


@pytest.fixture(scope="module")
def jax_trees():
    """layout -> (flax GPTLM param tree as numpy, port tiny_test config)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from tpu_parallel.models import GPTLM as JaxGPTLM
    from tpu_parallel.models import tiny_test as jax_tiny_test

    out = {}
    for layout in ("scanned", "unrolled"):
        kw = dict(scan_layers=layout == "scanned", n_kv_heads=2 if layout == "unrolled" else None)
        jm = JaxGPTLM(jax_tiny_test(dtype=jnp.float32, remat=False, **kw))
        params = jm.init({"params": jax.random.PRNGKey(3)}, jnp.zeros((1, 5), jnp.int32),
                         train=False)["params"]
        out[layout] = (jax.tree.map(np.asarray, params), tiny_test(**kw))
    return out


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("layout", ["scanned", "unrolled"])
def test_params_to_jax_inverts_params_from_jax(jax_trees, layout):
    tree, cfg = jax_trees[layout]
    state = params_from_jax(tree, cfg)
    back = dict(_flat(params_to_jax(state, cfg)))
    want = dict(_flat(tree))
    assert sorted(back) == sorted(want)
    for path, leaf in want.items():
        assert back[path].dtype == torch.float32
        np.testing.assert_array_equal(back[path].numpy(), leaf, err_msg=path)
    again = params_from_jax(params_to_jax(state, cfg), cfg)
    assert all(torch.equal(again[k], state[k]) for k in state)


@pytest.mark.parametrize("layout", ["scanned", "unrolled"])
def test_quantize_params_matches_jax(jq, jax_trees, layout):
    """The port's quantize_params on params_to_jax of the bridged state
    dict equals JAX's on the flax tree: the same leaves quantize, with
    equal payloads and scales."""
    import jax.numpy as jnp

    tree, cfg = jax_trees[layout]
    want = dict(_flat(jq.quantize_params({k: v for k, v in _jnp_tree(tree, jnp).items()})))
    got = dict(_flat(quantize_params(params_to_jax(params_from_jax(tree, cfg), cfg))))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        g = got[path]
        if isinstance(w, jq.QuantizedTensor):
            assert isinstance(g, QuantizedTensor), path
            np.testing.assert_array_equal(g.q.numpy(), np.asarray(w.q), err_msg=path)
            np.testing.assert_array_equal(g.scale.numpy(), np.asarray(w.scale), err_msg=path)
        else:
            assert not isinstance(g, QuantizedTensor), path
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=path)


def _jnp_tree(tree, jnp):
    return {k: _jnp_tree(v, jnp) if isinstance(v, dict) else jnp.asarray(v)
            for k, v in tree.items()}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_int8_npz_crosses_packages(jq, jax_trees, tmp_path, writer):
    """A .npz written by one package loads and dequantizes in the other to
    the same values, and the dequantized tree feeds the port's GPTLM."""
    import jax.numpy as jnp

    tree, cfg = jax_trees["scanned"]
    path = str(tmp_path / f"{writer}.npz")
    if writer == "jax":
        jq.save_int8_npz(path, jq.quantize_params(_jnp_tree(tree, jnp)))
        got = dequantize_params(load_int8_npz(path), torch.float32)
        want = jq.dequantize_params(jq.quantize_params(_jnp_tree(tree, jnp)), jnp.float32)
    else:
        save_int8_npz(path, quantize_params(params_to_jax(params_from_jax(tree, cfg), cfg)))
        got = jq.dequantize_params(jq.load_int8_npz(path), jnp.float32)
        want = dequantize_params(
            quantize_params(params_to_jax(params_from_jax(tree, cfg), cfg)), torch.float32)
    got, want = dict(_flat(got)), dict(_flat(want))
    assert sorted(got) == sorted(want) == sorted(dict(_flat(tree)))
    for path_, leaf in want.items():
        np.testing.assert_array_equal(np.asarray(got[path_]), np.asarray(leaf), err_msg=path_)
    model = GPTLM(cfg, device="cpu")
    model.load_state_dict(params_from_jax({k: v for k, v in _unflat(got).items()}, cfg))
    with torch.no_grad():
        assert torch.isfinite(model(torch.zeros(1, 4, dtype=torch.long))).all()


def _unflat(flat):
    tree = {}
    for path, leaf in flat.items():
        node = tree
        *parents, name = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = leaf
    return tree
