"""Port parity: the PyTorch flash-attention forward against the JAX package.

The JAX side runs its Pallas kernels in interpret mode on the CPU; the port
runs its plain version (the CPU path of the wrapper).  Inputs are fp32,
made with numpy from a seed.  Tolerance: atol = rtol = 1e-5 (fp32 sums in
another order and block split).
"""

import importlib
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

# the package re-exports a function of the same name: import the module itself
jfa = importlib.import_module("tpu_parallel.ops.flash_attention")
tfa = importlib.import_module("tpu_parallel_torch.ops.flash_attention")

TOL = dict(atol=1e-5, rtol=1e-5)


def _segments(rng, b, s):
    """Monotone segment ids, three segments of random lengths per row."""
    cuts = np.sort(rng.integers(1, s - 1, size=(b, 2)), axis=1)
    pos = np.arange(s)[None, :]
    return ((pos >= cuts[:, :1]).astype(np.int32) + (pos >= cuts[:, 1:]).astype(np.int32))


def _bhsd_inputs(seed, b, h, h_kv, s, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, s, d), dtype=np.float32)
    k = rng.standard_normal((b, h_kv, s, d), dtype=np.float32)
    v = rng.standard_normal((b, h_kv, s, d), dtype=np.float32)
    return q, k, v, _segments(rng, b, s)


# name: (heads, kv heads, seq, kernel kwargs, packed segments, JAX stream)
CASES = {
    "mha": (2, 2, 128, dict(), False, None),
    "gqa": (4, 2, 128, dict(), False, None),
    "mqa": (4, 1, 128, dict(), False, None),
    "gqa_streamed": (4, 2, 128, dict(), False, True),
    "window": (2, 2, 192, dict(window=48), False, None),
    "segments": (2, 2, 128, dict(), True, None),
    "gqa_window_segments": (4, 2, 192, dict(window=80), True, None),
    "chunk_full": (2, 2, 128, dict(causal=False), False, None),
    "chunk_offset_ahead": (2, 2, 192, dict(causal=False, q_offset=64, window=80), False, None),
    "chunk_offset_behind": (2, 2, 192, dict(causal=False, q_offset=-64, window=80), False, None),
    "chunk_empty_rows": (2, 1, 256, dict(causal=False, q_offset=-100, window=64), False, None),
    "chunk_segments": (2, 2, 128, dict(causal=False), True, True),
}


def _assert_matches_jax(out_t, lse_t, out_j, lse_j):
    """``out``/``lse`` of the port against the JAX kernel's.  Rows with no
    visible key: both give lse NEG_INF; the port gives out = 0 (its
    contract), while the JAX kernel can leave the mean of the masked V there
    when the row shares a tile with visible rows (its lse weights it out)."""
    out_t, lse_t = out_t.numpy(), lse_t.numpy()
    out_j, lse_j = np.asarray(out_j), np.asarray(lse_j)
    np.testing.assert_allclose(lse_t, lse_j, **TOL)
    empty = lse_j <= tfa.NEG_INF / 2
    np.testing.assert_array_equal(out_t[empty], 0.0)
    np.testing.assert_allclose(out_t[~empty], out_j[~empty], **TOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_fwd_matches_jax_kernel(case):
    h, h_kv, s, kw, packed, stream = CASES[case]
    q, k, v, seg = _bhsd_inputs(len(case), 2, h, h_kv, s, 32)
    seg_j = jnp.asarray(seg)[:, :, None] if packed else None
    out_j, lse_j = jfa._flash_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), seg_j, seg_j,
        block_q=64, block_k=64, interpret=True, stream=stream, **kw,
    )
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    tseg = torch.from_numpy(seg) if packed else None
    out_r, lse_r = tfa.flash_fwd_reference(tq, tk, tv, tseg, tseg, **kw)
    _assert_matches_jax(out_r, lse_r, out_j, lse_j)
    out_w, lse_w = tfa._flash_fwd(tq, tk, tv, tseg, tseg, stream=stream, **kw)
    _assert_matches_jax(out_w, lse_w, out_j, lse_j)
    if "empty" in case:
        assert (lse_r.numpy() <= tfa.NEG_INF / 2).any()


@pytest.mark.parametrize("case", ["plain", "gqa_window", "segments"])
def test_ragged_seq_matches_jax_fallback(case):
    """S = 100 does not tile: the JAX wrapper falls back to its O(S^2)
    reference; the port's kernel masks the ragged edge instead."""
    h_kv, window, packed = dict(plain=(2, 0, False), gqa_window=(1, 24, False),
                                segments=(2, 0, True))[case]
    q, k, v, seg = _bhsd_inputs(7, 2, 2, h_kv, 100, 32)
    q, k, v = (x.transpose(0, 2, 1, 3) for x in (q, k, v))  # [B, S, H, D]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        want = jfa.flash_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            segment_ids=jnp.asarray(seg) if packed else None,
            block_q=64, block_k=64, window=window, interpret=True,
        )
    assert any("falling back" in str(w.message) for w in caught)
    got = tfa.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        segment_ids=torch.from_numpy(seg) if packed else None, window=window,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_flash_attention_matches_jax_bshd():
    """The public [B, S, H, D] wrapper, GQA, against the JAX kernel path."""
    q, k, v, _ = _bhsd_inputs(3, 2, 4, 2, 128, 32)
    q, k, v = (x.transpose(0, 2, 1, 3) for x in (q, k, v))
    want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               block_q=64, block_k=64, interpret=True)
    got = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_reference_attention_matches_jax():
    q, k, v, seg = _bhsd_inputs(5, 2, 2, 2, 64, 16)
    want = jfa.reference_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   jnp.asarray(seg))
    got = tfa.reference_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), torch.from_numpy(seg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [0, 40, 200])
@pytest.mark.parametrize("q_offset", [0, 64, -64, 300])
def test_band_geometry_matches_jax(causal, window, q_offset):
    """_band_mask, _stream_k_range and _window_first_k_block over a grid of
    tiles, rectangular tiles included."""
    for block_q, block_k in [(32, 32), (64, 32), (32, 64)]:
        num_ki = 256 // block_k
        for qi in range(256 // block_q):
            first_t, last_t = tfa._stream_k_range(
                qi, block_q, block_k, causal, window, num_ki, q_offset
            )
            first_j, last_j = jfa._stream_k_range(
                qi, block_q, block_k, causal, window, num_ki, q_offset
            )
            assert (first_t, last_t) == (int(first_j), int(last_j))
            if window:
                assert tfa._window_first_k_block(qi, block_q, block_k, window, q_offset) == int(
                    jfa._window_first_k_block(qi, block_q, block_k, window, q_offset)
                )
            for ki in range(num_ki):
                shape = (block_q, block_k)
                m_t = tfa._band_mask(qi, ki, shape, block_q, block_k, causal, window, q_offset)
                m_j = jfa._band_mask(qi, ki, shape, block_q, block_k, causal, window, q_offset)
                if m_j is None:
                    assert m_t is None
                else:
                    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))


@pytest.mark.parametrize("h,h_kv", [(4, 4), (4, 2), (8, 1), (6, 3)])
def test_kv_row_map_matches_jax(h, h_kv):
    t_map, j_map = tfa._kv_row_map(h, h_kv), jfa._kv_row_map(h, h_kv)
    assert [t_map(bh) for bh in range(3 * h)] == [int(j_map(bh)) for bh in range(3 * h)]


def test_wrapper_rejects_bad_arguments():
    q = torch.zeros(1, 4, 64, 32)
    kv = torch.zeros(1, 3, 64, 32)
    with pytest.raises(ValueError, match="multiple"):
        tfa._flash_fwd(q, kv, kv)
    k = torch.zeros(1, 2, 64, 32)
    with pytest.raises(ValueError, match="q_offset"):
        tfa._flash_fwd(q, k, k, causal=True, q_offset=8)
    with pytest.raises(ValueError, match="window"):
        tfa._flash_fwd(q, k, k, window=-1)
    seg = torch.zeros(1, 64, dtype=torch.int32)
    with pytest.raises(ValueError, match="together"):
        tfa._flash_fwd(q, k, k, seg, None)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tfa._flash_fwd(q.to("meta"), k.to("meta"), k.to("meta"))
