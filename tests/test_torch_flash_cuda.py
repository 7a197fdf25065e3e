"""The port's CUDA flash-attention kernels (forward; backward for dq, dk and
dv in one pass) against their plain versions, on the card.  Marked ``gpu``; every test skips without a CUDA device.  Imports no
JAX, so on the card's machine it runs without the repo's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_flash_cuda.py

Tolerance: out atol = rtol = 2e-2 (P is rounded to bf16 before P.V and sums
run in another order), lse atol 1e-3 (fp32 throughout).  Gradients, row by
row (one query's dq, one key's dk or dv): ||got - plain|| <= 2e-2 * ||plain
row|| + 1e-3 * (rms row norm of the tensor).  bf16 outputs carry a relative
rounding of up to 2^-9 on each element, ds and p are rounded to bf16 before
their products and thousands of terms are summed in another order: a few
1e-3 of a row's norm.  The 1e-3 term covers rows that are rounding noise in
both, such as the dq of a query that sees a single key.  dq is summed across
key blocks with fp32 atomics, whose order changes from run to run, so two
runs' dq are held to the same row rule; dk and dv have one writer per row
and must be bitwise equal.

The kernels address their bf16 operands by row: the model hands them views
of its fused projections ([B, S, H, D] in memory) and they write out, dq,
dk, dv in that order; the same values in [B, H, S, D] give bitwise the same
forward.
"""

import importlib

import pytest
import torch

tfa = importlib.import_module("tpu_parallel_torch.ops.flash_attention")

pytestmark = pytest.mark.gpu

# name: (B, H, H_KV, S, D, kwargs) — shapes (a), (b) and (e) of the card check
SHAPES = {
    "a_gpt2_main_path": (8, 12, 12, 1024, 64, dict(causal=True)),
    "b_gqa_d128": (2, 16, 4, 2048, 128, dict(causal=True)),
    "e_chunk_ahead": (2, 4, 4, 1024, 64, dict(causal=False, q_offset=512, window=640)),
    "e_chunk_behind_empty_rows": (2, 4, 4, 1024, 64, dict(causal=False, q_offset=-512, window=640)),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_kernel_matches_plain_version(cuda, name):
    b, h, h_kv, s, d, kw = SHAPES[name]
    gen = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn(b, h, s, d, device=cuda, generator=gen).to(torch.bfloat16)
    k = torch.randn(b, h_kv, s, d, device=cuda, generator=gen).to(torch.bfloat16)
    v = torch.randn(b, h_kv, s, d, device=cuda, generator=gen).to(torch.bfloat16)
    before = tfa.flash_fwd_launches
    with torch.inference_mode():
        out, lse = tfa._flash_fwd(q, k, v, **kw)
        want_out, want_lse = tfa.flash_fwd_reference(q, k, v, **kw)
    torch.cuda.synchronize()
    assert tfa.flash_fwd_launches == before + 1
    torch.testing.assert_close(out.float(), want_out.float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(lse, want_lse, atol=1e-3, rtol=0)


def test_kernel_refuses_what_it_cannot_take(cuda):
    q = torch.zeros(1, 2, 64, 64, device=cuda)
    with pytest.raises(TypeError, match="bf16"):
        tfa._flash_fwd(q, q, q)
    q16 = torch.zeros(1, 2, 64, 32, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        tfa._flash_fwd(q16, q16, q16)
    with pytest.raises(TypeError, match="bf16"):
        tfa._flash_bwd(q, q, q, None, None, q, q[..., 0], q)


def _grad_inputs(cuda, b, h, h_kv, s, d, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn(b, h, s, d, device=cuda, generator=gen).to(torch.bfloat16)
    k = torch.randn(b, h_kv, s, d, device=cuda, generator=gen).to(torch.bfloat16)
    v = torch.randn(b, h_kv, s, d, device=cuda, generator=gen).to(torch.bfloat16)
    do = torch.randn(b, h, s, d, device=cuda, generator=gen).to(torch.bfloat16)
    return q, k, v, do


def _worst_row_ratio(got, want):
    """Largest row L2 error over its limit 2e-2 * ||row|| + 1e-3 * rms row norm."""
    g, w = got.float().flatten(0, -2), want.float().flatten(0, -2)
    ref = w.norm(dim=-1)
    limit = 2e-2 * ref + 1e-3 * ref.square().mean().sqrt()
    return ((g - w).norm(dim=-1) / limit.clamp(min=1e-30)).max().item()


def _assert_grads_close(got, want):
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        ratio = _worst_row_ratio(g, w)
        assert ratio <= 1, (name, ratio)


# name: (B, H, H_KV, S, D, kwargs) — gradient shapes of the card check
GRAD_SHAPES = {
    "a_gpt2_train_pass": (4, 12, 12, 1024, 64, dict(causal=True)),
    "b_gqa_d128": (1, 16, 4, 1024, 128, dict(causal=True)),
    "c_window": (2, 4, 4, 1000, 64, dict(causal=True, window=256)),
    "e_chunk_ahead": (2, 4, 4, 1024, 64, dict(causal=False, q_offset=512, window=384)),
    "e_chunk_behind_empty_rows": (2, 4, 4, 1024, 64, dict(causal=False, q_offset=-512, window=384)),
}


@pytest.mark.parametrize("name", sorted(GRAD_SHAPES))
def test_backward_kernels_match_plain_version(cuda, name):
    b, h, h_kv, s, d, kw = GRAD_SHAPES[name]
    q, k, v, do = _grad_inputs(cuda, b, h, h_kv, s, d)
    with torch.inference_mode():
        out, lse = tfa._flash_fwd(q, k, v, **kw)
        before = tfa.flash_bwd_launches
        got = tfa._flash_bwd(q, k, v, None, None, out, lse, do, **kw)
        want = tfa.flash_bwd_reference(q, k, v, None, None, out, lse, do, **kw)
    torch.cuda.synchronize()
    assert tfa.flash_bwd_launches == before + 1
    _assert_grads_close(got, want)
    empty = lse <= tfa.NEG_INF / 2
    if "empty" in name:
        assert empty.any()
        assert (got[0][empty] == 0).all()


def test_packed_backward_and_dlse(cuda):
    """Packed segments, GQA and a nonzero lse cotangent together."""
    q, k, v, do = _grad_inputs(cuda, 2, 8, 2, 512, 64, seed=1)
    pos = torch.arange(512, device=cuda)
    seg = ((pos >= 100).int() + (pos >= 333).int()).expand(2, 512).contiguous()
    dlse = torch.randn(2, 8, 512, device=cuda, generator=torch.Generator(device=cuda).manual_seed(2))
    with torch.inference_mode():
        out, lse = tfa._flash_fwd(q, k, v, seg, seg)
        got = tfa._flash_bwd(q, k, v, seg, seg, out, lse, do, dlse=dlse)
        want = tfa.flash_bwd_reference(q, k, v, seg, seg, out, lse, do, dlse=dlse)
    _assert_grads_close(got, want)


@pytest.mark.parametrize("h_kv", [4, 2])
def test_flash_attention_gradients_use_two_launches(cuda, h_kv):
    """Forward and backward: one launch each per fwd+bwd, gradients within
    tolerance of the plain backward on the forward kernel's out and lse."""
    q, k, v, do = _grad_inputs(cuda, 2, 4, h_kv, 256, 64, seed=3)
    leaves = [x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v)]
    counts = (tfa.flash_fwd_launches, tfa.flash_bwd_launches)
    out = tfa.flash_attention(*leaves)
    out.backward(do.transpose(1, 2))
    assert (tfa.flash_fwd_launches, tfa.flash_bwd_launches) == tuple(c + 1 for c in counts)
    with torch.inference_mode():
        o, lse = tfa._flash_fwd(q, k, v)
        want = tfa.flash_bwd_reference(q, k, v, None, None, o, lse, do)
    _assert_grads_close([x.grad.transpose(1, 2) for x in leaves], want)


def test_gradient_check_rejects_dropped_work(cuda):
    """The row check catches kernels that drop part of their work: dq without
    the last 64 keys, dk/dv without the last 64 queries, and dk/dv without
    the keys of the second half (small rows under a causal mask).  The
    faults are made with the real kernel by hiding keys or queries through
    the segment ids while lse stays that of the whole input."""
    b, h, s, d = 2, 4, 1024, 64
    q, k, v, do = _grad_inputs(cuda, b, h, h, s, d, seed=4)
    none = torch.zeros(b, s, dtype=torch.int32, device=cuda)
    last_tile, second_half = none.clone(), none.clone()
    last_tile[:, -64:] = 1
    second_half[:, s // 2:] = 1
    with torch.inference_mode():
        out, lse = tfa._flash_fwd(q, k, v)
        want = tfa.flash_bwd_reference(q, k, v, None, None, out, lse, do)
        bwd = torch.ops.tpu_parallel_torch.flash_bwd
        faults = {
            "dq": bwd(q, k, v, out, do, lse, None, none, last_tile, True, 0, 0)[:1],
            "dkv_tile": bwd(q, k, v, out, do, lse, None, last_tile, none, True, 0, 0)[1:],
            "dkv_half": bwd(q, k, v, out, do, lse, None, none, second_half, True, 0, 0)[1:],
        }
    for name, got in faults.items():
        for g, w in zip(got, want if name == "dq" else want[1:]):
            assert _worst_row_ratio(g, w) > 1, name


def test_backward_is_reproducible(cuda):
    """Two runs on the same inputs, GQA 8/2 at D=128 with empty rows (a chunk
    behind its keys): dk and dv bitwise equal, dq within the row rule of the
    first run's (atomics reorder its fp32 sums) and exactly 0 on the empty
    rows in both."""
    kw = dict(causal=False, q_offset=-512, window=384)
    q, k, v, do = _grad_inputs(cuda, 1, 8, 2, 1024, 128, seed=5)
    with torch.inference_mode():
        out, lse = tfa._flash_fwd(q, k, v, **kw)
        first = tfa._flash_bwd(q, k, v, None, None, out, lse, do, **kw)
        second = tfa._flash_bwd(q, k, v, None, None, out, lse, do, **kw)
        want = tfa.flash_bwd_reference(q, k, v, None, None, out, lse, do, **kw)
    assert torch.equal(first[1], second[1]) and torch.equal(first[2], second[2])
    assert _worst_row_ratio(second[0], first[0]) <= 1
    _assert_grads_close(first, want)
    empty = lse <= tfa.NEG_INF / 2
    assert empty.any()
    assert (first[0][empty] == 0).all() and (second[0][empty] == 0).all()


def _fused_views(q, k, v, *rest):
    """The model's layout of the same values: q, k, v views of one fused
    [B, S, H, 3D] buffer (MHA), or q contiguous [B, S, H, D] and k, v views
    of a fused [B, S, H_KV, 2D] buffer (GQA); ``rest`` (do) contiguous
    [B, S, H, D].  All returned [B, H, S, D]-shaped."""
    d = q.shape[3]
    bshd = [x.transpose(1, 2) for x in (q, k, v, *rest)]
    n_fused = 3 if q.shape[1] == k.shape[1] else 2
    fused = torch.cat(bshd[3 - n_fused:3], dim=-1).split(d, dim=-1)
    alone = [x.contiguous() for x in bshd[:3 - n_fused]] + [x.contiguous() for x in bshd[3:]]
    views = alone[:3 - n_fused] + list(fused) + alone[3 - n_fused:]
    return [x.transpose(1, 2) for x in views]


# name: (B, H, H_KV, S, D) — shapes (a) and (b) of the card check, causal
FUSED_SHAPES = {
    "a_gpt2_main_path": (8, 12, 12, 1024, 64),
    "b_gqa_d128": (2, 16, 4, 2048, 128),
}


@pytest.mark.parametrize("name", sorted(FUSED_SHAPES))
def test_kernels_on_views_of_fused_buffers(cuda, name):
    """Forward and backward on the model's layout, against the plain
    versions on [B, H, S, D] copies of the same values; out, dq, dk, dv come
    back [B, S, H, D] in memory."""
    q, k, v, do = _grad_inputs(cuda, *FUSED_SHAPES[name])
    qm, km, vm, dom = _fused_views(q, k, v, do)
    assert not km.is_contiguous() and not vm.is_contiguous()
    with torch.inference_mode():
        out, lse = tfa._flash_fwd(qm, km, vm)
        want_out, want_lse = tfa.flash_fwd_reference(q, k, v)
        got = tfa._flash_bwd(qm, km, vm, None, None, out, lse, dom)
        want = tfa.flash_bwd_reference(q, k, v, None, None, out, lse, do)
    torch.cuda.synchronize()
    assert all(x.transpose(1, 2).is_contiguous() for x in (out, *got))
    torch.testing.assert_close(out.float(), want_out.float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(lse, want_lse, atol=1e-3, rtol=0)
    _assert_grads_close(got, want)


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_forward_is_bitwise_equal_across_layouts(cuda, name):
    b, h, h_kv, s, d, kw = SHAPES[name]
    q, k, v, _ = _grad_inputs(cuda, b, h, h_kv, s, d, seed=6)
    with torch.inference_mode():
        out, lse = tfa._flash_fwd(q, k, v, **kw)
        out_m, lse_m = tfa._flash_fwd(*_fused_views(q, k, v), **kw)
    assert torch.equal(out, out_m) and torch.equal(lse, lse_m)


# name: (B, H, H_KV, S, D, kwargs) — chunks ahead of and behind their keys
# (rows that see no key), and a sequence length that no tile divides
EDGE_SHAPES = {
    "e_chunk_ahead": (2, 4, 4, 1024, 64, dict(causal=False, q_offset=512, window=384)),
    "e_chunk_behind": (2, 4, 4, 1024, 64, dict(causal=False, q_offset=-512, window=384)),
    "g_ragged_1000": (2, 4, 4, 1000, 64, dict(causal=True)),
}


@pytest.mark.parametrize("name", sorted(EDGE_SHAPES))
def test_empty_rows_and_ragged_edge(cuda, name):
    """Rows with no visible key give out exactly 0 and lse exactly -1e30 in
    both layouts; the rest match the plain version."""
    b, h, h_kv, s, d, kw = EDGE_SHAPES[name]
    q, k, v, _ = _grad_inputs(cuda, b, h, h_kv, s, d, seed=7)
    with torch.inference_mode():
        want_out, want_lse = tfa.flash_fwd_reference(q, k, v, **kw)
        empty = want_lse <= tfa.NEG_INF / 2
        for layout in (q, k, v), _fused_views(q, k, v):
            out, lse = tfa._flash_fwd(*layout, **kw)
            torch.testing.assert_close(out.float(), want_out.float(), atol=2e-2, rtol=2e-2)
            torch.testing.assert_close(lse, want_lse, atol=1e-3, rtol=0)
            assert (out[empty] == 0).all() and (lse[empty] == tfa.NEG_INF).all()
    assert empty.any() == name.startswith("e_")


def test_expanded_cotangent(cuda):
    """``out.sum().backward()`` hands the backward a cotangent with stride 0,
    which the kernel cannot address by row: the autograd function makes it
    readable, and the gradients match the plain backward's."""
    q, k, v, _ = _grad_inputs(cuda, 2, 4, 4, 256, 64, seed=8)
    leaves = [x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v)]
    tfa.flash_attention(*leaves).sum().backward()
    with torch.inference_mode():
        o, lse = tfa._flash_fwd(q, k, v)
        want = tfa.flash_bwd_reference(q, k, v, None, None, o, lse, torch.ones_like(q))
    _assert_grads_close([x.grad.transpose(1, 2) for x in leaves], want)
