"""The port's flash attention on the model's own layout: [B, S, H, D] views
of fused projections, read and written in place.

- Parity: ``flash_attention`` on views of a fused [B, S, H, 3D] qkv buffer
  (MHA) and on q plus views of a fused [B, S, H_KV, 2D] kv buffer (GQA, with
  a window and packed segments) against the JAX ``flash_attention`` (Pallas
  kernels in interpret mode), forward and gradients with respect to the
  fused buffers.  The port runs its plain versions (the CPU path of the
  ops).  Inputs fp32 from numpy with a seed; tolerance atol = rtol = 1e-5,
  as ``tests/test_torch_flash_attention.py`` and
  ``tests/test_torch_flash_bwd.py`` hold the forward and the backward.
- Copies: one ``Attention`` forward and backward under ``"proj_attn"``
  remat dispatches no copy of q, k, v, out, do, dq, dk or dv; the one copy
  left is autograd's concatenation of dq, dk, dv (dk, dv under GQA) into
  the fused projection's gradient, the backward of its split.
- Strides: what the kernels are told about each view kind, and the
  wrapper's refusals of what they cannot address.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import checkpoint

from test_torch_flash_attention import TOL, _segments
from tpu_parallel_torch.models import tiny_test
from tpu_parallel_torch.models.layers import Attention, remat_kwargs_for

# one torch intra-op thread per test process: under pytest-xdist several
# processes share the cores, and torch's default (a thread per core in each)
# oversubscribes them
torch.set_num_threads(1)

jfa = importlib.import_module("tpu_parallel.ops.flash_attention")
tfa = importlib.import_module("tpu_parallel_torch.ops.flash_attention")

# name: (batch, heads, kv heads, seq, head_dim, window, packed segments)
CASES = {
    "mha_fused_qkv": (2, 4, 4, 128, 32, 0, False),
    "gqa_fused_kv_window_segments": (2, 4, 2, 192, 32, 80, True),
}


def _fused_inputs(case):
    """The fused buffers of a case, as numpy: (qkv,) for MHA, (q, kv) for
    GQA, and the segment ids (or None) and the output weights."""
    b, h, h_kv, s, d, _, packed = CASES[case]
    rng = np.random.default_rng(len(case))
    if h == h_kv:
        buffers = (rng.standard_normal((b, s, h, 3 * d), dtype=np.float32),)
    else:
        buffers = (rng.standard_normal((b, s, h, d), dtype=np.float32),
                   rng.standard_normal((b, s, h_kv, 2 * d), dtype=np.float32))
    seg = _segments(rng, b, s) if packed else None
    w = rng.standard_normal((b, s, h, d), dtype=np.float32)
    return buffers, seg, w


def _split(buffers, d, split):
    """q, k, v from the fused buffers, by the framework's ``split``."""
    if len(buffers) == 1:
        return split(buffers[0], d)
    return (buffers[0], *split(buffers[1], d))


@pytest.mark.parametrize("case", sorted(CASES))
def test_views_of_fused_buffers_match_jax(case):
    _, _, _, _, d, window, packed = CASES[case]
    buffers, seg, w = _fused_inputs(case)

    def jax_loss(*bufs):
        q, k, v = _split(bufs, d, lambda x, n: jnp.split(x, x.shape[-1] // n, axis=-1))
        out = jfa.flash_attention(q, k, v, segment_ids=None if seg is None else jnp.asarray(seg),
                                  block_q=64, block_k=64, window=window, interpret=True)
        return (out * w).sum(), out

    (_, want_out), want_grads = jax.value_and_grad(
        jax_loss, argnums=tuple(range(len(buffers))), has_aux=True
    )(*(jnp.asarray(x) for x in buffers))

    leaves = [torch.from_numpy(x).requires_grad_() for x in buffers]
    q, k, v = _split(leaves, d, lambda x, n: x.split(n, dim=-1))
    assert all(not x.is_contiguous() for x in (k, v))  # views, read in place
    out = tfa.flash_attention(q, k, v, segment_ids=None if seg is None else torch.from_numpy(seg),
                              window=window)
    assert out.is_contiguous()  # [B, S, H, D] in memory: the model's reshape is a view
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), **TOL)
    (out * torch.from_numpy(w)).sum().backward()
    for leaf, want in zip(leaves, want_grads):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(want), **TOL)


# ops that copy a tensor's elements, and the concatenations among them
_COPIES = ("clone", "_to_copy", "copy_", "contiguous", "_reshape_copy", "cat", "stack")


class _CopyLog(TorchDispatchMode):
    """Records every dispatched op that copies elements, with the shapes of
    its tensor arguments (a list argument's tensors included)."""

    def __init__(self):
        super().__init__()
        self.copies = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in _COPIES:
            flat = [a for x in args for a in (x if isinstance(x, (list, tuple)) else [x])]
            shapes = [tuple(t.shape) for t in flat if isinstance(t, torch.Tensor)]
            self.copies.append((name, shapes))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("n_kv_heads", [None, 2], ids=["mha", "gqa"])
def test_attention_copies_nothing_around_the_kernels(n_kv_heads):
    """One ``Attention`` forward and backward under ``"proj_attn"``: the
    kernels read the projection's views and write out, dq, dk, dv in the
    [B, S, H, D] order, so the only copy is the split backward's
    concatenation of the head gradients into the fused projection's."""
    cfg = tiny_test(attn_impl="flash", remat=True, remat_policy="proj_attn",
                    n_kv_heads=n_kv_heads)
    b, s, h, d = 2, cfg.seq_len, cfg.n_heads, cfg.head_dim
    h_kv = n_kv_heads or h
    attn = Attention(cfg, device="cpu")
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((b, s, cfg.d_model),
                                                                  dtype=np.float32))
    x.requires_grad_()
    with _CopyLog() as log:
        checkpoint(attn, x, **remat_kwargs_for(cfg)).sum().backward()
    fused = [(b, s, h, d)] * 3 if h_kv == h else [(b, s, h_kv, d)] * 2
    assert log.copies == [("cat", fused)]
    assert x.grad is not None and torch.isfinite(x.grad).all()


def _bf16(*shape):
    return torch.zeros(*shape, dtype=torch.bfloat16)


def test_row_strides_of_both_view_kinds():
    """(batch, head, seq) strides the C entry points get: views of a fused
    [B, S, H, 3D] qkv buffer are (S*H*3D, 3D, H*3D); q contiguous in
    [B, S, H, D] and k/v views of a [B, S, H_KV, 2D] kv buffer are (S*H*D,
    D, H*D) and (S*H_KV*2D, 2D, H_KV*2D); the JAX layout [B, H, S, D] is
    (H*S*D, S*D, D).  A stride of a size-1 dimension is passed as 0."""
    b, s, h, h_kv, d = 2, 64, 4, 2, 64
    q, k, v = (x.transpose(1, 2) for x in _bf16(b, s, h, 3 * d).split(d, dim=-1))
    assert tfa.kernel_row_strides("flash_fwd", dict(q=q, k=k, v=v)) == \
        [s * h * 3 * d, 3 * d, h * 3 * d] * 3
    q = _bf16(b, s, h, d).transpose(1, 2)
    k, v = (x.transpose(1, 2) for x in _bf16(b, s, h_kv, 2 * d).split(d, dim=-1))
    assert tfa.kernel_row_strides("flash_fwd", dict(q=q, k=k, v=v)) == \
        [s * h * d, d, h * d] + [s * h_kv * 2 * d, 2 * d, h_kv * 2 * d] * 2
    assert tfa.kernel_row_strides("flash_fwd", dict(q=_bf16(b, h, s, d))) == [h * s * d, s * d, d]
    assert tfa.kernel_row_strides("flash_fwd", dict(q=_bf16(1, h, s, d))) == [0, s * d, d]
    # outputs come back in their input's memory order
    out = tfa._empty_like_rows(q)
    assert out.shape == q.shape and out.transpose(1, 2).is_contiguous()
    assert tfa._empty_like_rows(_bf16(b, h, s, d)).is_contiguous()


@pytest.mark.parametrize("fault", ["inner_stride", "unaligned_pointer", "unaligned_row"])
def test_wrapper_refuses_rows_the_kernel_cannot_address(fault):
    """The kernel wrapper's check raises ValueError (and never copies) on a
    head_dim stride other than 1, a data pointer off a 16-byte boundary, and
    a row stride that is not a multiple of 16 bytes."""
    b, h, s, d = 1, 2, 64, 64
    q = {
        "inner_stride": _bf16(b, h, s, 2 * d)[..., ::2],
        "unaligned_pointer": _bf16(b * h * s * d + 1)[1:].view(b, h, s, d),
        "unaligned_row": _bf16(b, h, s, d + 1)[..., :d],
    }[fault]
    kv = _bf16(b, h, s, d)
    with pytest.raises(ValueError, match="stride 1|16-byte"):
        tfa._kernel_operands("flash_fwd", dict(q=q, k=kv, v=kv), {}, None, None, q.device)
