"""Port parity: the PyTorch flash-attention backward against the JAX package.

The JAX side runs its Pallas backward kernels in interpret mode on the CPU;
the port runs the plain version of its backward kernel (the CPU path of
``_flash_bwd`` and of the ``tpu_parallel_torch::flash_bwd`` op).  Both are fed the same ``out``, ``lse`` and ``do`` (the JAX
forward's), so the forward's empty-row difference cannot leak in.  Inputs
are fp32, made with numpy from a seed.  Tolerance: atol = rtol = 1e-5 (fp32
sums in another order and block split).

Also here: gradients of the public ``flash_attention`` through autograd
against ``jax.grad``, and the remat contract (the JAX
``test_remat_policy_sees_kernel_outputs``): under ``"proj_attn"`` the
backward of a checkpointed block never re-runs the forward kernel.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from test_torch_flash_attention import CASES, _bhsd_inputs
from tpu_parallel_torch.models import GPTLM, tiny_test

jfa = importlib.import_module("tpu_parallel.ops.flash_attention")
tfa = importlib.import_module("tpu_parallel_torch.ops.flash_attention")

TOL = dict(atol=1e-5, rtol=1e-5)
# CASES plus a nonzero lse cotangent (the chunk/ring path's dlse)
BWD_CASES = {**{name: (*case, False) for name, case in CASES.items()},
             "gqa_window_dlse": (4, 2, 192, dict(window=80), False, None, True)}


@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_flash_bwd_matches_jax_kernels(case):
    h, h_kv, s, kw, packed, stream, with_dlse = BWD_CASES[case]
    q, k, v, seg = _bhsd_inputs(len(case), 2, h, h_kv, s, 32)
    rng = np.random.default_rng(len(case) + 1)
    do = rng.standard_normal(q.shape, dtype=np.float32)
    dlse = rng.standard_normal(q.shape[:3], dtype=np.float32) if with_dlse else None
    seg_j = jnp.asarray(seg)[:, :, None] if packed else None
    qj, kj, vj = (jnp.asarray(x) for x in (q, k, v))
    out_j, lse_j = jfa._flash_fwd(qj, kj, vj, seg_j, seg_j, block_q=64, block_k=64,
                                  interpret=True, stream=stream, **kw)
    want = jfa._flash_bwd(qj, kj, vj, seg_j, seg_j, out_j, lse_j, jnp.asarray(do),
                          block_q=64, block_k=64, interpret=True, stream=stream,
                          dlse=None if dlse is None else jnp.asarray(dlse), **kw)
    tseg = torch.from_numpy(seg) if packed else None
    got = tfa._flash_bwd(
        *(torch.from_numpy(x) for x in (q, k, v)), tseg, tseg,
        torch.from_numpy(np.array(out_j)), torch.from_numpy(np.array(lse_j)),
        torch.from_numpy(do), dlse=None if dlse is None else torch.from_numpy(dlse),
        stream=stream, **kw,
    )
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **TOL)
    if "empty" in case:
        empty = np.asarray(lse_j) <= tfa.NEG_INF / 2
        assert empty.any() and (got[0].numpy()[empty] == 0).all()


# name: (heads, kv heads, seq, kwargs, packed segments, nonzero dlse)
OP_CASES = {
    "dlse": (2, 2, 128, dict(causal=False, q_offset=-32, window=64), False, True),
    "gqa": (4, 2, 192, dict(window=80), False, False),
    "packed": (2, 2, 128, dict(), True, False),
}


@pytest.mark.parametrize("case", sorted(OP_CASES))
def test_flash_bwd_op_matches_jax(case):
    """The ``flash_bwd`` op itself (its CPU kernel, the plain version), as
    the autograd function and ``chip_smoke.py`` call it: out, do, lse and
    dlse in, (dq, dk, dv) out, against the JAX ``_flash_bwd``."""
    h, h_kv, s, kw, packed, with_dlse = OP_CASES[case]
    q, k, v, seg = _bhsd_inputs(31, 2, h, h_kv, s, 32)
    rng = np.random.default_rng(32)
    do = rng.standard_normal(q.shape, dtype=np.float32)
    dlse = rng.standard_normal(q.shape[:3], dtype=np.float32) if with_dlse else None
    seg_j = jnp.asarray(seg)[:, :, None] if packed else None
    qj, kj, vj = (jnp.asarray(x) for x in (q, k, v))
    out_j, lse_j = jfa._flash_fwd(qj, kj, vj, seg_j, seg_j, block_q=64, block_k=64,
                                  interpret=True, **kw)
    want = jfa._flash_bwd(qj, kj, vj, seg_j, seg_j, out_j, lse_j, jnp.asarray(do), block_q=64,
                          block_k=64, interpret=True,
                          dlse=None if dlse is None else jnp.asarray(dlse), **kw)
    tseg = torch.from_numpy(seg).to(torch.int32) if packed else None
    got = torch.ops.tpu_parallel_torch.flash_bwd(
        *(torch.from_numpy(x) for x in (q, k, v)), torch.from_numpy(np.array(out_j)),
        torch.from_numpy(do), torch.from_numpy(np.array(lse_j)),
        None if dlse is None else torch.from_numpy(dlse), tseg, tseg,
        kw.get("causal", True), kw.get("window", 0), kw.get("q_offset", 0))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **TOL)


@pytest.mark.parametrize("piece", ["delta", "delta_dlse", "dq_finish"])
def test_plain_pieces_match_jax(piece):
    """The kernel's first and last passes in their plain versions against
    the JAX ``_flash_bwd`` expressions: delta = rowsum(out * do) - dlse
    (``flash_attention.py:707-712``) and dq = (acc * scale) in the output
    dtype (``_bwd_dq_kernel``'s last line, ``:509``)."""
    rng = np.random.default_rng(33)
    out, do = (rng.standard_normal((2, 3, 40, 64), dtype=np.float32) for _ in range(2))
    if piece == "dq_finish":
        acc = rng.standard_normal((2, 3, 40, 64), dtype=np.float32)
        want = (jnp.asarray(acc) * (1.0 / 64**0.5)).astype(jnp.bfloat16)
        got = tfa._finish_dq(torch.from_numpy(acc), torch.bfloat16)
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
        return
    dlse = rng.standard_normal((2, 3, 40), dtype=np.float32) if piece == "delta_dlse" else None
    want = jnp.sum(jnp.asarray(out) * jnp.asarray(do), axis=-1)
    if dlse is not None:
        want = want - jnp.asarray(dlse)
    got = tfa._delta(torch.from_numpy(out), torch.from_numpy(do),
                     None if dlse is None else torch.from_numpy(dlse))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("case", ["mha", "gqa_window", "segments"])
def test_flash_attention_grads_match_jax(case):
    """d(sum(out * w))/d(q, k, v) of the [B, S, H, D] wrapper, by torch
    autograd through the finalize function and by ``jax.grad``."""
    h_kv, window, packed = dict(mha=(4, 0, False), gqa_window=(2, 40, False),
                                segments=(4, 0, True))[case]
    q, k, v, seg = _bhsd_inputs(11, 2, 4, h_kv, 128, 32)
    q, k, v = (x.transpose(0, 2, 1, 3) for x in (q, k, v))
    w = np.random.default_rng(12).standard_normal(q.shape, dtype=np.float32)
    seg_j = jnp.asarray(seg) if packed else None

    def jax_loss(q, k, v):
        out = jfa.flash_attention(q, k, v, segment_ids=seg_j, block_q=64, block_k=64,
                                  window=window, interpret=True)
        return (out * w).sum()

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = tfa.flash_attention(*leaves, segment_ids=torch.from_numpy(seg) if packed else None,
                              window=window)
    (out * torch.from_numpy(w)).sum().backward()
    for name, g, wg in zip(("dq", "dk", "dv"), leaves, want):
        np.testing.assert_allclose(g.grad.numpy(), np.asarray(wg), err_msg=name, **TOL)


class _CountOps(TorchDispatchMode):
    """Counts calls of one op that reach the dispatcher."""

    def __init__(self, op):
        super().__init__()
        self.op, self.calls = op, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.calls += func is self.op
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("policy,reruns_per_layer", [("proj_attn", 0), ("full", 1), ("proj", 1)])
def test_remat_policy_keeps_kernel_outputs(policy, reruns_per_layer):
    """Backward of checkpointed blocks: the forward kernel runs again once
    per layer under "full" and "proj", never under "proj_attn" (its out and
    lse are kept), and the gradients are the same either way."""
    tokens = torch.from_numpy(np.random.default_rng(13).integers(0, 256, (2, 32)))
    grads = {}
    for remat in (False, True):
        cfg = tiny_test(attn_impl="flash", remat=remat, remat_policy=policy)
        model = GPTLM(cfg, device="cpu", seed=2)
        loss = model(tokens).logsumexp(-1).mean()
        with _CountOps(tfa.FLASH_FWD_OP) as counter:
            loss.backward()
        assert counter.calls == (reruns_per_layer * cfg.n_layers if remat else 0)
        grads[remat] = [p.grad for p in model.parameters()]
    for with_remat, without in zip(grads[True], grads[False]):
        torch.testing.assert_close(with_remat, without, atol=0, rtol=0)
