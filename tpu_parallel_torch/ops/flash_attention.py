"""Flash attention: band geometry, plain PyTorch versions, and the wrappers
of the Hopper kernels (``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``).

Counterpart of ``tpu_parallel/ops/flash_attention.py``.  The TPU package has
a resident and a streamed form of each kernel (a VMEM artifact); here one
CUDA kernel per direction (forward; backward for dq, dk and dv) streams its
tiles through shared memory at every length, so ``stream=`` is kept for API
parity and gives the same result either way.  The kernels mask the ragged sequence
edge themselves: no shape falls back to the O(seq^2) path.

Shapes as in the JAX package: [batch, heads, seq, head_dim] for
:func:`_flash_fwd`, :func:`_flash_bwd`, the ops and the plain versions,
[batch, seq, heads, head_dim] at the public :func:`flash_attention`.  The
kernels address every bf16 operand by row, through its strides of batch,
head and sequence (head_dim has stride 1), so a [B, H, S, D]-shaped tensor
may lie in memory as [B, H, S, D], as [B, S, H, D] or as a view of a fused
projection: :func:`flash_attention` hands the model's [B, S, H, D] views of
its qkv projection to the kernels as they are, and the ops allocate each
output in its input's memory order (:func:`_empty_like_rows`), so nothing
is copied around the kernels.  K/V may carry fewer heads than Q
(grouped-query attention); they are never expanded.

Gradients follow the JAX ``_flash_finalize`` pattern: the forward kernel
runs on detached inputs and :class:`_FlashFinalize`, an identity on its
output, attaches the backward kernel, one pass that computes dq, dk and dv
together.  On a CPU tensor the wrappers take the plain versions; on a CUDA
tensor they launch the kernels or raise.  ``flash_fwd_launches`` and
``flash_bwd_launches`` count kernel launches.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from tpu_parallel_torch.ops.build import check, load_library

DEFAULT_BLOCK_Q = 128
DEFAULT_BLOCK_K = 128
NEG_INF = -1e30
KERNEL_HEAD_DIMS = (64, 128)

# kernel launches in this process; a caller may reset them to 0
flash_fwd_launches = 0
flash_bwd_launches = 0


def reference_attention(q, k, v, segment_ids=None):
    """Causal attention on [B, H, S, D] with an fp32 softmax: ground truth."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * scale
    s = q.shape[2]
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    if segment_ids is not None:
        same = segment_ids[:, None, :, None] == segment_ids[:, None, None, :]
        mask = mask & same
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs.to(q.dtype), v)


def _kv_row_map(h: int, h_kv: int):
    """Map query-head row ``bh`` of a [B*H, ...] array to its K/V head's row
    in the [B*H_KV, ...] K/V array: the GQA routing, with no expansion."""
    if h == h_kv:
        return lambda bh_: bh_
    group = h // h_kv
    return lambda bh_: (bh_ // h) * h_kv + (bh_ % h) // group


def _window_first_k_block(qi, block_q: int, block_k: int, window: int,
                          q_offset: int = 0):
    """First key block that can intersect the window of query block ``qi``."""
    return max(0, q_offset + qi * block_q - window + 1) // block_k


def _band_mask(qi, ki, shape, block_q: int, block_k: int, causal: bool,
               window: int, q_offset: int = 0, device=None):
    """Causal and/or sliding-window mask of one [block_q, block_k] score tile,
    or None when neither applies.  Query positions are shifted by
    ``q_offset`` against key positions; with ``causal=False`` the window is
    the symmetric band |q - k| < window."""
    if not (causal or window):
        return None
    q_pos = q_offset + qi * block_q + torch.arange(shape[0], device=device)[:, None]
    k_pos = ki * block_k + torch.arange(shape[1], device=device)[None, :]
    mask = None
    if causal:
        mask = q_pos >= k_pos
    if window:
        near = q_pos - k_pos < window
        if not causal:
            near = near & (k_pos - q_pos < window)
        mask = near if mask is None else mask & near
    return mask


def _stream_k_range(qi, block_q, block_k, causal, window, num_ki, q_offset=0):
    """[first, last] key-block range query block ``qi`` needs.  May be empty
    (first > last) for offset chunks whose window misses every key block."""
    if causal:
        last = ((qi + 1) * block_q - 1) // block_k
    elif window:
        last = min(num_ki - 1, (q_offset + (qi + 1) * block_q - 1 + window - 1) // block_k)
    else:
        last = num_ki - 1
    first = (
        _window_first_k_block(qi, block_q, block_k, window, q_offset) if window else 0
    )
    return first, last


def _finalize_rows(acc, m, l):
    """``(out, lse)`` from online-softmax state ``acc`` [..., D], ``m`` and
    ``l`` [..., 1].  A row with no visible key (``l == 0``) gives out = 0 and
    lse = NEG_INF, never 0/0."""
    empty = l <= 0.0
    safe_l = torch.where(empty, torch.ones_like(l), l)
    out = torch.where(empty, torch.zeros_like(acc), acc / safe_l)
    lse = torch.where(empty, torch.full_like(m, NEG_INF), m + torch.log(safe_l))
    return out, lse[..., 0]


def _visible(q, k, seg_q, seg_k, causal, window, q_offset):
    """Bool mask [B or 1, 1, 1, S, S_KV] of the (query, key) pairs that may
    attend, in the grouped layout of the plain versions."""
    mask = _band_mask(0, 0, (q.shape[2], k.shape[2]), q.shape[2], k.shape[2], causal,
                      window, q_offset, device=q.device)
    if mask is None:
        mask = torch.ones(q.shape[2], k.shape[2], dtype=torch.bool, device=q.device)
    mask = mask[None, None, None]
    if seg_q is not None:
        mask = mask & (seg_q[:, :, None] == seg_k[:, None, :])[:, None, None]
    return mask


def flash_fwd_reference(q, k, v, seg_q=None, seg_k=None, *, causal=True,
                        window=0, q_offset=0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the forward kernel, same contract.

    ``q`` [B, H, S, D], ``k``/``v`` [B, H_KV, S_KV, D], ``seg_q`` [B, S] and
    ``seg_k`` [B, S_KV] (both or neither).  Returns ``out`` [B, H, S, D] in
    the input dtype and ``lse`` [B, H, S] fp32.  ``q`` is pre-scaled by
    1/sqrt(D) in the input dtype, scores and softmax are fp32, P is rounded
    to the input dtype before the P.V product (accumulated in fp32), and
    grouped queries contract against their K/V head without expansion.
    """
    b, h, s, d = q.shape
    h_kv, s_kv = k.shape[1], k.shape[2]
    group = h // h_kv
    scale = torch.tensor(1.0 / d**0.5, dtype=q.dtype)
    qs = (q * scale).to(q.dtype).reshape(b, h_kv, group, s, d)
    scores = torch.einsum("bngqd,bnkd->bngqk", qs.float(), k.float())
    scores = scores.masked_fill(~_visible(q, k, seg_q, seg_k, causal, window, q_offset),
                                float("-inf"))
    # rows with no visible key keep m = NEG_INF, so exp(-inf - m) = 0 and l = 0
    m = scores.amax(dim=-1, keepdim=True).clamp(min=NEG_INF)
    p = torch.exp(scores - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bngqk,bnkd->bngqd", p.to(q.dtype).float(), v.float())
    out, lse = _finalize_rows(acc, m, l)
    return out.to(q.dtype).reshape(b, h, s, d), lse.reshape(b, h, s)


def _bwd_terms(q, k, v, seg_q, seg_k, lse, do, delta, causal, window, q_offset):
    """``(qs, p, ds)`` of the plain backward, grouped [B, H_KV, group, ...]:
    the pre-scaled q, the probabilities (0 on masked pairs and on rows with
    lse <= NEG_INF / 2) and ds = p * (dp - delta) in the input dtype."""
    b, h, s, d = q.shape
    h_kv = k.shape[1]
    group = h // h_kv
    grouped = lambda x: x.reshape(b, h_kv, group, s, *x.shape[3:])
    scale = torch.tensor(1.0 / d**0.5, dtype=q.dtype)
    qs = grouped((q * scale).to(q.dtype))
    scores = torch.einsum("bngqd,bnkd->bngqk", qs.float(), k.float())
    lse_g = grouped(lse)[..., None]
    mask = _visible(q, k, seg_q, seg_k, causal, window, q_offset) & (lse_g > NEG_INF / 2)
    p = torch.where(mask, torch.exp(scores - lse_g), torch.zeros((), device=q.device))
    dp = torch.einsum("bngqd,bnkd->bngqk", grouped(do).float(), v.float())
    ds = (p * (dp - grouped(delta)[..., None])).to(q.dtype)
    return qs, p, ds


def _finish_dq(acc, dtype):
    """dq = acc * (1/sqrt(D)) rounded to ``dtype``, from the fp32 sum
    acc = sum_k ds.k: the kernel's finishing pass (``_bwd_dq_kernel``'s
    last line)."""
    return (acc * (1.0 / acc.shape[-1] ** 0.5)).to(dtype)


def _reference_dq(q, k, v, do, lse, delta, seg_q, seg_k, causal, window, q_offset):
    b, h, s, d = q.shape
    _, _, ds = _bwd_terms(q, k, v, seg_q, seg_k, lse, do, delta, causal, window, q_offset)
    acc = torch.einsum("bngqk,bnkd->bngqd", ds.float(), k.float())
    return _finish_dq(acc, q.dtype).reshape(b, h, s, d)


def _reference_dkv(q, k, v, do, lse, delta, seg_q, seg_k, causal, window, q_offset):
    b, h, s, d = q.shape
    qs, p, ds = _bwd_terms(q, k, v, seg_q, seg_k, lse, do, delta, causal, window, q_offset)
    do_g = do.reshape(qs.shape)
    dk = torch.einsum("bngqk,bngqd->bnkd", ds.float(), qs.float())
    dv = torch.einsum("bngqk,bngqd->bnkd", p.to(q.dtype).float(), do_g.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def _delta(out, do, dlse=None):
    """rowsum(out * do) in fp32, minus the lse cotangent when there is one:
    the per-row correction of ds = p * (dp - delta) (``_flash_bwd``), which
    the kernel's first pass computes."""
    delta = (out.float() * do.float()).sum(-1)
    return delta if dlse is None else delta - dlse


def flash_bwd_reference(q, k, v, seg_q, seg_k, out, lse, do, *, causal=True, window=0,
                        q_offset=0, dlse=None):
    """Plain PyTorch version of the backward kernel, same contract.

    Layouts as :func:`flash_fwd_reference`; ``out``/``lse`` are the forward's,
    ``do`` [B, H, S, D] the cotangent of ``out`` and ``dlse`` [B, H, S] that of
    ``lse`` (or None).  Returns ``(dq, dk, dv)`` in the input dtype: p is
    recomputed as exp(s - lse) from the pre-scaled q, ds = p * (dp - delta)
    is rounded to the input dtype, p is rounded before p^T.do, and sums run
    in fp32; dk, dv sum each K/V head's query group.
    """
    delta = _delta(out, do, dlse)
    args = (q, k, v, do, lse, delta, seg_q, seg_k, causal, window, q_offset)
    return (_reference_dq(*args), *_reference_dkv(*args))


def _check_args(q, k, v, seg_q, seg_k, causal, window, q_offset):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [batch, heads, seq, head_dim]")
    b, h, s, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not match q {tuple(q.shape)}")
    if h % k.shape[1] != 0:
        raise ValueError(f"q heads {h} not a multiple of k/v heads {k.shape[1]}")
    if (seg_q is None) != (seg_k is None):
        raise ValueError("seg_q and seg_k must be passed together")
    if seg_q is not None and (
        tuple(seg_q.shape) != (b, s) or tuple(seg_k.shape) != (b, k.shape[2])
    ):
        raise ValueError(
            f"segment ids {tuple(seg_q.shape)}/{tuple(seg_k.shape)} must be "
            f"[batch, seq_q]/[batch, seq_kv] = {(b, s)}/{(b, k.shape[2])}"
        )
    if causal and q_offset != 0:
        raise ValueError("q_offset applies to causal=False chunks only")
    if window < 0:
        raise ValueError(f"window must be >= 0 (0 = no window), got {window}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash attention runs on cuda or cpu tensors, got {q.device}")


_DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


def _rows_readable(t) -> Optional[str]:
    """Why the kernels cannot address ``t`` [B, H, S, D] by row, or None
    when they can: head_dim must have stride 1 and every row (its data
    pointer and its batch, head and sequence strides) must sit on a 16-byte
    boundary.  A stride of a dimension of size 1 is never used."""
    if t.stride(3) != 1:
        return f"head_dim stride 1, got strides {tuple(t.stride())}"
    size = t.element_size()
    if t.data_ptr() % 16 or any(
        n > 1 and st * size % 16 for n, st in zip(t.shape[:3], t.stride()[:3])
    ):
        return (f"16-byte aligned rows, got strides {tuple(t.stride())} at byte offset "
                f"{t.data_ptr() % 16}")
    return None


def kernel_row_strides(kernel, tensors) -> list:
    """The (batch, head, seq) element strides of each [B, H, S, D] tensor
    in ``tensors`` (a name -> tensor dict, in the kernel's order), flattened,
    as the C entry points take them.  Raises ``ValueError`` when the kernel
    cannot read a tensor in place (see :func:`_rows_readable`); never
    copies."""
    strides = []
    for name, t in tensors.items():
        if t.dim() != 4:
            raise ValueError(f"{kernel} kernel takes [B, H, S, D] {name}, got {tuple(t.shape)}")
        why = _rows_readable(t)
        if why is not None:
            raise ValueError(f"{kernel} kernel needs {why} for {name}")
        strides += [st if n > 1 else 0 for n, st in zip(t.shape[:3], t.stride()[:3])]
    return strides


def _empty_like_rows(x):
    """An uninitialised tensor of ``x``'s [B, H, S, D] shape and dtype in
    ``x``'s memory order: [B, S, H, D] in memory (returned as its [B, H, S,
    D] view) when ``x``'s seq stride exceeds its head stride, as for the
    model's views of its projections; [B, H, S, D] otherwise."""
    b, h, s, d = x.shape
    if x.stride(2) > x.stride(1):
        return torch.empty(b, s, h, d, dtype=x.dtype, device=x.device).transpose(1, 2)
    return torch.empty(b, h, s, d, dtype=x.dtype, device=x.device)


def _kernel_operands(kernel, bf16, fp32, seg_q, seg_k, device):
    """Check what a kernel reads and writes; return the row strides of the
    bf16 tensors (:func:`kernel_row_strides`) and the segment ids as int32
    (or None).  ``bf16`` maps names to [B, H, S, D] tensors the kernel
    addresses by row, ``fp32`` to tensors it reads contiguous (an optional
    one may be None); all must be on ``device``.  Raises, never copies a
    bf16 tensor."""
    for dtype, tensors in (("bf16", bf16), ("fp32", fp32)):
        for name, t in tensors.items():
            if t is None:
                continue
            if t.device != device:
                raise ValueError(f"{name} is on {t.device}, q on {device}")
            if t.dtype != _DTYPES[dtype]:
                raise TypeError(f"{kernel} kernel takes {dtype} {name}, got {t.dtype}")
            if dtype == "fp32" and not t.is_contiguous():
                raise ValueError(f"{kernel} kernel needs contiguous {name}")
    d = bf16["q"].shape[3]
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{kernel} kernel takes head_dim in {KERNEL_HEAD_DIMS}, got {d}")
    strides = kernel_row_strides(kernel, bf16)
    if seg_q is None:
        return strides, None, None
    if seg_q.device != device or seg_k.device != device:
        raise ValueError("segment ids must be on q's device")
    return strides, seg_q.to(torch.int32).contiguous(), seg_k.to(torch.int32).contiguous()


def _launch(kernel, source, bf16, fp32, outs, seg_q, seg_k, causal, window, q_offset):
    """Launch C entry point ``kernel`` of ``csrc/<source>.cu``.  Its pointer
    arguments are the bf16 inputs, the fp32 inputs, the segment ids and the
    outputs (scratch first, where the kernel takes any), in that order, each
    a name -> tensor dict; then the row strides of the bf16 inputs and
    outputs in the same order, the shapes, the options, the scale and the
    current stream.  Raises if the launch fails."""
    q, k = bf16["q"], bf16["k"]
    strided = {**bf16, **{n: t for n, t in outs.items() if t.dtype == torch.bfloat16}}
    strides, seg_q, seg_k = _kernel_operands(kernel, strided, fp32, seg_q, seg_k, q.device)
    b, h, s, d = q.shape
    pointers = [*bf16.values(), *fp32.values(), seg_q, seg_k, *outs.values()]
    lib = load_library(source)
    with torch.cuda.device(q.device):
        code = getattr(lib, kernel)(
            *(ctypes.c_void_p(t.data_ptr() if t is not None else None) for t in pointers),
            (ctypes.c_longlong * len(strides))(*strides),
            ctypes.c_int(b), ctypes.c_int(h), ctypes.c_int(k.shape[1]), ctypes.c_int(s),
            ctypes.c_int(k.shape[2]), ctypes.c_int(d), ctypes.c_int(int(causal)),
            ctypes.c_int(window), ctypes.c_int(q_offset), ctypes.c_float(1.0 / d**0.5),
            ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream),
        )
    check(lib, code, kernel)


# The kernels are custom operators, so that autograd and the selective
# checkpoint policies of models/layers.py see each launch as one op: the
# "proj_attn" policy keeps the forward's (out, lse) and the backward never
# re-runs it.  The CUDA implementation launches the kernel; the CPU one is
# the plain version.  Both return each bf16 output in the memory order of
# the input it belongs to (out and dq like q, dk like k, dv like v).


@torch.library.custom_op("tpu_parallel_torch::flash_fwd", mutates_args=(), device_types="cuda")
def _flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  seg_q: Optional[torch.Tensor], seg_k: Optional[torch.Tensor], causal: bool,
                  window: int, q_offset: int) -> Tuple[torch.Tensor, torch.Tensor]:
    global flash_fwd_launches
    out = _empty_like_rows(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    _launch("flash_fwd", "flash_fwd", dict(q=q, k=k, v=v), {}, dict(out=out, lse=lse), seg_q,
            seg_k, causal, window, q_offset)
    flash_fwd_launches += 1
    return out, lse


@_flash_fwd_op.register_kernel("cpu")
def _flash_fwd_cpu(q, k, v, seg_q, seg_k, causal, window, q_offset):
    out, lse = flash_fwd_reference(q, k, v, seg_q, seg_k, causal=causal, window=window,
                                   q_offset=q_offset)
    return _empty_like_rows(q).copy_(out), lse


@torch.library.custom_op("tpu_parallel_torch::flash_bwd", mutates_args=(), device_types="cuda")
def _flash_bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                  do: torch.Tensor, lse: torch.Tensor, dlse: Optional[torch.Tensor],
                  seg_q: Optional[torch.Tensor], seg_k: Optional[torch.Tensor], causal: bool,
                  window: int, q_offset: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    global flash_bwd_launches
    dq, dk, dv = (_empty_like_rows(x) for x in (q, k, v))
    # scratch: delta = rowsum(out * do) - dlse, and the fp32 dq the key blocks add into
    delta = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    dq_acc = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    _launch("flash_bwd", "flash_bwd", dict(q=q, k=k, v=v, out=out, do=do),
            dict(lse=lse, dlse=dlse), dict(delta=delta, dq_acc=dq_acc, dq=dq, dk=dk, dv=dv),
            seg_q, seg_k, causal, window, q_offset)
    flash_bwd_launches += 1
    return dq, dk, dv


@_flash_bwd_op.register_kernel("cpu")
def _flash_bwd_cpu(q, k, v, out, do, lse, dlse, seg_q, seg_k, causal, window, q_offset):
    grads = flash_bwd_reference(q, k, v, seg_q, seg_k, out, lse, do, causal=causal,
                                window=window, q_offset=q_offset, dlse=dlse)
    return tuple(_empty_like_rows(x).copy_(g) for x, g in zip((q, k, v), grads))


FLASH_FWD_OP = torch.ops.tpu_parallel_torch.flash_fwd.default


def _flash_fwd(q, k, v, seg_q=None, seg_k=None, *, causal=True, window=0,
               stream=None, q_offset=0, block_q=DEFAULT_BLOCK_Q,
               block_k=DEFAULT_BLOCK_K):
    """Forward kernel on [B, H, S, D]-shaped inputs of any row strides ->
    ``(out, lse)``, ``out`` in ``q``'s memory order: the kernel on a CUDA
    tensor, :func:`flash_fwd_reference` on a CPU tensor.  No gradient flows
    through it (see :func:`_flash_attention_bhsd`).

    ``block_q``/``block_k`` and ``stream`` exist for parity with the JAX
    signature: the CUDA kernel's tiles (128 query rows by 64 keys) are its
    own constants and one kernel serves every sequence length.
    """
    del block_q, block_k, stream
    _check_args(q, k, v, seg_q, seg_k, causal, window, q_offset)
    return torch.ops.tpu_parallel_torch.flash_fwd(q, k, v, seg_q, seg_k, causal, window,
                                                  q_offset)


def _flash_bwd(q, k, v, seg_q, seg_k, out, lse, do, *, causal=True, window=0, dlse=None,
               stream=None, q_offset=0, block_q=DEFAULT_BLOCK_Q, block_k=DEFAULT_BLOCK_K):
    """Backward -> ``(dq, dk, dv)``: one ``flash_bwd`` op call on a CUDA
    tensor (the kernel's prep, main and finish passes, counted as one
    launch), :func:`flash_bwd_reference` on a CPU tensor.

    ``delta = rowsum(out * do) - dlse`` (the JAX ``_flash_bwd`` computes it
    in XLA) is computed by the kernel's prep pass.  ``q``, ``k``, ``v``,
    ``out`` and ``do`` may have any row strides the kernel can read
    (:func:`kernel_row_strides`); ``dq``, ``dk``, ``dv`` come back in the
    memory order of ``q``, ``k``, ``v``.  ``stream``/``block_*`` as in
    :func:`_flash_fwd`.
    """
    del block_q, block_k, stream
    _check_args(q, k, v, seg_q, seg_k, causal, window, q_offset)
    if out.shape != q.shape or do.shape != q.shape or lse.shape != q.shape[:3] or (
        dlse is not None and dlse.shape != lse.shape
    ):
        raise ValueError(
            f"out {tuple(out.shape)} / do {tuple(do.shape)} / lse {tuple(lse.shape)} / dlse "
            f"{None if dlse is None else tuple(dlse.shape)} do not match q {tuple(q.shape)}"
        )
    return torch.ops.tpu_parallel_torch.flash_bwd(
        q, k, v, out, do, lse.contiguous(),
        None if dlse is None else dlse.contiguous(), seg_q, seg_k, causal, window, q_offset)


class _FlashFinalize(torch.autograd.Function):
    """Identity on ``out`` that attaches the backward kernel (the JAX
    ``_flash_finalize``).  The forward kernel runs OUTSIDE this function on
    detached inputs, so its (out, lse) are ordinary op outputs that a remat
    policy can keep; the backward launches ``flash_bwd`` once and never
    re-runs the forward."""

    @staticmethod
    def forward(ctx, q, k, v, seg, out, lse, window):
        ctx.save_for_backward(q, k, v, seg, out, lse)
        ctx.window = window
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, seg, out, lse = ctx.saved_tensors
        if _rows_readable(do) is not None:
            # an expanded or otherwise unaddressable cotangent (out.sum()
            # gives stride 0); the model's arrives as a view the kernel reads
            do = do.contiguous()
        dq, dk, dv = _flash_bwd(q, k, v, seg, seg, out, lse, do, window=ctx.window)
        return dq, dk, dv, None, None, None, None


def _flash_attention_bhsd(q, k, v, seg, window=0, stream=None):
    """Causal flash attention on [B, H, S, D], differentiable in q, k, v."""
    out, lse = _flash_fwd(q.detach(), k.detach(), v.detach(), seg, seg, window=window,
                          stream=stream)
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))):
        return out
    return _FlashFinalize.apply(q, k, v, seg, out, lse, window)


def flash_attention(q, k, v, *, segment_ids=None, block_q=DEFAULT_BLOCK_Q,
                    block_k=DEFAULT_BLOCK_K, window=0, stream=None):
    """Causal flash attention on [batch, seq, heads, head_dim] inputs.

    ``k``/``v`` may carry fewer heads than ``q`` (``n_heads % n_kv_heads ==
    0``).  ``window > 0`` limits query t to keys in (t - window, t]; key
    tiles outside the band are skipped.  ``segment_ids`` [batch, seq] masks
    attention to the same packed segment.  Differentiable in q, k and v
    through the backward kernel; see the module docstring for the device
    rule.  The kernels read q, k and v where they lie (any row strides with
    head_dim stride 1, such as views of a fused qkv projection) and the
    result is a [batch, seq, heads, head_dim] tensor contiguous in memory
    when q's seq stride exceeds its head stride; nothing is copied in the
    forward or the backward.
    """
    del block_q, block_k
    h, h_kv = q.shape[2], k.shape[2]
    if h % h_kv != 0:
        raise ValueError(f"q heads {h} not a multiple of k/v heads {h_kv}")
    out = _flash_attention_bhsd(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                segment_ids, window, stream)
    return out.transpose(1, 2)
