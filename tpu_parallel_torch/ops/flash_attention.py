"""Flash-attention forward: band geometry, plain PyTorch version, and the
wrapper of the Hopper kernel (``csrc/flash_fwd.cu``).

Counterpart of ``tpu_parallel/ops/flash_attention.py``.  The TPU package has
a resident and a streamed forward kernel (a VMEM artifact); here one CUDA
kernel streams K/V tiles through shared memory at every length, so
``stream=`` is kept for API parity and gives the same result either way.
The kernel masks the ragged sequence edge itself: no shape falls back to
the O(seq^2) path.  The backward kernels (dq, dk/dv) come with the training
slice; until then a CUDA input that needs a gradient raises.

Layouts as in the JAX package: [batch, heads, seq, head_dim] for
:func:`_flash_fwd` and :func:`flash_fwd_reference`, [batch, seq, heads,
head_dim] at the public :func:`flash_attention`.  K/V may carry fewer heads
than Q (grouped-query attention); they are never expanded.

On a CPU tensor the wrappers take the plain version; on a CUDA tensor they
launch the kernel or raise.  ``flash_fwd_launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from tpu_parallel_torch.ops.build import check, load_library

DEFAULT_BLOCK_Q = 128
DEFAULT_BLOCK_K = 128
NEG_INF = -1e30
KERNEL_HEAD_DIMS = (64, 128)

# kernel launches in this process; a caller may reset it to 0
flash_fwd_launches = 0


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
    mask = _band_mask(0, 0, (s, s_kv), s, s_kv, causal, window, q_offset, device=q.device)
    if seg_q is not None:
        same = (seg_q[:, :, None] == seg_k[:, None, :])[:, None, None]
        mask = same if mask is None else mask & same
    if mask is not None:
        scores = scores.masked_fill(~mask, float("-inf"))
    # rows with no visible key keep m = NEG_INF, so exp(-inf - m) = 0 and l = 0
    m = scores.amax(dim=-1, keepdim=True).clamp(min=NEG_INF)
    p = torch.exp(scores - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bngqk,bnkd->bngqd", p.to(q.dtype).float(), v.float())
    out, lse = _finalize_rows(acc, m, l)
    return out.to(q.dtype).reshape(b, h, s, d), lse.reshape(b, h, s)


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


def _launch(q, k, v, seg_q, seg_k, causal, window, q_offset):
    global flash_fwd_launches
    for name, t in zip("qkv", (q, k, v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash_fwd kernel takes bf16, got {name} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"flash_fwd kernel needs contiguous {name}")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_fwd kernel needs 16-byte aligned {name}")
    b, h, s, d = q.shape
    h_kv, s_kv = k.shape[1], k.shape[2]
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_fwd kernel takes head_dim in {KERNEL_HEAD_DIMS}, got {d}")
    if b * h > 65535:
        raise ValueError(f"flash_fwd kernel takes batch*heads <= 65535, got {b * h}")
    if seg_q is not None:
        if seg_q.device != q.device or seg_k.device != q.device:
            raise ValueError("segment ids must be on q's device")
        seg_q = seg_q.to(torch.int32).contiguous()
        seg_k = seg_k.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    lib = load_library("flash_fwd")
    with torch.cuda.device(q.device):
        code = lib.flash_fwd(
            ctypes.c_void_p(q.data_ptr()), ctypes.c_void_p(k.data_ptr()),
            ctypes.c_void_p(v.data_ptr()),
            ctypes.c_void_p(seg_q.data_ptr() if seg_q is not None else None),
            ctypes.c_void_p(seg_k.data_ptr() if seg_k is not None else None),
            ctypes.c_void_p(out.data_ptr()), ctypes.c_void_p(lse.data_ptr()),
            ctypes.c_int(b), ctypes.c_int(h), ctypes.c_int(h_kv), ctypes.c_int(s),
            ctypes.c_int(s_kv), ctypes.c_int(d), ctypes.c_int(int(causal)),
            ctypes.c_int(window), ctypes.c_int(q_offset),
            ctypes.c_float(1.0 / d**0.5),
            ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream),
        )
    check(lib, code, "flash_fwd")
    flash_fwd_launches += 1
    return out, lse


def _flash_fwd(q, k, v, seg_q=None, seg_k=None, *, causal=True, window=0,
               stream=None, q_offset=0, block_q=DEFAULT_BLOCK_Q,
               block_k=DEFAULT_BLOCK_K):
    """Forward kernel on [B, H, S, D] inputs -> ``(out, lse)``: the kernel
    on a CUDA tensor, :func:`flash_fwd_reference` on a CPU tensor.

    ``block_q``/``block_k`` and ``stream`` exist for parity with the JAX
    signature: the CUDA kernel's 64x64 tiles are its own constants and
    one kernel serves every sequence length.
    """
    del block_q, block_k, stream
    _check_args(q, k, v, seg_q, seg_k, causal, window, q_offset)
    if q.device.type == "cpu":
        return flash_fwd_reference(
            q, k, v, seg_q, seg_k, causal=causal, window=window, q_offset=q_offset
        )
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu tensors, got {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash attention on CUDA is forward-only: its backward kernels (dq, "
            "dk/dv) come with the training slice; run under torch.no_grad() or "
            "torch.inference_mode()"
        )
    return _launch(q, k, v, seg_q, seg_k, causal, window, q_offset)


def flash_attention(q, k, v, *, segment_ids=None, block_q=DEFAULT_BLOCK_Q,
                    block_k=DEFAULT_BLOCK_K, window=0, stream=None):
    """Causal flash attention on [batch, seq, heads, head_dim] inputs.

    ``k``/``v`` may carry fewer heads than ``q`` (``n_heads % n_kv_heads ==
    0``).  ``window > 0`` limits query t to keys in (t - window, t]; key
    tiles outside the band are skipped.  ``segment_ids`` [batch, seq] masks
    attention to the same packed segment.  Forward only; see the module
    docstring for the device rule.
    """
    h, h_kv = q.shape[2], k.shape[2]
    if h % h_kv != 0:
        raise ValueError(f"q heads {h} not a multiple of k/v heads {h_kv}")
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    out, _ = _flash_fwd(
        qt, kt, vt, segment_ids, segment_ids, causal=True, window=window,
        stream=stream, block_q=block_q, block_k=block_k,
    )
    return out.transpose(1, 2)
