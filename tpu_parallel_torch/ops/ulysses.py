"""Ulysses (DeepSpeed-style) sequence parallelism: all-to-all head
resharding, the port of ``tpu_parallel/ops/ulysses.py``.

Where ring attention keeps the sequence sharded and rotates K/V, Ulysses
pays two all-to-alls instead: gather the whole sequence while scattering
the heads, run ordinary flash attention on ``heads / n`` heads, then
reshard back.  Requires ``n_heads % n == 0``.  GQA K/V pass at kv-head
width: when ``n_kv_heads % n == 0`` they reshard as they are (the q -> kv
routing holds shard-locally), otherwise the op expands them to full width.

The all-to-all is a custom op (``tpu_parallel_torch::sp_all_to_all``)
whose backward is the inverse all-to-all, so a remat policy can keep its
output and a recompute that does not replays it in the same order on
every rank; each one adds one to :data:`sp_alltoall_launches`.  It is one
``all_to_all_single`` on the seq axis's group, gloo or NCCL alike.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from tpu_parallel_torch.ops.flash_attention import flash_attention
from tpu_parallel_torch.runtime.comm import GROUPS, group_name
from tpu_parallel_torch.runtime.mesh import axis_group

# all-to-alls launched over the seq axis (forward, recompute and backward)
sp_alltoall_launches = 0


@torch.library.custom_op("tpu_parallel_torch::sp_all_to_all", mutates_args=())
def _all_to_all_op(x: torch.Tensor, group: str, gather_seq: bool) -> torch.Tensor:
    """``gather_seq``: [B, s/n, H, D] -> [B, s, H/n, D] (the sequence
    chunks in rank order, this rank's head group); else the inverse."""
    global sp_alltoall_launches
    grp = GROUPS[group]
    n = dist.get_world_size(grp)
    if gather_seq:
        b, sl, h, d = x.shape
        send = x.reshape(b, sl, n, h // n, d).permute(2, 0, 1, 3, 4).contiguous()
    else:
        b, s, hl, d = x.shape
        send = x.reshape(b, n, s // n, hl, d).permute(1, 0, 2, 3, 4).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=grp)
    sp_alltoall_launches += 1
    # recv[i] came from coordinate i: its sequence chunk, or its head group
    if gather_seq:
        return recv.permute(1, 0, 2, 3, 4).reshape(b, n * sl, h // n, d).contiguous()
    return recv.permute(1, 2, 0, 3, 4).reshape(b, s // n, n * hl, d).contiguous()


@_all_to_all_op.register_fake
def _(x, group, gather_seq):
    n = dist.get_world_size(GROUPS[group])
    b, s, h, d = x.shape
    if gather_seq:
        return x.new_empty(b, s * n, h // n, d)
    return x.new_empty(b, s // n, h * n, d)


def _all_to_all_setup(ctx, inputs, output):
    ctx.group, ctx.gather_seq = inputs[1], inputs[2]


def _all_to_all_backward(ctx, grad):
    return _all_to_all_op(grad, ctx.group, not ctx.gather_seq), None, None


_all_to_all_op.register_autograd(_all_to_all_backward, setup_context=_all_to_all_setup)


@torch.library.custom_op("tpu_parallel_torch::sp_all_gather_seq", mutates_args=())
def _all_gather_seq_op(x: torch.Tensor, group: str) -> torch.Tensor:
    """[B, s/n] of every coordinate -> [B, s] in rank order (segment ids:
    no gradient)."""
    grp = GROUPS[group]
    n = dist.get_world_size(grp)
    out = torch.empty(n * x.numel(), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x.contiguous().view(-1), group=grp)
    b, sl = x.shape
    return out.view(n, b, sl).permute(1, 0, 2).reshape(b, n * sl).contiguous()


@_all_gather_seq_op.register_fake
def _(x, group):
    return x.new_empty(x.shape[0], x.shape[1] * dist.get_world_size(GROUPS[group]))


def gather_sequence(x: torch.Tensor, axis_name: str = "seq", mesh=None) -> torch.Tensor:
    """The whole sequence's [batch, seq] of a seq-sharded [batch, seq / n]
    (``lax.all_gather(..., axis=1, tiled=True)``); identity on an unbound
    axis."""
    bound = axis_group(mesh, axis_name)
    if bound is None or bound[1] == 1:
        return x
    return _all_gather_seq_op(x, group_name(bound[0]))


def ulysses_attention(q, k, v, *, axis_name: str = "seq", mesh=None,
                      attn_fn: Optional[Callable] = None, segment_ids=None) -> torch.Tensor:
    """Attention on seq-sharded [batch, local_seq, heads, head_dim].

    ``mesh`` binds ``axis_name`` (unbound: one rank, no exchange).  The
    inner ``attn_fn`` (default :func:`flash_attention`) sees [batch,
    full_seq, heads / n, head_dim], the contiguous global sequence, so
    plain causal masking is right; ``segment_ids`` are passed to it as
    given (the whole sequence's ids).
    """
    bound = axis_group(mesh, axis_name)
    n = 1 if bound is None else bound[1]
    h, h_kv = q.shape[2], k.shape[2]
    if h % n != 0:
        raise ValueError(f"n_heads={h} not divisible by seq axis size {n}")
    if h_kv != h:
        if h % h_kv != 0:
            raise ValueError(f"q heads {h} not a multiple of k/v heads {h_kv}")
        if h_kv % n != 0:
            # kv heads that do not split over the axis: expand to full width
            k = k.repeat_interleave(h // h_kv, dim=2)
            v = v.repeat_interleave(h // h_kv, dim=2)
    if attn_fn is None:
        attn_fn = flash_attention
    if n == 1:
        return attn_fn(q, k, v, segment_ids=segment_ids)
    group = group_name(bound[0])
    q, k, v = (_all_to_all_op(x, group, True) for x in (q, k, v))
    out = attn_fn(q, k, v, segment_ids=segment_ids)
    return _all_to_all_op(out, group, False)
