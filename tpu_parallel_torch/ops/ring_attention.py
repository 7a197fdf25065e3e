"""Ring attention: causal attention with the sequence sharded over a mesh
axis, the port of ``tpu_parallel/ops/ring_attention.py``.

Each rank of the seq axis holds a contiguous chunk of Q, K and V
([batch, seq / n, heads, head_dim]); K/V chunks (and their segment ids)
rotate around the ring, rank ``r`` sending to ``r + 1``, while each rank's
queries accumulate attention over every chunk with an online softmax.
Chunk ``c`` is fully visible to query chunk ``r`` when ``c < r``,
diagonally masked when ``c == r`` and invisible when ``c > r``.

JAX runs every rank in lockstep under ``shard_map`` (``lax.ppermute``,
``lax.cond`` / ``lax.switch`` on the rank); here each rank is its own
process, so the branch on (this rank, the held chunk) is a Python branch
on two integers, and the exchanges are point-to-point pairs posted
together (``runtime/comm.py:post_exchange``, staged through the host over
gloo).  Each send adds one to :data:`sp_ring_send_launches`, each receive
one to :data:`sp_ring_recv_launches`.

- :func:`ring_attention` is the plain online-softmax ring (fp32 scores per
  chunk pair), differentiable through its exchanges (a custom op whose
  backward shifts the cotangent the other way).  It is the ring of a CPU
  tensor, and the reference.
- :func:`ring_flash_attention` runs each ring step as one
  :func:`~tpu_parallel_torch.ops.flash_attention.flash_chunk_attention`
  call and merges the partials with :func:`combine_chunks`: the diagonal
  chunk causal, past chunks with the full kernel, future chunks skipped
  (no kernel); under a window each back-distance ``j`` runs at the static
  ``q_offset = j * local_seq`` and chunks the window misses are skipped;
  the bidirectional ring runs the symmetric band with signed offsets.  The
  forward is one custom op (``tpu_parallel_torch::ring_flash_fwd``) on
  detached inputs, so a remat policy that keeps ``"attn"`` keeps its
  output and the recompute neither exchanges nor launches; the backward
  (:class:`_RingFinalize`) walks the ring again: each held chunk's backward
  kernel runs against the final ``(out, lse)`` (what the chunk partials'
  ``(w_c * do, dlse_c)`` cotangents reduce to, so no partial is kept), dq
  stays local, and the chunk's dk and dv accumulate in a buffer that
  travels with its K and V, in their dtype, until one last hop takes it
  home.  The forward skips JAX's rotation after the last step: K/V are
  not needed back home.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from tpu_parallel_torch.ops.flash_attention import (_flash_bwd, _rows_readable,
                                                    flash_chunk_attention)
from tpu_parallel_torch.runtime.comm import GROUPS, group_name, post_exchange
from tpu_parallel_torch.runtime.mesh import axis_group

NEG_INF = -1e30

# point-to-point operations of the rings (forward, recompute and backward
# alike), by direction
sp_ring_send_launches = 0
sp_ring_recv_launches = 0


def _ring_group(mesh, axis_name: str) -> str:
    """The registered name of ``axis_name``'s group (``""`` when the mesh
    does not bind it: a ring of one)."""
    bound = axis_group(mesh, axis_name)
    return "" if bound is None else group_name(bound[0])


def _ring_coords(group: str) -> Tuple[int, int]:
    """``(size, this rank's coordinate)`` of a ring named by
    :func:`_ring_group`."""
    if not group:
        return 1, 0
    grp = GROUPS[group]
    return dist.get_world_size(grp), dist.get_rank(grp)


def _rotate(group: str, tensors: List[Optional[torch.Tensor]], step: int = 1
            ) -> List[Optional[torch.Tensor]]:
    """Send each tensor to coordinate ``+step`` and receive its twin from
    ``-step`` (one round of paired point-to-point ops); None passes
    through."""
    global sp_ring_send_launches, sp_ring_recv_launches
    n, my = _ring_coords(group)
    live = [t for t in tensors if t is not None]
    if n == 1 or not live:
        return list(tensors)
    got = [torch.empty(t.shape, dtype=t.dtype, device=t.device) for t in live]
    post_exchange(GROUPS[group], [(t, (my + step) % n) for t in live],
                  [(g, (my - step) % n) for g in got])
    sp_ring_send_launches += len(live)
    sp_ring_recv_launches += len(live)
    it = iter(got)
    return [None if t is None else next(it) for t in tensors]


@torch.library.custom_op("tpu_parallel_torch::sp_ring_shift", mutates_args=())
def _ring_shift_op(x: torch.Tensor, group: str, step: int) -> torch.Tensor:
    """``x`` of coordinate ``-step`` (this rank's goes to ``+step``)."""
    return _rotate(group, [x.contiguous()], step)[0].clone()


@_ring_shift_op.register_fake
def _(x, group, step):
    return torch.empty_like(x, memory_format=torch.contiguous_format)


def _ring_shift_setup(ctx, inputs, output):
    ctx.group, ctx.step = inputs[1], inputs[2]


def _ring_shift_backward(ctx, grad):
    # a ppermute transposes to the inverse permutation
    return _ring_shift_op(grad, ctx.group, -ctx.step), None, None


_ring_shift_op.register_autograd(_ring_shift_backward, setup_context=_ring_shift_setup)


def _scale(q: torch.Tensor) -> torch.Tensor:
    """1/sqrt(head_dim) in q's dtype, as JAX's rings scale q."""
    return torch.tensor(1.0 / q.shape[-1] ** 0.5, dtype=q.dtype)


def ring_attention(q, k, v, *, axis_name: str = "seq", mesh=None, use_checkpoint: bool = True,
                   window: int = 0, segment_ids=None, causal: bool = True) -> torch.Tensor:
    """Ring attention on seq-sharded [batch, local_seq, heads, head_dim]
    (causal by default; ``causal=False`` is the bidirectional form).

    Returns the local output chunk.  ``mesh`` binds ``axis_name`` (an
    unbound axis is a ring of one).  ``use_checkpoint`` recomputes each
    step's scores in the backward instead of keeping them.  ``window > 0``
    masks by global position: causal, keys at most ``window - 1`` behind;
    bidirectional, the symmetric band ``|q - k| < window``.
    ``segment_ids`` (the local chunk's [batch, local_seq]) mask packed
    sequences; they rotate with their K/V chunk.  GQA K/V stay at kv-head
    width on the ring.
    """
    group = _ring_group(mesh, axis_name)
    n, my = _ring_coords(group)
    b, local_s, h, d = q.shape
    h_kv = k.shape[2]
    if h % h_kv != 0:
        raise ValueError(f"q heads {h} not a multiple of k/v heads {h_kv}")
    g = h // h_kv
    qf = (q * _scale(q)).permute(0, 2, 1, 3).reshape(b, h_kv, g, local_s, d).float()
    seg_local = None if segment_ids is None else segment_ids.to(torch.int32)
    idx = torch.arange(local_s, device=q.device)

    def combine(out, m_prev, l_prev, k_cur, v_cur, seg_cur, src):
        s = torch.einsum("bngqd,bnkd->bngqk", qf, k_cur.transpose(1, 2).float())
        q_pos = (my * local_s + idx)[:, None]
        k_pos = (src * local_s + idx)[None, :]
        mask = q_pos >= k_pos if causal else torch.ones_like(q_pos >= k_pos)
        if window:
            near = q_pos - k_pos < window
            if not causal:
                near = near & (k_pos - q_pos < window)
            mask = mask & near
        mask = mask[None, None, None]
        if seg_cur is not None:
            mask = mask & (seg_local[:, None, None, :, None] == seg_cur[:, None, None, None, :])
        s = torch.where(mask, s, torch.full((), NEG_INF, device=s.device))
        m_new = torch.maximum(m_prev, s.amax(-1, keepdim=True))
        # a fully masked row keeps m == NEG_INF: zero its entries explicitly
        p = torch.where(mask, torch.exp(s - m_new), torch.zeros((), device=s.device))
        alpha = torch.exp(m_prev - m_new)
        l_new = l_prev * alpha + p.sum(-1, keepdim=True)
        pv = torch.einsum("bngqk,bnkd->bngqd", p.to(v_cur.dtype).float(),
                          v_cur.transpose(1, 2).float())
        return out * alpha + pv, m_new, l_new

    checkpointed = use_checkpoint and torch.is_grad_enabled()
    out = torch.zeros(b, h_kv, g, local_s, d, device=q.device)
    m = torch.full((b, h_kv, g, local_s, 1), NEG_INF, device=q.device)
    l = torch.zeros(b, h_kv, g, local_s, 1, device=q.device)
    k_cur, v_cur, seg_cur, src = k, v, seg_local, my
    for t in range(n):
        if checkpointed:
            from torch.utils.checkpoint import checkpoint

            out, m, l = checkpoint(combine, out, m, l, k_cur, v_cur, seg_cur, src,
                                   use_reentrant=False)
        else:
            out, m, l = combine(out, m, l, k_cur, v_cur, seg_cur, src)
        if t < n - 1:
            k_cur, v_cur = (_ring_shift_op(x, group, 1) for x in (k_cur, v_cur))
            if seg_cur is not None:
                seg_cur = _ring_shift_op(seg_cur, group, 1)
            src = (src - 1) % n
    out = out / l.clamp(min=1e-20)
    return out.reshape(b, h, local_s, d).permute(0, 2, 1, 3).to(q.dtype)


def combine_chunks(out_a, lse_a, out_b, lse_b):
    """Exactly merge two attention partials (chunk-normalized out + lse).

    ``out``: [batch, seq, heads, head_dim] fp32; ``lse``: [batch, heads,
    seq].  An empty partial is ``lse <= NEG_INF / 2`` with out zeros; its
    weight underflows to exactly 0, and a row empty in both stays empty.
    """
    m = torch.maximum(lse_a, lse_b)
    empty = m <= NEG_INF / 2
    m_safe = torch.where(empty, torch.zeros_like(m), m)
    e_a, e_b = torch.exp(lse_a - m_safe), torch.exp(lse_b - m_safe)
    w_a = e_a.transpose(1, 2)[..., None]
    w_b = e_b.transpose(1, 2)[..., None]
    # each partial is normalized within its chunk, so the merge renormalizes
    out = (out_a * w_a + out_b * w_b) / (w_a + w_b).clamp(min=1e-38)
    total = e_a + e_b
    lse = m_safe + torch.log(torch.where(empty, torch.ones_like(total), total))
    return out, torch.where(empty, torch.full_like(lse, NEG_INF), lse)


def _chunk_band(j: int, local_s: int, n: int, causal: bool, window: int):
    """How query chunk ``my`` attends the chunk ``j = my - src`` ranks
    behind it (``j < 0``: ahead): ``(causal, window, q_offset)`` of its
    :func:`flash_chunk_attention` call, or None when it contributes an
    empty partial (no kernel).  JAX's ``ring_flash_attention`` branches."""
    if not window:
        if not causal:
            return False, 0, 0
        if j == 0:
            return True, 0, 0
        return (False, 0, 0) if j > 0 else None
    # chunk j's closest (q, k) pair sits (|j| - 1) * local_s + 1 apart
    max_back = min(n - 1, -(-(window - 1) // local_s))
    if causal and j == 0:
        return True, window, 0
    if (causal and not 0 < j <= max_back) or abs(j) > max_back:
        return None
    offset = j * local_s
    if abs(offset) + local_s - 1 < window:  # every pair inside the band
        return False, 0, 0
    return False, window, offset


@torch.library.custom_op("tpu_parallel_torch::ring_flash_fwd", mutates_args=())
def _ring_flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       seg: Optional[torch.Tensor], group: str, causal: bool,
                       window: int) -> Tuple[torch.Tensor, torch.Tensor]:
    n, my = _ring_coords(group)
    b, local_s, h, d = q.shape
    out = torch.zeros(b, local_s, h, d, dtype=torch.float32, device=q.device)
    lse = torch.full((b, h, local_s), NEG_INF, dtype=torch.float32, device=q.device)
    # K and V travel as one buffer: one send per hop
    kv, seg_cur = torch.stack([k, v]), seg
    for t in range(n):
        band = _chunk_band(t if t <= my else t - n, local_s, n, causal, window)
        if band is not None:
            c, w, off = band
            kw = {} if seg is None else dict(segment_ids_q=seg, segment_ids_kv=seg_cur)
            o, s = flash_chunk_attention(q, kv[0], kv[1], causal=c, window=w, q_offset=off,
                                         **kw)
            out, lse = combine_chunks(out, lse, o.float(), s)
        if t < n - 1:
            kv, seg_cur = _rotate(group, [kv, seg_cur])
    return out.to(q.dtype), lse


@_ring_flash_fwd_op.register_fake
def _(q, k, v, seg, group, causal, window):
    b, s, h, _ = q.shape
    return torch.empty_like(q, memory_format=torch.contiguous_format), q.new_empty(
        (b, h, s), dtype=torch.float32)


RING_FLASH_FWD_OP = torch.ops.tpu_parallel_torch.ring_flash_fwd.default


class _RingFinalize(torch.autograd.Function):
    """Identity on the ring's ``out`` that attaches the ring's backward."""

    @staticmethod
    def forward(ctx, q, k, v, seg, out, lse, group, causal, window):
        ctx.save_for_backward(q, k, v, seg, out, lse)
        ctx.ring = (group, causal, window)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, seg, out, lse = ctx.saved_tensors
        group, causal, window = ctx.ring
        n, my = _ring_coords(group)
        local_s = q.shape[1]
        if _rows_readable(do.transpose(1, 2)) is not None:
            do = do.contiguous()
        qt, out_t, do_t = (x.transpose(1, 2) for x in (q, out, do))
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        # the held chunk: K, V and the dk, dv summed so far, one buffer
        held = torch.zeros((4, *k.shape), dtype=k.dtype, device=k.device)
        held[0], held[1] = k, v
        seg_cur = seg
        for t in range(n):
            band = _chunk_band(t if t <= my else t - n, local_s, n, causal, window)
            if band is not None:
                c, w, off = band
                dq_c, dk_c, dv_c = _flash_bwd(
                    qt, held[0].transpose(1, 2), held[1].transpose(1, 2), seg, seg_cur, out_t,
                    lse, do_t, causal=c, window=w, q_offset=off)
                dq += dq_c.transpose(1, 2)
                held[2] += dk_c.transpose(1, 2)
                held[3] += dv_c.transpose(1, 2)
            if t < n - 1:
                held, seg_cur = _rotate(group, [held, seg_cur])
        # the last hop takes each chunk's dk, dv home
        (home,) = _rotate(group, [held[2:]])
        return dq.to(q.dtype), home[0], home[1], None, None, None, None, None, None


def ring_flash_attention(q, k, v, *, axis_name: str = "seq", mesh=None, block_q: int = 512,
                         block_k: int = 512, interpret=None, use_checkpoint: bool = True,
                         window: int = 0, segment_ids=None, causal: bool = True) -> torch.Tensor:
    """Ring attention with the per-chunk math on the flash kernels.

    Same contract as :func:`ring_attention`.  ``block_q``/``block_k``,
    ``interpret`` and ``use_checkpoint`` are the JAX signature's: the
    kernels use their own tiles, and the backward walks the ring again
    (nothing of a rotated chunk is kept), as JAX's per-step remat does.
    """
    del block_q, block_k, interpret, use_checkpoint
    if q.shape[2] % k.shape[2] != 0:
        raise ValueError(f"q heads {q.shape[2]} not a multiple of k/v heads {k.shape[2]}")
    group = _ring_group(mesh, axis_name)
    seg = None if segment_ids is None else segment_ids.to(torch.int32).contiguous()
    out, lse = _ring_flash_fwd_op(q.detach(), k.detach(), v.detach(), seg, group, causal,
                                  window)
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))):
        return out
    return _RingFinalize.apply(q, k, v, seg, out, lse, group, causal, window)
