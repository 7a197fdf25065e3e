"""Mixture-of-experts MLP with expert parallelism: the port of
``tpu_parallel/models/moe.py``.

``moe_top_k=1`` is Switch (gate = the raw router probability); above it
GShard (gates renormalised over the chosen experts), capacity claimed
choice-major.  The router runs in fp32, the experts in ``config.dtype``.

JAX builds one-hot ``[T, E, C]`` dispatch and combine masks
(:func:`_dispatch_masks`, kept here as the plain reference the tests hold
the module to) and contracts them with einsums.  At ``gpt2_moe_ep``'s
batch one fp32 mask is 21 GB, so the module computes the same dispatch by
INDEX (:func:`dispatch_slots`): each kept choice gets the slot ``e * C +
position`` (the position an exclusive cumsum over the tokens plus the
running count of the earlier choices, JAX's drop order exactly: choice-major,
tokens in row-major order), a dropped one the dump slot ``E * C``; the
tokens scatter into ``[E, C, d]`` and the combine gathers their ``k`` rows
back, weighted by the gates.  Nothing syncs with the host (no ``nonzero``,
``.item()`` or boolean-mask indexing), so the serving engine captures it
into its CUDA graphs.

Expert parallelism runs over the ``model`` axis of ``mesh``: a rank holds
``E / ep`` experts (``experts.up``/``experts.down`` kernels and biases,
stacked ``[E_local, ...]`` and tagged as dim-0 slices with
``tp.shard_module``, so the sync divides their gradients by ``ep`` as it
does tensor-parallel leaves').  Under ``moe_dispatch="dense"`` the tokens
are replicated over the axis: every rank routes all of them, runs its own
experts on their slots and the partial combines close with one
``tp_all_reduce`` (a custom op: remat replays it, ``tp_allreduce_launches``
counts it).  ``"alltoall"`` shards the tokens instead: a rank routes its
``T / ep`` tokens into a per-sender quota of ``C / ep`` slots, one
all-to-all each way moves the payloads (the custom op
``tpu_parallel_torch::ep_all_to_all``, counted in
:data:`ep_alltoall_launches`), and a packed ``tp_all_gather`` returns the
replicated ``[T, d]``; the balance statistics are averaged over the axis.

The load-balance loss ``E * sum_i f_i * P_i`` (0 under expert choice) is
RETURNED with the output, never
kept as module state: torch has no ``sow``, and a value recorded during
the forward would be recorded again when ``torch.utils.checkpoint``
recomputes the block.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from tpu_parallel_torch.parallel.tp import (all_gather, all_reduce, model_axis,
                                            shard_module)
from tpu_parallel_torch.runtime.comm import GROUPS, group_name

# all-to-alls launched over the model axis by the alltoall dispatch
# (forward, recompute and backward alike)
ep_alltoall_launches = 0


@torch.library.custom_op("tpu_parallel_torch::ep_all_to_all", mutates_args=())
def _ep_all_to_all_op(x: torch.Tensor, group: str, dispatch: bool) -> torch.Tensor:
    """``dispatch``: [E, C_s, d] -> [E_local, n * C_s, d] (each rank's
    experts, the senders' slot blocks in rank order); else the inverse."""
    global ep_alltoall_launches
    grp = GROUPS[group]
    n = dist.get_world_size(grp)
    if dispatch:
        e, cs, d = x.shape
        send = x.contiguous()  # block r along dim 0: rank r's experts
    else:
        el, ncs, d = x.shape
        cs = ncs // n
        send = x.reshape(el, n, cs, d).permute(1, 0, 2, 3).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=grp)
    ep_alltoall_launches += 1
    if dispatch:
        return recv.view(n, e // n, cs, d).permute(1, 0, 2, 3).reshape(e // n, n * cs, d)
    return recv.view(n * el, cs, d)


@_ep_all_to_all_op.register_fake
def _(x, group, dispatch):
    n = dist.get_world_size(GROUPS[group])
    a, b, d = x.shape
    if dispatch:
        return x.new_empty(a // n, n * b, d)
    return x.new_empty(a * n, b // n, d)


def _ep_all_to_all_setup(ctx, inputs, output):
    ctx.group, ctx.dispatch = inputs[1], inputs[2]


def _ep_all_to_all_backward(ctx, grad):
    return _ep_all_to_all_op(grad, ctx.group, not ctx.dispatch), None, None


_ep_all_to_all_op.register_autograd(_ep_all_to_all_backward, setup_context=_ep_all_to_all_setup)


def capacity_for(capacity_factor: float, top_k: int, tokens: int, n_experts: int) -> int:
    """Slots per expert, JAX's expression (not ``math.ceil``: the two
    differ when the fractional part is below 0.001)."""
    return max(1, int(capacity_factor * top_k * tokens / n_experts + 0.999))


def topk_choices(probs: torch.Tensor, top_k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(gates [T, k], experts [T, k])`` of top-k routing: Switch keeps the
    raw router probability at k = 1, GShard renormalises over the chosen
    experts above it.  A stable descending sort breaks ties toward the
    lower expert index, as ``lax.top_k`` does (``torch.topk`` promises no
    order among ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, experts = vals[:, :top_k], idx[:, :top_k]
    gates = gate_vals if top_k == 1 else gate_vals / gate_vals.sum(-1, keepdim=True)
    return gates, experts


def _topk_gates(probs: torch.Tensor, top_k: int) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """JAX's ``_topk_gates``: ``(gates [T, k], one-hots)``, one fp32 [T, E]
    one-hot per choice."""
    gates, experts = topk_choices(probs, top_k)
    n_experts = probs.shape[-1]
    return gates, [F.one_hot(experts[:, j], n_experts).float() for j in range(top_k)]


def _dispatch_masks(onehots: List[torch.Tensor], gates: torch.Tensor, n_experts: int,
                    capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """JAX's ``[T, E, C]`` dispatch/combine one-hots, as written: choices
    claim capacity slots choice-major, by a running per-expert count.  The
    plain reference of :func:`dispatch_slots` (tests and the card check)."""
    tokens = onehots[0].shape[0]
    count = torch.zeros(n_experts, dtype=torch.float32, device=gates.device)
    dispatch = torch.zeros(tokens, n_experts, capacity, dtype=torch.float32, device=gates.device)
    combine = torch.zeros_like(dispatch)
    for j, onehot in enumerate(onehots):
        position = (torch.cumsum(onehot, 0) - 1.0 + count[None, :]) * onehot
        in_capacity = (position < capacity).float() * onehot
        pos_idx = position.sum(-1).long()
        # one_hot of an index >= capacity is all zeros (jax.nn.one_hot)
        pos_onehot = (pos_idx[:, None] == torch.arange(capacity, device=gates.device)).float()
        dispatch_j = in_capacity[:, :, None] * pos_onehot[:, None, :]
        dispatch = dispatch + dispatch_j
        combine = combine + dispatch_j * gates[:, j, None, None]
        count = count + onehot.sum(0)
    return dispatch, combine


def dispatch_slots(experts: torch.Tensor, n_experts: int,
                   capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dispatch of :func:`_dispatch_masks` by index: ``(slots [T, k],
    kept [T, k])``.  Choice ``j`` of token ``t`` to expert ``e`` takes
    position ``#{t' < t: choice j of t' is e} + #{choices before j to e}``;
    it is kept while that is below ``capacity``, at slot ``e * capacity +
    position``, and a dropped one points at the dump slot ``n_experts *
    capacity``.  Integer cumsums, no host sync."""
    tokens, top_k = experts.shape
    count = torch.zeros(n_experts, dtype=torch.long, device=experts.device)
    slots, kept = [], []
    for j in range(top_k):
        e = experts[:, j]
        onehot = F.one_hot(e, n_experts)
        position = onehot.cumsum(0).gather(1, e[:, None])[:, 0] - 1 + count[e]
        keep = position < capacity
        slots.append(torch.where(keep, e * capacity + position,
                                 torch.full_like(e, n_experts * capacity)))
        kept.append(keep)
        count = count + onehot.sum(0)
    return torch.stack(slots, 1), torch.stack(kept, 1)


def _local_slots(slots: torch.Tensor, kept: torch.Tensor, first: int, local: int,
                 capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's view of the dispatch: slots of experts ``[first, first +
    local)`` shifted to the local stack, every other choice to the local
    dump slot ``local * capacity``."""
    shifted = slots - first * capacity
    mine = kept & (shifted >= 0) & (shifted < local * capacity)
    return torch.where(mine, shifted, torch.full_like(slots, local * capacity)), mine


def _scatter_tokens(xf: torch.Tensor, slots: torch.Tensor, n_slots: int) -> torch.Tensor:
    """``[n_slots, d]``: row ``s`` holds the token whose choice took slot
    ``s`` (zeros where none did); choices at the dump slot ``n_slots`` are
    dropped.  The einsum ``td,tec->ecd`` of one-hot masks, exactly."""
    t, k = slots.shape
    buf = xf.new_zeros(n_slots + 1, xf.shape[-1])
    rows = xf[:, None, :].expand(t, k, xf.shape[-1]).reshape(t * k, -1)
    return buf.index_put((slots.reshape(-1),), rows)[:n_slots]


def _gather_tokens(y_slots: torch.Tensor, slots: torch.Tensor,
                   weights: torch.Tensor) -> torch.Tensor:
    """``[T, d]`` fp32: each token's slot rows, weighted by ``weights``
    [T, k] and summed (the einsum ``ecd,tec->td`` against the combine
    mask); the dump slot reads zeros."""
    flat = torch.cat([y_slots.reshape(-1, y_slots.shape[-1]).float(),
                      y_slots.new_zeros(1, y_slots.shape[-1], dtype=torch.float32)])
    return (flat[slots] * weights[..., None]).sum(1)


class _ExpertDense(nn.Module):
    """``n`` stacked dense layers: ``kernel`` [n, in, out] (flax's layout,
    one ``baddbmm`` per call, or ``bmm`` without a bias) and ``bias`` [n,
    out], in ``dtype``."""

    def __init__(self, n: int, in_features: int, out_features: int, dtype, device,
                 bias: bool = True):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(n, in_features, out_features, dtype=dtype,
                                               device=device))
        self.bias = nn.Parameter(torch.zeros(n, out_features, dtype=dtype, device=device)) \
            if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.bias is None:
            return torch.bmm(x, self.kernel)
        return torch.baddbmm(self.bias[:, None, :], x, self.kernel)


class ExpertFFN(nn.Module):
    """``E_local`` experts, each the transformer FFN ``down(gelu(up(x)))``
    (gelu's tanh form), or under ``mlp="swiglu"`` ``down(silu(gate(x)) *
    up(x))`` with bias-free ``gate`` and ``up``, as JAX's ``ExpertFFN``
    (every other ``config.mlp`` takes the gelu form there too), on
    ``[E_local, C, d]``.  The products run inside the ``"proj"`` scope,
    so ``"proj"`` and ``"proj_attn"`` keep them as the dense MLP's."""

    def __init__(self, config, n_experts: int, device=None):
        super().__init__()
        hidden = config.mlp_ratio * config.d_model
        self.swiglu = config.mlp == "swiglu"
        if self.swiglu:
            self.gate = _ExpertDense(n_experts, config.d_model, hidden, config.dtype, device,
                                     bias=False)
        self.up = _ExpertDense(n_experts, config.d_model, hidden, config.dtype, device,
                               bias=not self.swiglu)
        self.down = _ExpertDense(n_experts, hidden, config.d_model, config.dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        from tpu_parallel_torch.models.layers import checkpoint_name  # layers imports this module

        if self.swiglu:
            with checkpoint_name("proj"):
                gate = self.gate(x)
                up = self.up(x)
            h = F.silu(gate) * up
        else:
            with checkpoint_name("proj"):
                h = self.up(x)
            h = F.gelu(h, approximate="tanh")
        with checkpoint_name("proj"):
            return self.down(h)


class MoEMLP(nn.Module):
    """The drop-in MLP of an MoE block: ``forward(x [B, S, d]) -> (y [B, S,
    d], balance)``, ``balance`` the fp32 load-balance value of this call.
    ``router`` is an fp32 ``Linear``
    without bias; ``experts`` holds this rank's ``E / ep`` experts on
    ``mesh``'s model axis (all of them without one).  JAX's errors: experts
    the model axis does not divide, and expert choice with the all-to-all
    dispatch."""

    def __init__(self, config, device=None, mesh=None):
        super().__init__()
        self.config = config
        self.mesh = mesh
        n_experts = config.moe_experts
        bound = model_axis(mesh, config.model_axis)
        self.ep = 1 if bound is None else bound[1]
        self.rank = 0 if bound is None else bound[2]
        if n_experts % self.ep != 0:
            raise ValueError(f"moe_experts={n_experts} not divisible by model axis {self.ep}")
        if config.moe_dispatch == "alltoall" and config.moe_router == "expert_choice":
            raise NotImplementedError(
                "expert_choice routing needs the dense dispatch (each "
                "expert takes its global top-capacity tokens; a sharded "
                "token set cannot rank them locally)"
            )
        self.local_experts = n_experts // self.ep
        self.router = nn.Linear(config.d_model, n_experts, bias=False, dtype=torch.float32,
                                device=device)
        self.experts = ExpertFFN(config, self.local_experts, device)
        for dense in self.experts.children():
            shard_module(dense, {n: 0 for n in ("kernel", "bias") if getattr(dense, n) is not None},
                         config.model_axis, mesh)

    def forward(self, x: torch.Tensor, dropout_gen: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.config
        b, s, d = x.shape
        xf = x.reshape(b * s, d)
        if cfg.moe_dispatch == "alltoall" and cfg.moe_router == "topk" and self.ep > 1:
            # ep == 1 falls through to the dense path: no axis to exchange over
            y, balance = self._topk_alltoall(xf)
        else:
            probs = torch.softmax(F.linear(xf.float(), self.router.weight), dim=-1)
            if cfg.moe_router == "expert_choice":
                y, balance = self._expert_choice(xf, probs)
            else:
                y, balance = self._topk_dense(xf, probs)
        y = y.to(cfg.dtype).reshape(b, s, d)
        if dropout_gen is not None:
            from tpu_parallel_torch.models.layers import dropout

            y = dropout(y, cfg.dropout_rate, dropout_gen)
        return y, balance

    def _balance(self, experts: torch.Tensor, probs: torch.Tensor, mean_over_axis: bool):
        """``E * sum(f_i * P_i)``: ``f_i`` the share of (token, choice)
        assignments to expert ``i``, ``P_i`` its mean router probability;
        under the all-to-all both are averaged over the model axis (one
        packed all-reduce), which gives the dense path's global
        statistics."""
        n_experts = probs.shape[-1]
        frac = F.one_hot(experts, n_experts).float().mean(0).sum(0) / experts.shape[1]
        mean_probs = probs.mean(0)
        if mean_over_axis:
            both = all_reduce(torch.cat([frac, mean_probs]), self.config.model_axis,
                              self.mesh) / self.ep
            frac, mean_probs = both[:n_experts], both[n_experts:]
        return n_experts * (frac * mean_probs).sum()

    def _topk_dense(self, xf, probs):
        cfg = self.config
        tokens = xf.shape[0]
        gates, experts = topk_choices(probs, cfg.moe_top_k)
        balance = self._balance(experts, probs, False)
        capacity = capacity_for(cfg.moe_capacity_factor, cfg.moe_top_k, tokens, cfg.moe_experts)
        slots, kept = dispatch_slots(experts, cfg.moe_experts, capacity)
        return self._apply_experts(xf, slots, kept, gates, capacity), balance

    def _apply_experts(self, xf, slots, kept, gates, capacity):
        """The shared tail: this rank's experts on their slots, the partial
        combine, one all-reduce over the model axis (none without one)."""
        local = self.local_experts
        slots, mine = _local_slots(slots, kept, self.rank * local, local, capacity)
        x_exp = _scatter_tokens(xf, slots, local * capacity).view(local, capacity, -1)
        y_exp = self.experts(x_exp)
        y = _gather_tokens(y_exp, slots, gates * mine)
        return all_reduce(y, self.config.model_axis, self.mesh)

    def _expert_choice(self, xf, probs):
        """Expert-choice routing: each expert takes its top-``capacity``
        tokens by router probability (ties toward the lower token index, as
        ``lax.top_k``); no balance loss (a zero is returned)."""
        cfg = self.config
        tokens = xf.shape[0]
        capacity = max(1, int(cfg.moe_capacity_factor * tokens / cfg.moe_experts + 0.999))
        if capacity > tokens:
            raise ValueError(
                f"expert capacity {capacity} > {tokens} tokens — lower "
                "moe_capacity_factor or use more tokens per batch"
            )
        first = self.rank * self.local_experts
        mine = probs.t()[first:first + self.local_experts]  # [E_local, T]
        vals, idx = torch.sort(mine, dim=-1, descending=True, stable=True)
        gates, idx = vals[:, :capacity], idx[:, :capacity]
        y_exp = self.experts(xf[idx])  # [E_local, C, d]
        y = xf.new_zeros(tokens, xf.shape[-1], dtype=torch.float32)
        for e in range(self.local_experts):
            # an expert's picks are distinct tokens: no colliding adds
            y = y.index_add(0, idx[e], y_exp[e].float() * gates[e][:, None])
        y = all_reduce(y, cfg.model_axis, self.mesh)
        return y, torch.zeros((), dtype=torch.float32, device=xf.device)

    def _topk_alltoall(self, xf):
        """Sharded-token dispatch: this rank routes its ``T / ep`` tokens
        into a per-sender quota of ``C / ep`` slots per expert, exchanges
        the payloads with one all-to-all each way and all-gathers the
        combined tokens.  The same result as the dense path while nothing
        overflows; different drop choices under pressure."""
        cfg = self.config
        tokens, d = xf.shape
        if tokens % self.ep:
            raise ValueError(
                f"tokens={tokens} not divisible by EP axis size {self.ep} "
                "(alltoall dispatch shards the token set)"
            )
        t_local = tokens // self.ep
        xs = xf[self.rank * t_local:(self.rank + 1) * t_local]
        probs = torch.softmax(F.linear(xs.float(), self.router.weight), dim=-1)
        gates, experts = topk_choices(probs, cfg.moe_top_k)
        balance = self._balance(experts, probs, True)
        cap = capacity_for(cfg.moe_capacity_factor, cfg.moe_top_k, t_local, cfg.moe_experts)
        slots, kept = dispatch_slots(experts, cfg.moe_experts, cap)
        x_send = _scatter_tokens(xs, slots, cfg.moe_experts * cap).view(cfg.moe_experts, cap, d)
        group = group_name(model_axis(self.mesh, cfg.model_axis)[0])
        x_recv = _ep_all_to_all_op(x_send, group, True)  # [E_local, ep * cap, d]
        y_exp = self.experts(x_recv)
        y_back = _ep_all_to_all_op(y_exp, group, False)  # [E, cap, d]
        ys = _gather_tokens(y_back, slots, gates * kept)  # [T / ep, d]
        # the replicated [T, d] the trunk expects: a tiled gather of rows
        y = all_gather(ys.t().contiguous(), cfg.model_axis, self.mesh).t()
        return y, balance

