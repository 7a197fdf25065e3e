"""Optimizer transformations: the port of ``tpu_parallel/core/optim.py``
(the sharding-aware global-norm clip) and of the optax pieces the trainer
chains (``adamw``, ``lion``, ``add_decayed_weights`` and ``sgd`` with
momentum).

Each transformation works on dicts of fp32 tensors keyed by parameter name,
as optax's do on pytrees: ``init(params) -> state`` and ``update(updates,
state, params) -> (updates, state)``.  ``update`` rewrites ``updates`` in
place (multi-tensor ``torch._foreach_*`` ops) and returns it.  A leaf of
``updates`` may be a ``DTensor`` shard (FSDP): the clip's norm reads its
placement, and every transformation works on its local tensor, so the
state it keeps holds each rank's slices.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.distributed as dist

Tree = Dict[str, torch.Tensor]


def _sharded_dims(leaf):
    """The mesh dims a ``DTensor`` leaf is sharded over (() for a plain
    tensor or a replicated ``DTensor``)."""
    from tpu_parallel_torch.parallel.fsdp import is_shard_placement

    placements = getattr(leaf, "placements", None)
    if placements is None:
        return ()
    return tuple(i for i, p in enumerate(placements) if is_shard_placement(p))


def _local(leaf) -> torch.Tensor:
    return leaf.to_local() if hasattr(leaf, "to_local") else leaf


def global_norm_sharded(tree: Tree) -> torch.Tensor:
    """Global L2 norm (fp32, on the tensors' device) of a gradient tree
    whose leaves may be ``DTensor`` shards: each sharded leaf's local sum
    of squares is all-reduced over exactly the mesh dims it is sharded on
    (one ``all_reduce`` per such set of dims and dim), a stage-owned leaf's
    (``parallel/pp.py``'s tag) over its pipe axis too, and a plain or
    replicated leaf counts once, so the total is bitwise equal on every
    rank.  Without shards or stages, no collective runs."""
    from tpu_parallel_torch.parallel.pp import stage_info

    by_dims: Dict[tuple, list] = {}
    for leaf in tree.values():
        info = stage_info(leaf)
        key = (_sharded_dims(leaf), "" if info is None else info.axis)
        by_dims.setdefault(key, []).append(leaf)
    total = None
    for (dims, stage_axis), leaves in sorted(by_dims.items()):
        sq = torch.stack(torch._foreach_norm([_local(g) for g in leaves])).square().sum()
        for d in dims:
            dist.all_reduce(sq, group=leaves[0].device_mesh.get_group(d))
        if stage_axis:
            dist.all_reduce(sq, group=stage_info(leaves[0]).group)
        total = sq if total is None else total + sq
    return total.sqrt()


class ClipByGlobalNormSharded:
    """``clip_by_global_norm_sharded`` (optax's ``clip_by_global_norm`` on
    sharded gradients): scale every update by min(1, max_norm / max(norm,
    1e-9)) with the norm of :func:`global_norm_sharded`, so every rank
    scales its shards by the same factor.  Not ``clip_grad_norm_``, which
    divides by norm + 1e-6.  The trainer's clip (``make_optimizer``)."""

    def __init__(self, max_norm: float):
        self.max_norm = max_norm

    def init(self, params: Tree):
        return None

    def update(self, updates: Tree, state, params: Tree = None):
        norm = global_norm_sharded(updates)
        scale = torch.clamp(self.max_norm / torch.clamp(norm, min=1e-9), max=1.0)
        torch._foreach_mul_([_local(g) for g in updates.values()], scale)
        return updates, state


class AdamW:
    """``optax.adamw(schedule, b1, b2, eps, weight_decay=...)`` with decay on
    every tensor: u = -lr(count) * (m_hat / (sqrt(v_hat) + eps) + wd * p),
    with m, v the moment EMAs and hats their bias corrections at count + 1;
    ``schedule`` is read at the count before the step, as optax does."""

    def __init__(self, schedule: Callable[[int], float], b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 1e-4):
        self.schedule, self.b1, self.b2, self.eps = schedule, b1, b2, eps
        self.weight_decay = weight_decay

    def init(self, params: Tree):
        zeros = lambda: {k: torch.zeros_like(p) for k, p in params.items()}
        return dict(count=0, mu=zeros(), nu=zeros())

    def update(self, updates: Tree, state, params: Tree):
        names = list(updates)
        g = [_local(updates[n]) for n in names]
        mu = [state["mu"][n] for n in names]
        nu = [state["nu"][n] for n in names]
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, g, alpha=1 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, g, g, value=1 - self.b2)
        count = state["count"] + 1
        mu_hat = torch._foreach_div(mu, 1 - self.b1**count)
        denom = torch._foreach_sqrt(torch._foreach_div(nu, 1 - self.b2**count))
        torch._foreach_add_(denom, self.eps)
        step = torch._foreach_div(mu_hat, denom)
        if self.weight_decay:
            torch._foreach_add_(step, [params[n] for n in names], alpha=self.weight_decay)
        torch._foreach_mul_(step, -self.schedule(state["count"]))
        for n, s in zip(names, step):
            updates[n] = s
        return updates, dict(count=count, mu=state["mu"], nu=state["nu"])


class Lion:
    """``optax.lion(schedule, b1, b2, weight_decay=...)``: the update is
    sign((1 - b1) * g + b1 * mu) (sign(0) = 0), then mu = (1 - b2) * g + b2 *
    mu, then ``+ wd * p`` and ``* -lr(count)``, the schedule read at the
    count before the step."""

    def __init__(self, schedule: Callable[[int], float], b1: float = 0.9, b2: float = 0.99,
                 weight_decay: float = 1e-3):
        self.schedule, self.b1, self.b2 = schedule, b1, b2
        self.weight_decay = weight_decay

    def init(self, params: Tree):
        return dict(count=0, mu={k: torch.zeros_like(p) for k, p in params.items()})

    def update(self, updates: Tree, state, params: Tree):
        names = list(updates)
        g = [_local(updates[n]) for n in names]
        mu = [state["mu"][n] for n in names]
        step = torch._foreach_mul(g, 1 - self.b1)
        torch._foreach_add_(step, torch._foreach_mul(mu, self.b1))
        torch._foreach_sign_(step)
        torch._foreach_mul_(mu, self.b2)
        torch._foreach_add_(mu, torch._foreach_mul(g, 1 - self.b2))
        if self.weight_decay:
            torch._foreach_add_(step, [params[n] for n in names], alpha=self.weight_decay)
        torch._foreach_mul_(step, -self.schedule(state["count"]))
        torch._foreach_copy_(g, step)
        return updates, dict(count=state["count"] + 1, mu=state["mu"])


class AddDecayedWeights:
    """``optax.add_decayed_weights(wd)``: u = g + wd * p."""

    def __init__(self, weight_decay: float):
        self.weight_decay = weight_decay

    def init(self, params: Tree):
        return None

    def update(self, updates: Tree, state, params: Tree):
        names = list(updates)
        torch._foreach_add_([_local(updates[n]) for n in names], [params[n] for n in names],
                            alpha=self.weight_decay)
        return updates, state


class SGD:
    """``optax.sgd(schedule, momentum)``: optax's ``trace`` (t = g +
    momentum * t) then ``* -lr(count)``, the schedule read at the count
    before the step."""

    def __init__(self, schedule: Callable[[int], float], momentum: float = 0.9):
        self.schedule, self.momentum = schedule, momentum

    def init(self, params: Tree):
        return dict(count=0, trace={k: torch.zeros_like(p) for k, p in params.items()})

    def update(self, updates: Tree, state, params: Tree):
        names = list(updates)
        g = [_local(updates[n]) for n in names]
        trace = [state["trace"][n] for n in names]
        torch._foreach_mul_(trace, self.momentum)
        torch._foreach_add_(trace, g)
        # the updates are the trainer's gradient accumulators: write the
        # step into them, never alias the trace
        torch._foreach_copy_(g, trace)
        torch._foreach_mul_(g, -self.schedule(state["count"]))
        return updates, dict(count=state["count"] + 1, trace=state["trace"])


class Chain:
    """``optax.chain``: each transformation's updates feed the next."""

    def __init__(self, *transforms):
        self.transforms = transforms

    def init(self, params: Tree):
        return [t.init(params) for t in self.transforms]

    def update(self, updates: Tree, state, params: Tree):
        new_state = []
        for t, s in zip(self.transforms, state):
            updates, s = t.update(updates, s, params)
            new_state.append(s)
        return updates, new_state

