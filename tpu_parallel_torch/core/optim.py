"""Optimizer transformations: the port of ``tpu_parallel/core/optim.py``
and of the optax pieces the trainer chains.

Each transformation works on dicts of fp32 tensors keyed by parameter name,
as optax's do on pytrees: ``init(params) -> state`` and ``update(updates,
state, params) -> (updates, state)``.  ``update`` rewrites ``updates`` in
place (multi-tensor ``torch._foreach_*`` ops) and returns it.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

Tree = Dict[str, torch.Tensor]


def global_norm(tree: Tree) -> torch.Tensor:
    """L2 norm over every tensor of ``tree`` (fp32, on the tensors' device)."""
    norms = torch._foreach_norm(list(tree.values()))
    return torch.stack(norms).square().sum().sqrt()


class ClipByGlobalNorm:
    """``optax.clip_by_global_norm``: scale every update by
    min(1, max_norm / max(norm, 1e-9)).  Not ``clip_grad_norm_``, which
    divides by norm + 1e-6."""

    def __init__(self, max_norm: float):
        self.max_norm = max_norm

    def init(self, params: Tree):
        return None

    def update(self, updates: Tree, state, params: Tree = None):
        norm = global_norm(updates)
        scale = torch.clamp(self.max_norm / torch.clamp(norm, min=1e-9), max=1.0)
        torch._foreach_mul_(list(updates.values()), scale)
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
        g = [updates[n] for n in names]
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

