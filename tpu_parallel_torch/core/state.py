"""Train state and batch container: the port of ``tpu_parallel/core/state.py``.

The JAX ``TrainState`` is an immutable pytree of fp32 params, optimizer
state and a PRNG key.  Here it is a mutable object updated in place, which
keeps one copy of each buffer: the module (weights in ``config.dtype``, what
the forward reads), fp32 master weights and fp32 gradient accumulators.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
from torch import nn


@dataclasses.dataclass
class TextBatch:
    """Language-modeling batch: token ids plus next-token targets, all
    [batch, seq].  ``segment_ids``/``positions`` support packed sequences;
    ``loss_mask`` zeroes padding out of the loss."""

    tokens: torch.Tensor
    targets: torch.Tensor
    loss_mask: Optional[torch.Tensor] = None
    segment_ids: Optional[torch.Tensor] = None
    positions: Optional[torch.Tensor] = None

    @property
    def size(self) -> int:
        return self.tokens.shape[0]

    def rows(self, start: int, stop: int) -> "TextBatch":
        """Rows [start, stop) of every field (views, no copy)."""
        return TextBatch(**{
            f.name: None if getattr(self, f.name) is None else getattr(self, f.name)[start:stop]
            for f in dataclasses.fields(self)
        })


def get_num_params(state_or_model: Any) -> int:
    """Total parameter count of a module or a :class:`TrainState`."""
    model = getattr(state_or_model, "model", state_or_model)
    return sum(p.numel() for p in model.parameters())


@dataclasses.dataclass
class TrainState:
    """A module, its fp32 master weights and gradient accumulators, the
    optimizer and its state, and an explicit ``torch.Generator``.

    flax keeps fp32 params and casts them to ``config.dtype`` at each use;
    its gradient is the ``config.dtype`` cotangent cast back to fp32.  Here
    the module holds the cast weights; each backward writes ``.grad`` in
    their dtype, :meth:`accumulate_grads` adds it into ``grads`` (fp32) and
    clears it, and :meth:`apply_gradients` updates ``params`` and writes them
    back into the module rounded to its dtype.  fp32 module weights (the
    LayerNorms, or every weight of an fp32 config) are their own masters.
    """

    model: nn.Module
    tx: Any  # an in-place transformation with init/update (core.optim)
    params: Dict[str, torch.Tensor]
    grads: Dict[str, torch.Tensor]
    opt_state: Any
    rng: torch.Generator
    step: int = 0

    @classmethod
    def create(cls, model: nn.Module, tx, rng: torch.Generator,
               params: Optional[Dict[str, torch.Tensor]] = None) -> "TrainState":
        """Masters from ``params`` (fp32 values by parameter name, e.g. the
        draws of ``init_params`` or ``params_from_jax(..., dtype=float32)``)
        or, without them, from the module's own values."""
        masters, grads = {}, {}
        with torch.no_grad():
            for name, p in model.named_parameters():
                if params is not None:
                    p.copy_(params[name])
                if p.dtype == torch.float32:
                    master = p.detach()
                else:
                    master = (params[name] if params is not None else p).detach().to(
                        device=p.device, dtype=torch.float32, copy=True)
                masters[name] = master
                grads[name] = torch.zeros_like(master)
        return cls(model=model, tx=tx, params=masters, grads=grads,
                   opt_state=tx.init(masters), rng=rng)

    def zero_grads(self) -> None:
        torch._foreach_zero_(list(self.grads.values()))

    def accumulate_grads(self) -> None:
        """Add each parameter's ``.grad`` into its fp32 accumulator and clear it."""
        accs, new = [], []
        for name, p in self.model.named_parameters():
            if p.grad is not None:
                accs.append(self.grads[name])
                new.append(p.grad)
                p.grad = None
        if accs:
            torch._foreach_add_(accs, new)

    @torch.no_grad()
    def apply_gradients(self, grads: Dict[str, torch.Tensor]) -> None:
        """One optimizer step on the masters from ``grads`` (consumed in
        place), then the masters into the module."""
        updates, self.opt_state = self.tx.update(grads, self.opt_state, self.params)
        names = list(self.params)
        torch._foreach_add_([self.params[n] for n in names], [updates[n] for n in names])
        module = dict(self.model.named_parameters())
        cast = [n for n in names if module[n].dtype != torch.float32]
        if cast:
            torch._foreach_copy_([module[n].data for n in cast], [self.params[n] for n in cast])
        self.step += 1
