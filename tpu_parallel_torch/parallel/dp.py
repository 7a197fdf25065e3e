"""Data parallelism over a mesh axis: the port of ``tpu_parallel/parallel/dp.py``.

Each rank holds a replica of the state and its own rows of the global
batch.  A step accumulates this rank's gradients, averages them over the
data axis (JAX's ``pmean``: an all-reduce SUM, then a division by the
axis size; ``ReduceOp.AVG`` is not taken because gloo's support for it
depends on the build), applies the optimizer on every rank alike, and sums
the metrics over the axis.  The loss is each rank's own mean, and the
average runs over those means, as in JAX: with loss masks or packed rows
the ranks count different tokens and the result is not the token-weighted
global mean.

The gradient accumulators are views into one flat fp32 buffer
(``TrainState.flat_grads``), so the sync is one ``all_reduce`` on it, the
counterpart of XLA's combined all-reduce, with no copy.  The sync runs once,
after accumulation, as in JAX; it does not overlap the backward.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Union

import torch
import torch.distributed as dist

from tpu_parallel_torch.core.accumulate import LossFn, accumulate_gradients
from tpu_parallel_torch.core.metrics import Metrics, accumulate_metrics, sync_metrics
from tpu_parallel_torch.core.state import TrainState
from tpu_parallel_torch.runtime.mesh import axis_group, reduction_groups

# gradient all-reduces launched by sync_gradients_dp (one per bound axis
# per call)
dp_allreduce_launches = 0


def _flat_base(grads: Dict[str, torch.Tensor]) -> Optional[torch.Tensor]:
    """The one buffer every tensor of ``grads`` is a view of, when they
    cover all of it (``TrainState.flat_grads``); else None."""
    tensors = list(grads.values())
    base = tensors[0]._base if tensors else None
    if base is None or any(t._base is not base for t in tensors):
        return None
    return base if sum(t.numel() for t in tensors) == base.numel() else None


def sync_gradients_dp(grads: Dict[str, torch.Tensor],
                      axis_names: Union[str, Sequence[str]] = "data", mesh=None):
    """Average ``grads`` in place over the mesh axes ``axis_names``
    (``data_paral.py:210-212``'s ``pmean``) and return them.  One
    ``all_reduce`` per bound axis above size 1, the data and seq axes
    together in one over their joint ranks (``runtime.mesh.
    reduction_groups``; one on the first bound axis when every bound axis
    has size 1, so a mesh run always syncs through the collective path) on the flat buffer the gradients view
    (or on a flattened copy when they are separate tensors).  Unbound axes
    are skipped: without a mesh nothing happens."""
    global dp_allreduce_launches
    if isinstance(axis_names, str):
        axis_names = (axis_names,)
    bound = [b for b in (axis_group(mesh, name) for name in axis_names) if b is not None]
    if not bound:
        return grads
    groups = reduction_groups(mesh, axis_names) or [bound[0][:2]]
    flat = _flat_base(grads)
    tensors = list(grads.values())
    staged = flat if flat is not None else torch.cat([t.reshape(-1) for t in tensors])
    size = 1
    for group, axis_size in groups:
        dist.all_reduce(staged, group=group)
        dp_allreduce_launches += 1
        size *= axis_size
    staged.div_(size)
    if flat is None:
        offset = 0
        for t in tensors:
            t.copy_(staged[offset:offset + t.numel()].view_as(t))
            offset += t.numel()
    return grads


def make_train_step(loss_fn: LossFn, *, data_axis: str = "data", num_minibatches: int = 1,
                    use_scan: bool = True, mesh=None) -> Callable:
    """A DP train step ``(state, metrics, batch) -> (state, metrics)`` on
    this rank's rows of the batch: accumulate, sync the gradients over
    ``data_axis``, apply, sync the metrics over ``data_axis`` and add them
    to ``metrics``.  ``mesh=None`` is the single-device step (no sync).
    ``loss_fn(model, minibatch, rng)`` gets the state's generator, which it
    folds over the data axis for per-rank dropout."""

    def step(state: TrainState, metrics: Optional[Metrics], batch):
        grads, step_metrics = accumulate_gradients(state, batch, state.rng, num_minibatches,
                                                   loss_fn, use_scan=use_scan)
        grads = sync_gradients_dp(grads, data_axis, mesh)
        state.apply_gradients(grads)
        step_metrics = sync_metrics(step_metrics, data_axis, mesh=mesh)
        return state, accumulate_metrics(metrics, step_metrics)

    return step


@torch.no_grad()
def broadcast_state(state: TrainState, *, data_axis: str = "data", mesh=None) -> TrainState:
    """Overwrite every rank's masters that are replicated over ``data_axis``
    with those of its coordinate 0 (one broadcast of the flattened
    masters), then the module from the masters: replicas equal by
    construction.  Shards over ``data_axis`` itself (FSDP's, or
    tensor-parallel ones when it is the model axis) differ by rank and are
    left as they are.  Nothing to do on an axis of size 1."""
    bound = axis_group(mesh, data_axis)
    names = [n for n in state.params
             if n not in state.shards or data_axis not in state.shards[n].axes]
    if bound is None or bound[1] == 1 or not names:
        return state
    group = bound[0]
    flat = torch.cat([state.params[n].reshape(-1) for n in names])
    dist.broadcast(flat, src=dist.get_global_rank(group, 0), group=group)
    offset = 0
    for n in names:
        p = state.params[n]
        p.copy_(flat[offset:offset + p.numel()].view_as(p))
        offset += p.numel()
    state._masters_to_module()
    return state


def make_init(model_init: Callable[..., TrainState], *, data_axis: str = "data",
              mesh) -> Callable[..., TrainState]:
    """Wrap a ``(*args) -> TrainState`` initializer for a DP mesh: every
    rank builds the state from the same arguments, then rank 0's masters
    are broadcast over the data axis (:func:`broadcast_state`)."""

    def init(*args, **kwargs) -> TrainState:
        return broadcast_state(model_init(*args, **kwargs), data_axis=data_axis, mesh=mesh)

    return init
