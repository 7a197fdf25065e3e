"""Generic SPMD train functions: the port of ``tpu_parallel/parallel/spmd.py``,
for meshes whose only axis above 1 is data (DP and FSDP).

JAX traces ``model_init`` abstractly under ``shard_map`` to discover which
parameters come out ``nn.Partitioned``, then lays out the real init and the
step by those specs.  Here every rank runs its own program and the model is
built sharded (``parallel/fsdp.py`` wraps its modules at construction), so
the layout is known before the state exists: :func:`build_train_functions`
reads ``state_specs`` and ``state_shapes`` off the model's parameters.  The
step is JAX's: accumulate gradients over minibatches, sync each gradient
over the axes its parameter is replicated on (``fsdp.sync_gradients``: one
all-reduce for the replicated ones, nothing for FSDP shards, whose gather
already reduce-scattered), apply the optimizer, update the EMA shadow, sync
the metrics.

Not in the port yet, each raising ``NotImplementedError``: a bound model,
pipe or seq axis above 1 (ROADMAP queue A items 5.3, 5.4, 5.5) and a
schedule-owned ``grad_fn`` (the 1F1B pipeline, item 5.4).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import torch

from tpu_parallel_torch.core.accumulate import LossFn, accumulate_gradients
from tpu_parallel_torch.core.metrics import Metrics, accumulate_metrics, sync_metrics
from tpu_parallel_torch.core.state import TrainState
from tpu_parallel_torch.parallel import fsdp
from tpu_parallel_torch.parallel.dp import broadcast_state
from tpu_parallel_torch.runtime.mesh import mesh_sizes

# mesh axes build_train_functions cannot partition over yet -> what brings them
_LATER_AXES = {
    "model": "tensor parallelism (ROADMAP queue A item 5.3)",
    "pipe": "pipeline parallelism (ROADMAP queue A item 5.4)",
    "seq": "sequence parallelism (ROADMAP queue A item 5.5)",
}


def make_model_init(model: torch.nn.Module, tx) -> Callable:
    """The standard ``(rng, params=None) -> TrainState`` initializer over
    ``model``, closing over a single optimizer instance ``tx`` (as JAX's
    must).  ``model`` already holds its seeded draws, sharded as it was
    built; ``params`` (fp32 by name, full shapes) replaces them.  The
    initializer's ``model`` attribute is what :func:`build_train_functions`
    reads the layout from."""

    def init(rng: torch.Generator, params: Optional[Dict[str, torch.Tensor]] = None
             ) -> TrainState:
        return TrainState.create(model, tx, rng, params)

    init.model = model
    return init


@dataclasses.dataclass(frozen=True)
class TrainFunctions:
    """Bundle returned by :func:`build_train_functions`."""

    init_fn: Callable  # (rng=None, params=None) -> TrainState (sharded)
    step_fn: Callable  # (state, metrics, batch) -> (state, metrics)
    state_specs: Dict[str, Tuple[Optional[str], ...]]  # parameter -> axis name per dim
    state_shapes: Dict[str, Tuple[int, ...]]  # parameter -> this rank's shape
    eval_fn: Optional[Callable] = None  # (state, metrics, batch) -> metrics


def refuse_later_axes(sizes: Dict[str, int]) -> None:
    """Raise for a mesh axis above 1 that the port cannot partition over yet."""
    for axis, what in _LATER_AXES.items():
        if sizes.get(axis, 1) > 1:
            raise NotImplementedError(f"mesh {sizes}: a {axis} axis of {sizes[axis]} needs {what}")


def build_train_functions(
    model_init: Callable,
    loss_fn: LossFn,
    mesh,
    *,
    grad_sync_axes: Union[str, Sequence[str]] = ("data",),
    metric_axes: Optional[Sequence[str]] = None,
    metric_mean_axes: Sequence[str] = (),
    num_minibatches: int = 1,
    eval_loss_fn: Optional[LossFn] = None,
    ema_decay: float = 0.0,
    grad_fn: Optional[Callable] = None,
) -> TrainFunctions:
    """Build matched (init, train step) functions for ``mesh`` (a
    ``DeviceMesh`` from ``runtime.make_mesh``, or None for one device).

    ``model_init`` is :func:`make_model_init`'s (it carries the model).
    ``grad_sync_axes``: axes over which replicated-parameter gradients are
    averaged (``fsdp.sync_gradients``).  The step's metrics are summed over
    ``metric_axes`` (default: every mesh axis) and averaged over
    ``metric_mean_axes``.  The init broadcasts data-rank 0's replicated
    masters over ``grad_sync_axes`` and seeds the EMA shadow when
    ``ema_decay`` > 0.  ``loss_fn(model, minibatch, rng)`` gets the state's
    generator.  ``grad_fn`` (a schedule-owned gradient) is refused.
    """
    if grad_fn is not None:
        raise NotImplementedError(
            "grad_fn (a schedule-owned gradient, the 1F1B pipeline) needs pipeline "
            "parallelism (ROADMAP queue A item 5.4)")
    refuse_later_axes(mesh_sizes(mesh))
    if isinstance(grad_sync_axes, str):
        grad_sync_axes = (grad_sync_axes,)
    if metric_axes is None:
        metric_axes = tuple(mesh.mesh_dim_names) if mesh is not None else ()
    if ema_decay and not 0.0 < ema_decay < 1.0:
        raise ValueError(f"ema_decay={ema_decay} must be in (0, 1)")

    state_specs, state_shapes = {}, {}
    for name, p in model_init.model.named_parameters():
        info = fsdp.shard_info(p)
        state_specs[name] = info.spec() if info is not None else (None,) * p.dim()
        state_shapes[name] = tuple(p.shape)

    def init_fn(rng: Optional[torch.Generator] = None,
                params: Optional[Dict[str, torch.Tensor]] = None) -> TrainState:
        if rng is None:
            rng = torch.Generator().manual_seed(0)
        state = model_init(rng, params)
        for axis in grad_sync_axes:
            broadcast_state(state, data_axis=axis, mesh=mesh)
        if ema_decay and state.ema_params is None:
            # the shadow starts at the masters and inherits their sharding
            state.seed_ema()
        return state

    def step_fn(state: TrainState, metrics: Optional[Metrics], batch):
        grads, step_metrics = accumulate_gradients(state, batch, state.rng, num_minibatches,
                                                   loss_fn)
        fsdp.sync_gradients(state.partitioned(grads), grad_sync_axes, mesh=mesh)
        state.apply_gradients(grads)
        if ema_decay:
            state.update_ema(ema_decay)
        if metric_axes or metric_mean_axes:
            step_metrics = sync_metrics(step_metrics, metric_axes, metric_mean_axes, mesh=mesh)
        return state, accumulate_metrics(metrics, step_metrics)

    eval_fn = None
    if eval_loss_fn is not None:

        @torch.no_grad()
        def eval_fn(state: TrainState, metrics: Optional[Metrics], batch) -> Metrics:
            # the EMA shadow when one is kept (the standard reason to keep it)
            with state.ema_weights():
                _, step_metrics = eval_loss_fn(state.model, batch, state.rng)
            if metric_axes or metric_mean_axes:
                step_metrics = sync_metrics(step_metrics, metric_axes, metric_mean_axes,
                                            mesh=mesh)
            return accumulate_metrics(metrics, step_metrics)

    return TrainFunctions(init_fn=init_fn, step_fn=step_fn, state_specs=state_specs,
                          state_shapes=state_shapes, eval_fn=eval_fn)
