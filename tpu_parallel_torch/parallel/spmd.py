"""Generic SPMD train functions: the port of ``tpu_parallel/parallel/spmd.py``,
for meshes over data, model, pipe and seq (DP, FSDP, tensor, pipeline and
sequence parallelism).

JAX traces ``model_init`` abstractly under ``shard_map`` to discover which
parameters come out ``nn.Partitioned``, then lays out the real init and the
step by those specs.  Here every rank runs its own program and the model is
built sharded (``parallel/fsdp.py`` wraps its modules at construction,
``parallel/tp.py`` builds its tensor-parallel layers at their local
widths), so the layout is known before the state exists:
:func:`build_train_functions` reads ``state_specs`` and ``state_shapes``
off the model's parameters.  The step is JAX's: accumulate gradients over
minibatches, sync each gradient over the axes its parameter is replicated
on (``fsdp.sync_gradients``: one all-reduce for the replicated ones,
nothing over the data axis for FSDP shards, whose gather already
reduce-scattered, and a division by the axis size for tensor-parallel
shards, whose backward summed ``tp`` copies of the replicated loss's
cotangent), apply the optimizer, update the EMA shadow, sync the metrics
(summed over the axes whose ranks hold disjoint tokens, averaged over the
replicated-loss axes).  Under pipeline parallelism the leaves replicated
over ``pipe`` (the embedding, ``norm_final``, the lm_head) are summed over
it (``grad_psum_axes``: one rank holds each one's gradient, the others
zero), the stage-owned ones are not, and a schedule-owned ``grad_fn`` (the
1F1B pipeline) may replace the accumulation.  Under sequence parallelism
each seq rank's loss is the mean over its own token block: gradients are
averaged and metrics summed over the seq axis as over the data axis, the
two together in one all-reduce over their joint ranks
(``runtime.mesh.reduction_groups``).
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


def build_train_functions(
    model_init: Callable,
    loss_fn: LossFn,
    mesh,
    *,
    grad_sync_axes: Union[str, Sequence[str]] = ("data",),
    grad_psum_axes: Union[str, Sequence[str]] = (),
    replicated_loss_axes: Union[str, Sequence[str]] = ("model",),
    metric_axes: Optional[Sequence[str]] = None,
    metric_mean_axes: Optional[Sequence[str]] = None,
    num_minibatches: int = 1,
    eval_loss_fn: Optional[LossFn] = None,
    ema_decay: float = 0.0,
    grad_fn: Optional[Callable] = None,
) -> TrainFunctions:
    """Build matched (init, train step) functions for ``mesh`` (a
    ``DeviceMesh`` from ``runtime.make_mesh``, or None for one device).

    ``model_init`` is :func:`make_model_init`'s (it carries the model).
    ``grad_sync_axes``: axes over which replicated-parameter gradients are
    averaged (``fsdp.sync_gradients``).  ``grad_psum_axes``: axes where
    ranks hold disjoint gradient contributions that are summed (the pipe
    axis; a stage-owned leaf is not reduced over its own).
    ``replicated_loss_axes``: axes on
    which every rank computes the same loss on the same tokens (the
    tensor-parallel axis): gradients partitioned over them are divided by
    their size, and the metric defaults average over them.  The step's
    metrics are summed over ``metric_axes`` (default: every mesh axis not
    in ``replicated_loss_axes``) and averaged over ``metric_mean_axes``
    (default: those in it), so a model axis never counts a token ``tp``
    times.  The init broadcasts coordinate 0's masters over each axis of
    ``grad_sync_axes`` that a leaf is replicated on and seeds the EMA shadow when
    ``ema_decay`` > 0.  ``loss_fn(model, minibatch, rng)`` gets the state's
    generator.  ``grad_fn(state, batch, rng) -> (grads, metrics)`` (a
    schedule-owned gradient: the 1F1B pipeline) replaces the accumulation;
    it consumes the whole batch, so ``num_minibatches`` must be 1.
    """
    if grad_fn is not None and num_minibatches > 1:
        raise ValueError(
            "num_minibatches > 1 does not compose with a schedule-owned "
            "grad_fn (the 1F1B pipeline consumes the whole batch; split it "
            "with num_microbatches instead)"
        )
    if isinstance(grad_sync_axes, str):
        grad_sync_axes = (grad_sync_axes,)
    if isinstance(replicated_loss_axes, str):
        replicated_loss_axes = (replicated_loss_axes,)
    names = tuple(mesh.mesh_dim_names) if mesh is not None else ()
    if metric_axes is None:
        metric_axes = tuple(n for n in names if n not in replicated_loss_axes)
    if metric_mean_axes is None:
        metric_mean_axes = tuple(n for n in names if n in replicated_loss_axes)
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
        if grad_fn is not None:
            grads, step_metrics = grad_fn(state, batch, state.rng)
        else:
            grads, step_metrics = accumulate_gradients(state, batch, state.rng,
                                                       num_minibatches, loss_fn)
        fsdp.sync_gradients(state.partitioned(grads), grad_sync_axes, grad_psum_axes,
                            replicated_loss_axes=replicated_loss_axes, mesh=mesh)
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
