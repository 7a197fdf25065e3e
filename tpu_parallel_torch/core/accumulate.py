"""Gradient accumulation over minibatches: the port of
``tpu_parallel/core/accumulate.py``.

One forward and backward per minibatch; each backward's gradients go into
the state's fp32 accumulators (``TrainState.accumulate_grads``).  PyTorch
runs eagerly, so the JAX package's scan and unrolled-loop variants are one
loop here; ``use_scan`` stays in the signature and gives the same result.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from tpu_parallel_torch.core.metrics import Metrics, accumulate_metrics
from tpu_parallel_torch.core.state import TextBatch, TrainState

# loss_fn(model, minibatch, rng) -> (loss, metrics)
LossFn = Callable[[torch.nn.Module, TextBatch, torch.Generator], Tuple[torch.Tensor, Metrics]]


def accumulate_gradients(
    state: TrainState,
    batch: TextBatch,
    rng: torch.Generator,
    num_minibatches: int,
    loss_fn: LossFn,
    *,
    use_scan: bool = True,
) -> Tuple[Dict[str, torch.Tensor], Metrics]:
    """Accumulate gradients over ``num_minibatches`` slices of ``batch``.

    Returns the mean gradients (fp32, by parameter name: the state's
    accumulators themselves) and the summed ``(sum, count)`` metrics.
    """
    del use_scan
    batch_size = batch.size
    if batch_size % num_minibatches != 0:
        raise ValueError(
            f"per-device batch size {batch_size} is not divisible by "
            f"num_minibatches={num_minibatches}; "
            f"{batch_size - (batch_size // num_minibatches) * num_minibatches} "
            "samples per device would be silently dropped"
        )
    n = max(1, num_minibatches)
    size = batch_size // n
    state.zero_grads()
    metrics = None
    for i in range(n):
        loss, step_metrics = loss_fn(state.model, batch.rows(i * size, (i + 1) * size), rng)
        loss.backward()
        state.accumulate_grads()
        step_metrics = {k: (s.detach(), c.detach()) for k, (s, c) in step_metrics.items()}
        metrics = accumulate_metrics(metrics, step_metrics)
    grads = state.grads
    if n > 1:
        torch._foreach_div_(list(grads.values()), float(n))
    return grads, metrics
