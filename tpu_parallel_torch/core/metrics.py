"""``(sum, count)`` metrics: the port of ``tpu_parallel/core/metrics.py``.

Metrics are dicts of ``(sum, count)`` pairs of 0-dim tensors, so adding a
minibatch's or a step's metrics is a dict-add and the device is read only
when :func:`compute` asks for the means.  One device: nothing to sync.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

Metrics = Dict[str, Tuple[torch.Tensor, torch.Tensor]]


def metric(value, count=1) -> Tuple[torch.Tensor, torch.Tensor]:
    """One ``(sum, count)`` entry in fp32; ``value`` should already be a sum."""
    device = value.device if isinstance(value, torch.Tensor) else None
    return (torch.as_tensor(value, dtype=torch.float32, device=device).detach(),
            torch.as_tensor(count, dtype=torch.float32, device=device).detach())


def accumulate_metrics(running: Optional[Metrics], step: Metrics) -> Metrics:
    """Add a step's metrics into the running totals."""
    if running is None:
        return step
    return {k: (running[k][0] + s, running[k][1] + c) for k, (s, c) in step.items()}


def compute(metrics: Metrics) -> Dict[str, float]:
    """Each ``(sum, count)`` reduced to a host-side mean."""
    return {k: float(s) / max(float(c), 1e-8) for k, (s, c) in metrics.items()}
