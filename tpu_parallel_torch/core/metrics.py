"""``(sum, count)`` metrics: the port of ``tpu_parallel/core/metrics.py``.

Metrics are dicts of ``(sum, count)`` pairs of 0-dim tensors, so adding a
minibatch's or a step's metrics is a dict-add and the device is read only
when :func:`compute` asks for the means.  :func:`sync_metrics` all-reduces
them over mesh axes.

JAX's ``vma_of``, ``_cast_varying`` and ``pvary_missing`` have no
counterpart: they type values as replicated or varying for ``shard_map``'s
checker, which torch does not have.  What they guarantee holds here by
construction: a metric that every rank of an axis computed alike is summed
like any other, so summing it over the axis multiplies it by the axis size.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from tpu_parallel_torch.runtime.mesh import reduction_groups

Metrics = Dict[str, Tuple[torch.Tensor, torch.Tensor]]


def metric(value, count=1) -> Tuple[torch.Tensor, torch.Tensor]:
    """One ``(sum, count)`` entry in fp32; ``value`` should already be a sum."""
    device = value.device if isinstance(value, torch.Tensor) else None
    return (torch.as_tensor(value, dtype=torch.float32, device=device).detach(),
            torch.as_tensor(count, dtype=torch.float32, device=device).detach())


def sync_metrics(metrics: Metrics, axis_names: Union[str, Sequence[str]],
                 mean_axes: Union[str, Sequence[str]] = (), mesh=None) -> Metrics:
    """All-reduce metric sums and counts over mesh axes of ``mesh``.

    ``axis_names``: axes whose ranks hold *disjoint* tokens (data, seq) —
    summed.  ``mean_axes``: axes whose ranks compute *replicated* metrics
    (the tensor-parallel axis) — averaged, so token counts stay exact.
    Every sum and count rides in one fp32 tensor: one ``all_reduce`` per
    bound axis above size 1, the data and seq axes in one over their joint
    ranks (``runtime.mesh.reduction_groups``).  Unbound axes, and axes of size 1 (where the
    sum and the mean are the identity), are skipped (no mesh: a no-op)."""
    if isinstance(axis_names, str):
        axis_names = (axis_names,)
    if isinstance(mean_axes, str):
        mean_axes = (mean_axes,)
    groups = [(g, False) for g in reduction_groups(mesh, axis_names)]
    groups += [(g, True) for g in reduction_groups(mesh, mean_axes)]
    if not groups:
        return metrics
    keys = sorted(metrics)
    packed = torch.stack([t.float() for k in keys for t in metrics[k]])
    for (group, size), mean in groups:
        dist.all_reduce(packed, group=group)
        if mean:
            packed.div_(size)
    return {k: (packed[2 * i], packed[2 * i + 1]) for i, k in enumerate(keys)}


def accumulate_metrics(running: Optional[Metrics], step: Metrics) -> Metrics:
    """Add a step's metrics into the running totals."""
    if running is None:
        return step
    return {k: (running[k][0] + s, running[k][1] + c) for k, (s, c) in step.items()}


def compute(metrics: Metrics) -> Dict[str, float]:
    """Each ``(sum, count)`` reduced to a host-side mean."""
    return {k: float(s) / max(float(c), 1e-8) for k, (s, c) in metrics.items()}


def format_metrics(metrics: Metrics, title: Optional[str] = None) -> str:
    vals = compute(metrics)
    lines = []
    if title:
        lines.append(f" {title} ".center(32, "="))
    for k in sorted(vals):
        lines.append(f"{k}: {vals[k]:.6f}")
    return "\n".join(lines)


def print_metrics(metrics: Metrics, title: Optional[str] = None) -> None:
    print(format_metrics(metrics, title))
