"""The one piece of ``tpu_parallel/parallel/tp.py`` the port has so far:
:func:`export_single_device_params`.  Tensor parallelism itself (column and
row pairs, ``TPDense``, ``TPMLP``) is ROADMAP queue A item 5.3.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

import torch

from tpu_parallel_torch.parallel.fsdp import gather_params, sharded_axes

# mesh axes whose shards the export cannot join yet -> what brings them
_SPLIT_AXES = {
    "model": "tensor parallelism (ROADMAP queue A item 5.3)",
    "pipe": "pipeline parallelism (ROADMAP queue A item 5.4)",
}


def export_single_device_params(params: Dict[str, Any],
                                fsdp_axes: Sequence[str] = ("data",)) -> Dict[str, torch.Tensor]:
    """Mesh-trained params (by name; ``DTensor`` shards, e.g. a state's
    ``partitioned(state.params)``) in the mesh-free module layout: each leaf
    sharded only over ``fsdp_axes`` (FSDP slices of a real dim) becomes its
    full tensor, gathered with ``fsdp.gather_params`` (one all-gather per
    axis and dtype; a collective, so every rank of the mesh calls this
    together), and plain tensors pass as they are.  A leaf split over
    ``model`` or ``pipe`` above 1 raises ``NotImplementedError``, naming the
    item that brings it; over any other axis above 1, ``ValueError`` (JAX's
    error: it may be a renamed data axis)."""
    by_axis: Dict[str, Dict[str, Any]] = {}
    for name, leaf in params.items():
        axes = sharded_axes(leaf)
        mesh = getattr(leaf, "device_mesh", None)
        for axis in axes:
            size = mesh.size(mesh.mesh_dim_names.index(axis))
            if axis in fsdp_axes or size == 1:
                continue
            what = f"parameter {name} is split over mesh axis {axis!r} (size {size})"
            if axis in _SPLIT_AXES:
                raise NotImplementedError(f"{what}; exporting it needs {_SPLIT_AXES[axis]}")
            raise ValueError(f"{what}; if {axis!r} is a renamed data axis used for FSDP, "
                             f"pass fsdp_axes=({axis!r},)")
        if axes:
            by_axis.setdefault(axes[0], {})[name] = leaf
    out = dict(params)
    with torch.no_grad():
        for axis, leaves in by_axis.items():
            out.update(gather_params(leaves, axis))
    return out
