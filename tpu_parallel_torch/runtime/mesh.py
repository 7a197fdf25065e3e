"""Device meshes for DP x FSDP x TP x PP (x SP): the port of
``tpu_parallel/runtime/mesh.py``.

The axis names, their order, :class:`MeshConfig` and :func:`factor_mesh`
are copied (they are JAX-free).  :func:`make_mesh` builds a
``torch.distributed`` ``DeviceMesh`` over the ranks of the initialized
process group, one rank per device, with all four named axes in
``AXIS_ORDER`` (size-1 axes kept, so the same axis names work for every
strategy combination).

Without a process group there is one device.  A config that resolves to it
is the single-device case: :func:`make_mesh` returns ``None`` and every
collective of the port is a no-op on it, the counterpart of JAX's unbound
mesh axes (``tpu_parallel/core/rng.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
PIPE_AXIS = "pipe"
SEQ_AXIS = "seq"

# Outer-to-inner ordering used when materializing the physical mesh.
AXIS_ORDER: Tuple[str, ...] = (PIPE_AXIS, DATA_AXIS, SEQ_AXIS, MODEL_AXIS)
# axes whose ranks hold disjoint tokens of one batch (rows, sequence blocks):
# a sum or mean over both runs as one all-reduce over their joint ranks
TOKEN_AXES: Tuple[str, ...] = (DATA_AXIS, SEQ_AXIS)


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Logical mesh shape. ``-1`` on any ONE axis means "all remaining devices"."""

    data: int = -1
    model: int = 1
    pipe: int = 1
    seq: int = 1

    def resolved(self, n_devices: int) -> "MeshConfig":
        sizes = dict(data=self.data, model=self.model, pipe=self.pipe, seq=self.seq)
        wild = [name for name, v in sizes.items() if v == -1]
        if len(wild) > 1:
            raise ValueError(f"at most one mesh axis may be -1, got {wild}")
        if wild:
            fixed = 1
            for name, v in sizes.items():
                if name != wild[0]:
                    fixed *= v
            if fixed <= 0 or n_devices % fixed != 0:
                raise ValueError(
                    f"{n_devices} devices not divisible by the fixed axes "
                    f"product {fixed} (mesh {sizes})"
                )
            sizes[wild[0]] = n_devices // fixed
        if sizes["data"] * sizes["model"] * sizes["pipe"] * sizes["seq"] != n_devices:
            raise ValueError(
                f"mesh shape data={sizes['data']} model={sizes['model']} "
                f"pipe={sizes['pipe']} seq={sizes['seq']} does not cover "
                f"{n_devices} devices"
            )
        return MeshConfig(**sizes)

    def axis_sizes(self) -> dict:
        return {
            PIPE_AXIS: self.pipe,
            DATA_AXIS: self.data,
            SEQ_AXIS: self.seq,
            MODEL_AXIS: self.model,
        }


def make_mesh(config: MeshConfig = MeshConfig(), device_type: Optional[str] = None):
    """A ``DeviceMesh`` with the named axes of ``config`` over the process
    group's ranks (``init_device_mesh(device_type, shape,
    mesh_dim_names=AXIS_ORDER)``), the shape taken in ``AXIS_ORDER``.

    ``device_type`` defaults to the type of the device
    ``runtime.initialize`` bound this process to (gloo ranks on a card
    make a ``"cuda"`` mesh: a ``DTensor`` over it keeps its CUDA local
    tensor), else ``"cuda"`` under NCCL and ``"cpu"`` otherwise.  Without
    a process group the config must resolve to one device, and the result
    is ``None`` (the single-device case)."""
    if not dist.is_initialized():
        config.resolved(1)
        return None
    from torch.distributed.device_mesh import init_device_mesh

    from tpu_parallel_torch.runtime import bootstrap

    sizes = config.resolved(dist.get_world_size()).axis_sizes()
    if device_type is None and bootstrap._DEVICE is not None:
        device_type = bootstrap._DEVICE.type
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    mesh = init_device_mesh(device_type, tuple(sizes[a] for a in AXIS_ORDER),
                            mesh_dim_names=AXIS_ORDER)
    if all(sizes[a] > 1 for a in TOKEN_AXES):
        # the token axes' joint ranks, for reduction_groups: a flattened
        # sub-mesh, made here because every rank makes the mesh together
        mesh._token_mesh = mesh[TOKEN_AXES]._flatten()
    return mesh


def mesh_from_sizes(data: int = -1, model: int = 1, pipe: int = 1, seq: int = 1,
                    device_type: Optional[str] = None):
    return make_mesh(MeshConfig(data=data, model=model, pipe=pipe, seq=seq), device_type)


def mesh_sizes(mesh) -> dict:
    """``{axis: size}`` of a mesh from :func:`make_mesh` (every axis 1 for
    ``None``, the single-device case)."""
    if mesh is None:
        return {axis: 1 for axis in AXIS_ORDER}
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def axis_group(mesh, name: str):
    """``(process group, size, this rank's coordinate)`` of mesh axis
    ``name``, or ``None`` when the axis is unbound (no mesh, or a mesh
    without that axis): the collectives of the port skip unbound axes, as
    JAX's do outside ``shard_map``."""
    if mesh is None or name not in (mesh.mesh_dim_names or ()):
        return None
    return mesh.get_group(name), mesh.size(mesh.mesh_dim_names.index(name)), mesh.get_local_rank(name)


def reduction_groups(mesh, names) -> list:
    """``[(group, size)]`` that an all-reduce over the mesh axes ``names``
    runs on, in ``names``' order: one per bound axis above size 1, except
    that the token axes (data and seq), both above size 1, share the one
    group of their joint ranks that :func:`make_mesh` made, at the first
    one's place."""
    big = [a for a in names if (b := axis_group(mesh, a)) is not None and b[1] > 1]
    joint = getattr(mesh, "_token_mesh", None) if all(a in big for a in TOKEN_AXES) else None
    out = []
    for a in big:
        if joint is None or a not in TOKEN_AXES:
            out.append(axis_group(mesh, a)[:2])
        elif a == next(x for x in big if x in TOKEN_AXES):
            out.append((joint.get_group(), joint.size()))
    return out


def factor_mesh(
    n_devices: int, *, want_model: int = 1, want_pipe: int = 1, want_seq: int = 1
) -> MeshConfig:
    """Best-effort factorization of ``n_devices`` into (pipe, data, seq, model).

    Shrinks the requested model/pipe/seq degrees to the largest divisors that
    fit (in that priority order).  Useful for dry-runs where the device count
    is dictated from outside.
    """

    def largest_divisor(n: int, want: int) -> int:
        for d in range(min(want, n), 0, -1):
            if n % d == 0:
                return d
        return 1

    model = largest_divisor(n_devices, want_model)
    rem = n_devices // model
    pipe = largest_divisor(rem, want_pipe)
    rem //= pipe
    seq = largest_divisor(rem, want_seq)
    return MeshConfig(data=rem // seq, model=model, pipe=pipe, seq=seq)
