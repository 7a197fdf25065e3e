"""FSDP / ZeRO-3 parameter sharding over a mesh axis: the port of
``tpu_parallel/parallel/fsdp.py``.

Each sufficiently large parameter lives sliced 1/N per rank along one of its
own dims; the full weight is materialized just in time for compute with an
``all_gather`` whose backward is a reduce-scatter, so gradients are never
all-reduced at full size.

A wrapped module (:func:`shard_module_params`) keeps its parameter names:
each sharded parameter becomes its local slice, tagged with a
:class:`ShardInfo`, and forward hooks gather the slices before the module
runs and put them back after it, so the module body never knows it is
sharded.  Under ``torch.utils.checkpoint`` the hooks run inside the
checkpointed call, so the backward's recompute gathers again and no gathered
weight outlives its block, as JAX wraps the block inside ``nn.remat``.  The
gather of one module is one ``all_gather`` per dtype over its shards packed
together; its backward packs the full gradients, cast to fp32 first (JAX's
cotangent is fp32: the cast to the compute dtype happens inside the flax
module), into one reduce-scatter and divides by the axis size (JAX's
``psum_scatter / psum(1)``).  A slice with a ``main_grad`` attribute (the
fp32 accumulator ``TrainState`` gives it) receives its gradient there,
exactly; any other gets it as ``.grad`` in its own dtype.

The counterpart of ``nn.Partitioned`` is a ``DTensor`` placed ``Shard(dim)``
on the mesh's axis (:meth:`ShardInfo.dtensor`), which
``core/optim.py:global_norm_sharded`` and ``torch.distributed.checkpoint``
read.  An unbound axis (no mesh) is the identity: an FSDP config on one
device runs on plain tensors.

Over a mesh with a model axis above 1 (``llama_1b_3d``'s data x model x
pipe), a tensor-parallel parameter is already this rank's model slice
(``parallel/tp.py`` tags it with a model-axis ``ShardInfo``).  FSDP splits
that slice again, by JAX's rule applied to the slice's own shape (JAX runs
``shard_params`` on the local, TP-stacked leaf), so the data split can land
on the dim that the model axis already split: a data rank then holds a
sub-block of its model rank's block, at global offset ``model_idx * n / tp
+ data_idx * n / (tp * dp)``.  The parameter's tag is then a nested
``ShardInfo`` (the data split, with the model split as its ``outer``); its
``DTensor`` is placed ``Shard`` on both axes, or, where both split the same
dim, ``_StridedShard`` on the data axis (a model-major nesting).  The
gather and its reduce-scatter run over the data axis only, between the
data slice and the model slice.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from tpu_parallel_torch.runtime.mesh import axis_group

logger = logging.getLogger("tpu_parallel_torch")

# Parameters of this many elements or fewer stay replicated: the all-gather
# latency would cost more than the memory saved.
DEFAULT_MIN_WEIGHT_SIZE = 2**18

# collectives launched by the gather (forward, recompute included) and by
# its backward (one per gather whose gradient is taken)
fsdp_allgather_launches = 0
fsdp_reducescatter_launches = 0

# torch renamed both collectives (same arguments); older builds have only
# the old names, which newer ones deprecate
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


@dataclasses.dataclass(frozen=True, eq=False)
class ShardInfo:
    """Where a sharded parameter's slices live: torch dim ``dim`` of
    ``full_shape`` split evenly over mesh axis ``axis`` (``size`` ranks,
    this one at ``index``, its ``group``).  A nested split (FSDP over a
    tensor-parallel slice) has the split it refines as ``outer``:
    ``full_shape`` is then ``outer``'s local shape, and
    :attr:`global_shape` the full weight's."""

    mesh: Any
    axis: str
    dim: int
    full_shape: Tuple[int, ...]
    size: int
    index: int
    group: Any
    outer: Optional["ShardInfo"] = None

    @property
    def local_shape(self) -> Tuple[int, ...]:
        shape = list(self.full_shape)
        shape[self.dim] //= self.size
        return tuple(shape)

    @property
    def global_shape(self) -> Tuple[int, ...]:
        """The full weight's shape (before every split)."""
        return self.full_shape if self.outer is None else self.outer.global_shape

    @property
    def axes(self) -> Tuple[str, ...]:
        """The mesh axes the parameter is split over, outermost first."""
        return (self.axis,) if self.outer is None else self.outer.axes + (self.axis,)

    def narrow(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's slice of ``full`` at :attr:`full_shape` (a view)."""
        if tuple(full.shape) != self.full_shape:
            raise ValueError(f"shape {tuple(full.shape)}, the sharded parameter's is "
                             f"{self.full_shape}")
        n = self.full_shape[self.dim] // self.size
        return full.narrow(self.dim, self.index * n, n)

    def local(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's slice of the full weight (at :attr:`global_shape`;
        a view), through every split."""
        return self.narrow(full if self.outer is None else self.outer.local(full))

    def placements(self) -> list:
        """The ``DTensor`` placements, one per mesh dim: ``Shard`` on each
        split axis, ``_StridedShard`` on this one when it refines the same
        dim as ``outer`` and stands before ``outer``'s axis in the mesh
        (``DTensor`` splits in mesh order, the model-major nesting needs the
        stride), ``Replicate`` elsewhere."""
        from torch.distributed.tensor import Replicate, Shard

        names = list(self.mesh.mesh_dim_names)
        out = [Replicate() for _ in names]
        info = self
        while info is not None:
            outer = info.outer
            if (outer is not None and outer.dim == info.dim
                    and names.index(info.axis) < names.index(outer.axis)):
                from torch.distributed.tensor.placement_types import _StridedShard

                out[names.index(info.axis)] = _StridedShard(info.dim, split_factor=outer.size)
            else:
                out[names.index(info.axis)] = Shard(info.dim)
            info = outer
        return out

    def dtensor(self, local: torch.Tensor):
        """``local`` as a ``DTensor`` placed by :meth:`placements` (no copy:
        a tensor on another device type than the mesh's raises, as
        ``from_local`` would move it and in-place updates through the view
        would be lost)."""
        from torch.distributed.tensor import DTensor

        if local.device.type != self.mesh.device_type:
            raise ValueError(f"a {local.device.type} shard on a {self.mesh.device_type} mesh: "
                             "make the mesh on the parameters' device type")
        return DTensor.from_local(local, self.mesh, self.placements(), run_check=False)

    def spec(self) -> Tuple[Any, ...]:
        """The partition spec in torch's dims: the axis name at each split
        dim, a tuple of names (outermost first) where two split one dim."""
        spec: List[Any] = [None] * len(self.full_shape)
        for axis, dim in zip(self.axes, self._dims()):
            spec[dim] = axis if spec[dim] is None else (spec[dim], axis)
        return tuple(spec)

    def _dims(self) -> Tuple[int, ...]:
        return (self.dim,) if self.outer is None else self.outer._dims() + (self.dim,)


def shard_info(param: torch.Tensor) -> Optional[ShardInfo]:
    """The :class:`ShardInfo` of a sharded module parameter (None when it
    is replicated)."""
    return getattr(param, "_fsdp_shard", None)


def is_shard_placement(placement) -> bool:
    """True for a ``DTensor`` placement that splits a dim: ``Shard``, and
    the nested ``_StridedShard`` (which some torch versions do not count
    as a ``Shard``)."""
    return placement.is_shard() or type(placement).__name__ == "_StridedShard"


def sharded_axes(leaf) -> Tuple[str, ...]:
    """The mesh axes a ``DTensor`` leaf is sharded over (() for a plain
    tensor)."""
    placements = getattr(leaf, "placements", None)
    if placements is None:
        return ()
    names = leaf.device_mesh.mesh_dim_names
    return tuple(names[i] for i, p in enumerate(placements) if is_shard_placement(p))


def _local(leaf) -> torch.Tensor:
    return leaf.to_local() if hasattr(leaf, "to_local") else leaf


def shard_dim(shape: Sequence[int], axis_size: int, min_weight_size: int,
              transposed: bool = False) -> Optional[int]:
    """The torch dim JAX's ``shard_params`` splits a leaf on, or None to keep
    it replicated: the largest dim that the axis size divides (of two equal
    dims the later one, ``np.argsort(shape)[::-1]``), chosen in JAX's
    coordinates; ``transposed`` marks a ``Linear`` weight, the transpose of
    the flax kernel.  A leaf of ``min_weight_size`` elements or fewer, or
    with no divisible dim (a warning), stays replicated."""
    jax_shape = tuple(reversed(shape)) if transposed else tuple(shape)
    if int(np.prod(jax_shape)) <= min_weight_size:
        return None
    for dim in np.argsort(jax_shape)[::-1]:
        dim = int(dim)
        if jax_shape[dim] % axis_size == 0:
            return len(shape) - 1 - dim if transposed else dim
    logger.warning("could not shard parameter of shape %s over an axis of %d: no dim "
                   "divisible; keeping replicated", tuple(shape), axis_size)
    return None


class _GatherWithScatteredGrad(torch.autograd.Function):
    """All-gather shards (one collective over all of them, packed); the
    backward is a mean reduce-scatter in fp32 (one collective).

    ``apply(infos, *shards)`` -> one full tensor per shard.  Every info
    names the same axis group.  A shard with a ``main_grad`` attribute gets
    its gradient added there and None returned for it."""

    @staticmethod
    def forward(ctx, infos: List[ShardInfo], *shards):
        global fsdp_allgather_launches
        ctx.infos, ctx.shards = infos, shards
        size, group = infos[0].size, infos[0].group
        flat = torch.cat([s.reshape(-1) for s in shards]) if len(shards) > 1 \
            else shards[0].reshape(-1).contiguous()
        out = torch.empty(size * flat.numel(), dtype=flat.dtype, device=flat.device)
        _all_gather(out, flat, group=group)
        fsdp_allgather_launches += 1
        out = out.view(size, flat.numel())
        fulls, offset = [], 0
        for info, shard in zip(infos, shards):
            piece = out[:, offset:offset + shard.numel()].reshape(size, *shard.shape)
            fulls.append(piece.movedim(0, info.dim).reshape(info.full_shape))
            offset += shard.numel()
        return tuple(fulls)

    @staticmethod
    def backward(ctx, *grads):
        global fsdp_reducescatter_launches
        infos, shards = ctx.infos, ctx.shards
        size, group = infos[0].size, infos[0].group
        # [size, ...]: row r holds what rank r's slices receive
        packed = torch.cat([
            g.float().unflatten(info.dim, (size, info.local_shape[info.dim]))
             .movedim(info.dim, 0).reshape(size, -1)
            for g, info in zip(grads, infos)], dim=1)
        out = torch.empty(packed.shape[1], dtype=torch.float32, device=packed.device)
        _reduce_scatter(out, packed.view(-1), group=group)
        fsdp_reducescatter_launches += 1
        out.div_(size)
        results, offset = [], 0
        for shard in shards:
            piece = out[offset:offset + shard.numel()].view(shard.shape)
            offset += shard.numel()
            acc = getattr(shard, "main_grad", None)
            if acc is not None:
                acc.add_(piece)
                results.append(None)
            else:
                results.append(piece)
        return (None, *results)


def _gather(infos: List[ShardInfo], shards: List[torch.Tensor]) -> List[torch.Tensor]:
    """Full tensors of ``shards``: one gather per dtype."""
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, s in enumerate(shards):
        by_dtype.setdefault(s.dtype, []).append(i)
    fulls: List[Optional[torch.Tensor]] = [None] * len(shards)
    for idx in by_dtype.values():
        outs = _GatherWithScatteredGrad.apply([infos[i] for i in idx], *[shards[i] for i in idx])
        for i, full in zip(idx, outs):
            fulls[i] = full
    return fulls


def shard_params(params: Dict[str, torch.Tensor], axis_name: str,
                 min_weight_size: int = DEFAULT_MIN_WEIGHT_SIZE, *, mesh=None,
                 transposed: Sequence[str] = ()) -> Dict[str, Any]:
    """Slice each large tensor of ``params`` 1/N along one of its dims over
    ``axis_name`` of ``mesh`` (:func:`shard_dim`; names in ``transposed``
    are ``Linear`` weights): this rank's slice as a ``DTensor`` (a copy,
    so the full tensor can go), the others unchanged.  Identity when the
    axis is unbound; a ``DTensor`` already sharded on the axis is kept,
    with a warning."""
    bound = axis_group(mesh, axis_name)
    if bound is None:
        return params
    group, size, index = bound
    out = {}
    for name, value in params.items():
        if axis_name in sharded_axes(value):
            logger.warning("parameter %s already partitioned on %s; skipping", name, axis_name)
            out[name] = value
            continue
        dim = shard_dim(value.shape, size, min_weight_size, name in transposed)
        if dim is None:
            out[name] = value
            continue
        info = ShardInfo(mesh, axis_name, dim, tuple(value.shape), size, index, group)
        out[name] = info.dtensor(info.local(value.detach()).clone())
    return out


def _info_of_dtensor(leaf, axis_name: str) -> ShardInfo:
    """The split of ``leaf`` (a ``DTensor``) over ``axis_name`` alone: its
    local tensor's shape times the axis size at the split dim."""
    mesh = leaf.device_mesh
    names = mesh.mesh_dim_names
    dim = leaf.placements[names.index(axis_name)].dim
    group, size, index = axis_group(mesh, axis_name)
    shape = list(leaf.to_local().shape)
    shape[dim] *= size
    return ShardInfo(mesh, axis_name, dim, tuple(shape), size, index, group)


def gather_params(params: Dict[str, Any], axis_name: str) -> Dict[str, Any]:
    """Full tensors of the ``DTensor`` leaves of ``params`` sharded on
    ``axis_name`` (one gather per dtype; the backward reduce-scatters into
    their local tensors); other leaves unchanged.  Identity without such
    leaves: exported single-device params are already full."""
    names = [n for n, v in params.items() if axis_name in sharded_axes(v)]
    if not names:
        return params
    fulls = _gather([_info_of_dtensor(params[n], axis_name) for n in names],
                    [params[n].to_local() for n in names])
    return {**params, **dict(zip(names, fulls))}


class _FSDPUnit:
    """One wrapped module: its sharded parameters (owner module, attribute,
    info) and the hooks that gather them around the module's forward.  A
    parameter already split over another axis (a tensor-parallel slice) is
    split again by JAX's rule on its local shape, the tag nesting the two
    (the gather then restores the tensor-parallel slice)."""

    def __init__(self, module: nn.Module, axis_name: str, min_weight_size: int, mesh, bound):
        group, size, index = bound
        self.entries: List[Tuple[nn.Module, str, ShardInfo]] = []
        for owner_name, owner in module.named_modules():
            for attr, p in list(owner.named_parameters(recurse=False)):
                outer = shard_info(p)
                if outer is not None and axis_name in outer.axes:
                    logger.warning("parameter %s.%s already partitioned on %s; skipping",
                                   owner_name, attr, axis_name)
                    continue
                transposed = isinstance(owner, nn.Linear) and attr == "weight"
                dim = shard_dim(p.shape, size, min_weight_size, transposed)
                if dim is None:
                    continue
                info = ShardInfo(mesh, axis_name, dim, tuple(p.shape), size, index, group,
                                 outer=outer)
                with torch.no_grad():
                    local = nn.Parameter(info.narrow(p.detach()).clone(),
                                         requires_grad=p.requires_grad)
                local._fsdp_shard = info
                owner._parameters[attr] = local
                self.entries.append((owner, attr, info))
        self._saved: Optional[List[nn.Parameter]] = None
        module.register_forward_pre_hook(self._pre)
        module.register_forward_hook(self._post, always_call=True)

    def gather(self) -> List[torch.Tensor]:
        return _gather([info for _, _, info in self.entries],
                       [owner._parameters[attr] for owner, attr, _ in self.entries])

    def _pre(self, module, args):
        if not self.entries:
            return
        fulls = self.gather()
        self._saved = [owner._parameters[attr] for owner, attr, _ in self.entries]
        for (owner, attr, _), full in zip(self.entries, fulls):
            owner._parameters[attr] = full

    def _post(self, module, args, output):
        if self._saved is not None:
            for (owner, attr, _), p in zip(self.entries, self._saved):
                owner._parameters[attr] = p
            self._saved = None


def gather_module_params(module: nn.Module) -> Dict[str, torch.Tensor]:
    """``module``'s parameters by name, the sharded ones gathered (one
    gather per dtype; the backward reduce-scatters), for a caller that
    applies the weights itself: the chunked loss gathers the lm_head once
    for all its chunks (JAX's ``_lm_head_params``)."""
    params = dict(module.named_parameters())
    unit = getattr(module, "_fsdp_unit", None)
    if unit is None or not unit.entries:
        return params
    prefix = {id(m): n for n, m in module.named_modules()}
    names = [f"{prefix[id(owner)]}.{attr}".lstrip(".") for owner, attr, _ in unit.entries]
    return {**params, **dict(zip(names, unit.gather()))}


def shard_module_params(target: Union[nn.Module, Callable], axis_name: str = "data",
                        min_weight_size: int = DEFAULT_MIN_WEIGHT_SIZE, *, mesh=None):
    """Shard a module's parameters over ``axis_name`` of ``mesh`` in place
    (or wrap a module class or factory so each module it builds is
    sharded): each parameter :func:`shard_dim` splits becomes this rank's
    slice, and the module gathers them around every forward.  Names and
    the module's code stay as they are.  Identity when the axis is
    unbound (no mesh): the module keeps its full parameters."""
    if not isinstance(target, nn.Module):
        def build(*args, **kwargs):
            return shard_module_params(target(*args, **kwargs), axis_name, min_weight_size,
                                       mesh=mesh)
        return build
    bound = axis_group(mesh, axis_name)
    if bound is None:
        return target
    target._fsdp_unit = _FSDPUnit(target, axis_name, min_weight_size, mesh, bound)
    return target


def maybe_shard(target, config, mesh=None):
    """FSDP-wrap ``target`` iff ``config.fsdp``, over ``config.data_axis``
    with ``config.fsdp_min_size``: the one place the axis and size plumbing
    lives (callers: the block stack, the embedding and the lm_head)."""
    if getattr(config, "fsdp", False):
        return shard_module_params(target, config.data_axis, config.fsdp_min_size, mesh=mesh)
    return target


def sync_gradients(grads: Dict[str, Any], axis_names: Union[str, Sequence[str]],
                   psum_axes: Union[str, Sequence[str]] = (),
                   replicated_loss_axes: Union[str, Sequence[str]] = ("model",), *,
                   mesh=None) -> Dict[str, Any]:
    """Reduce each gradient in place over exactly the axes its parameter is
    replicated on, and return ``grads``.

    A plain (replicated) leaf is averaged over ``axis_names`` and summed
    over ``psum_axes``.  A ``DTensor`` leaf sharded on an axis is already
    per-rank correct there (the gather's backward reduce-scattered and
    divided); it is averaged and summed over the other axes only, and
    divided by the size of each axis of ``replicated_loss_axes`` that it is
    sharded on and that ``axis_names`` holds (every rank computed the same
    loss there, and the backward summed the ranks' copies of its
    cotangent: tensor parallelism's model axis).  A stage-owned leaf
    (``parallel/pp.py``'s tag) lives on one coordinate of its pipe axis
    and is reduced over the other axes only.  Leaves that take the
    same reductions take them together:
    views of one flat buffer take one ``all_reduce`` per bound axis
    (``parallel/dp.py:sync_gradients_dp``), and the sums over an axis of
    ``psum_axes`` one ``all_reduce`` of their packed values.  Unbound axes
    are skipped."""
    from tpu_parallel_torch.parallel.dp import _flat_base, sync_gradients_dp
    from tpu_parallel_torch.parallel.pp import stage_info

    if isinstance(axis_names, str):
        axis_names = (axis_names,)
    if isinstance(psum_axes, str):
        psum_axes = (psum_axes,)
    if isinstance(replicated_loss_axes, str):
        replicated_loss_axes = (replicated_loss_axes,)
    sizes = {a: b[1] for a in axis_names if (b := axis_group(mesh, a)) is not None}
    plans: Dict[tuple, Dict[str, torch.Tensor]] = {}
    for name, g in grads.items():
        names = sharded_axes(g)
        info = stage_info(g)
        if info is not None:
            names = names + (info.axis,)
        # a shard's mean skips the size-1 axes: no collective is needed there
        plan = (tuple(a for a in axis_names if a not in names
                      and not (names and sizes.get(a) == 1)),
                tuple(a for a in psum_axes if a not in names),
                tuple(a for a in replicated_loss_axes if a in names and a in axis_names))
        plans.setdefault(plan, {})[name] = _local(g)
    for (mean_axes, sum_axes, div_axes), leaves in plans.items():
        if mean_axes:
            sync_gradients_dp(leaves, mean_axes, mesh)
        for axis in sum_axes:
            bound = axis_group(mesh, axis)
            if bound is not None and bound[1] > 1:
                tensors = list(leaves.values())
                flat = _flat_base(leaves)
                packed = flat if flat is not None else torch.cat([t.reshape(-1) for t in tensors])
                dist.all_reduce(packed, group=bound[0])
                if flat is None:
                    parts = packed.split([t.numel() for t in tensors])
                    torch._foreach_copy_(tensors, [c.view_as(t) for c, t in zip(parts, tensors)])
        for axis in div_axes:
            bound = axis_group(mesh, axis)
            if bound is not None:
                torch._foreach_div_(list(leaves.values()), float(bound[1]))
    return grads
