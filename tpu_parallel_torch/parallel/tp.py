"""Megatron-style tensor parallelism over a mesh axis: the port of
``tpu_parallel/parallel/tp.py``.

Every rank runs its own program.  A tensor-parallel module holds this
rank's slice of each split weight as an ordinary parameter under the
single-device name (``attn.qkv.weight``), tagged with a
``fsdp.ShardInfo`` on the model axis and the torch dim it splits
(:func:`shard_module`, the counterpart of ``ModuleShard``): the state, the
clip, the checkpoints and the export read the tag as they read an FSDP
shard's.  The stacked ``[tp, ...]`` layout of JAX's ``stack_params`` /
``unstack_params`` lives only in the bridge, ``models/convert.py``.

:class:`TPDense` is the column (``full -> sharded`` features) or row
(``sharded -> full`` through one all-reduce) projection; a column ->
nonlinearity -> row pair is one forward all-reduce per block
(:class:`TPMLP`).  The collectives follow JAX's ``shard_map`` with
``check_vma=False`` literally: the row layer's all-reduce has an
all-reduce as its backward (``psum`` transposes to ``psum``), so every
gradient upstream of a row layer comes out ``tp`` times too large on each
rank and ``fsdp.sync_gradients`` divides model-partitioned gradients by
the axis size (``replicated_loss_axes``) while the replicated ones are
averaged over the model axis (the Trainer's ``grad_sync_axes=("data",
"model")``).

The collectives are custom ops (``tpu_parallel_torch::tp_all_reduce``,
``tp_all_gather`` and the gather's transpose ``tp_reduce_scatter``), each
adding one to :data:`tp_allreduce_launches`,
:data:`tp_allgather_launches` or :data:`tp_reducescatter_launches` where
it runs.  Being single ops with a
fresh output, the selective-checkpoint policies can keep their outputs:
under ``remat_policy`` ``"proj"`` and ``"proj_attn"`` the backward's
recompute serves the row layer's all-reduce from the saved value and
launches no forward collective, as JAX names ``"proj"`` after the
``psum``.  An axis of size 1, or one the mesh does not bind (no mesh),
is plain dense compute with no collective and no tag.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from tpu_parallel_torch.core.rng import fold_rng_over_axis
from tpu_parallel_torch.parallel.fsdp import (ShardInfo, _reduce_scatter, gather_params,
                                              sharded_axes)
from tpu_parallel_torch.runtime.mesh import axis_group

# collectives launched over the model axis (forward, recompute and
# backward alike), by kind
tp_allreduce_launches = 0
tp_allgather_launches = 0
tp_reducescatter_launches = 0

# process groups by name, for the custom ops (their schema takes a string)
_GROUPS: Dict[str, Any] = {}
_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}


def _group_name(group) -> str:
    name = group.group_name
    _GROUPS[name] = group
    return name


@torch.library.custom_op("tpu_parallel_torch::tp_all_reduce", mutates_args=())
def _all_reduce_op(x: torch.Tensor, group: str, op: str) -> torch.Tensor:
    global tp_allreduce_launches
    out = x.contiguous().clone()
    dist.all_reduce(out, op=_REDUCE_OPS[op], group=_GROUPS[group])
    tp_allreduce_launches += 1
    return out


@_all_reduce_op.register_fake
def _(x, group, op):
    return torch.empty_like(x, memory_format=torch.contiguous_format)


def _all_reduce_setup(ctx, inputs, output):
    ctx.group, ctx.op = inputs[1], inputs[2]


def _all_reduce_backward(ctx, grad):
    if ctx.op != "sum":
        raise RuntimeError(f"an all-reduce {ctx.op} has no gradient: stop its input "
                           "(JAX's pmax/pmin have no differentiation rule)")
    # psum transposes to psum (shard_map without the replication checker)
    return _all_reduce_op(grad, ctx.group, "sum"), None, None


_all_reduce_op.register_autograd(_all_reduce_backward, setup_context=_all_reduce_setup)


@torch.library.custom_op("tpu_parallel_torch::tp_all_gather", mutates_args=())
def _all_gather_op(x: torch.Tensor, group: str, size: int) -> torch.Tensor:
    """Tiled gather along the last dim: the ranks' slices side by side."""
    global tp_allgather_launches
    flat = x.contiguous().reshape(-1)
    out = torch.empty(size * flat.numel(), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, flat, group=_GROUPS[group])
    tp_allgather_launches += 1
    n = x.shape[-1]
    return out.view(size, -1, n).movedim(0, 1).reshape(*x.shape[:-1], size * n)


@_all_gather_op.register_fake
def _(x, group, size):
    return x.new_empty(*x.shape[:-1], size * x.shape[-1])


@torch.library.custom_op("tpu_parallel_torch::tp_reduce_scatter", mutates_args=())
def _reduce_scatter_op(x: torch.Tensor, group: str, size: int) -> torch.Tensor:
    """Tiled sum-scatter along the last dim: rank r gets the sum over ranks
    of columns ``[r * n, (r + 1) * n)``, ``n = x.shape[-1] // size``."""
    global tp_reducescatter_launches
    n = x.shape[-1] // size
    # [size, rows, n]: block r is what rank r receives
    packed = x.reshape(-1, size, n).movedim(1, 0).contiguous()
    out = torch.empty(packed[0].numel(), dtype=x.dtype, device=x.device)
    _reduce_scatter(out, packed.view(-1), group=_GROUPS[group])
    tp_reducescatter_launches += 1
    return out.view(*x.shape[:-1], n)


@_reduce_scatter_op.register_fake
def _(x, group, size):
    return x.new_empty(*x.shape[:-1], x.shape[-1] // size)


def _all_gather_setup(ctx, inputs, output):
    ctx.group, ctx.size = inputs[1], inputs[2]


def _all_gather_backward(ctx, grad):
    # a tiled all_gather transposes to a psum_scatter: the sum over ranks
    # of this rank's columns
    return _reduce_scatter_op(grad, ctx.group, ctx.size), None, None


_all_gather_op.register_autograd(_all_gather_backward, setup_context=_all_gather_setup)


def model_axis(mesh, axis_name: str = "model"):
    """``(group, size, index)`` of ``axis_name`` when ``mesh`` binds it above
    size 1, else None: the tensor-parallel code runs dense without it."""
    bound = axis_group(mesh, axis_name)
    return bound if bound is not None and bound[1] > 1 else None


def axis_size_or_none(mesh, axis_name: str) -> Optional[int]:
    """Size of ``axis_name`` on ``mesh``, or None when the mesh does not bind
    it (no mesh): JAX's ``axis_size_or_none`` outside ``shard_map``."""
    bound = axis_group(mesh, axis_name)
    return None if bound is None else bound[1]


def all_reduce(x: torch.Tensor, axis_name: str, mesh, op: str = "sum") -> torch.Tensor:
    """``op`` ("sum", "max" or "min") over ``axis_name`` of ``mesh`` into a
    new tensor (``lax.psum`` / ``pmax`` / ``pmin``); the sum's backward is
    a sum.  Identity on an axis of size 1 or an unbound one."""
    bound = model_axis(mesh, axis_name)
    if bound is None:
        return x
    return _all_reduce_op(x, _group_name(bound[0]), op)


def all_gather(x: torch.Tensor, axis_name: str, mesh) -> torch.Tensor:
    """The ranks' ``x`` side by side along the last dim, in axis order
    (``lax.all_gather(..., axis=-1, tiled=True)``); the backward is a
    reduce-scatter: the sum over the ranks of this rank's columns.  Identity on an
    axis of size 1 or an unbound one."""
    bound = model_axis(mesh, axis_name)
    if bound is None:
        return x
    return _all_gather_op(x, _group_name(bound[0]), bound[1])


def split_over_axis(x: torch.Tensor, axis_name: str, axis: int = -1, mesh=None) -> torch.Tensor:
    """This rank's slice of ``x`` along ``axis`` (a view), as JAX's
    ``split_over_axis``; raises ``ValueError`` when the axis size does not
    divide it.  Identity on an unbound axis."""
    bound = axis_group(mesh, axis_name)
    if bound is None:
        return x
    _, size, index = bound
    if x.shape[axis] % size != 0:
        raise ValueError(
            f"cannot split axis of size {x.shape[axis]} evenly over "
            f"{axis_name}; remainder features would be silently dropped"
        )
    n = x.shape[axis] // size
    return x.narrow(axis, index * n, n)


def shard_module(module: nn.Module, dims: Dict[str, int], axis_name: str, mesh) -> nn.Module:
    """Tag ``module``'s parameters named in ``dims`` (already at this rank's
    local shape) as slices of torch dim ``dims[name]`` over ``axis_name``
    of ``mesh``: the counterpart of ``ModuleShard``.  The tag is the
    ``fsdp.ShardInfo`` the state, the clip and the checkpoints read.  No
    tag on an axis of size 1 or an unbound one."""
    bound = model_axis(mesh, axis_name)
    if bound is None:
        return module
    group, size, index = bound
    for name, dim in dims.items():
        p = getattr(module, name)
        full = list(p.shape)
        full[dim] *= size
        p._fsdp_shard = ShardInfo(mesh, axis_name, dim, tuple(full), size, index, group)
    return module


def _lecun_normal_(value: torch.Tensor, fan_in: int, generator: torch.Generator,
                   scale: float = 1.0) -> None:
    """flax's ``lecun_normal``: a normal truncated at two std, std
    sqrt(1/fan_in) / .8796, times ``scale``."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    torch.nn.init.trunc_normal_(value, 0.0, std, -2 * std, 2 * std, generator=generator)
    value.mul_(scale)


class TPDense(nn.Linear):
    """Tensor-parallel ``Linear`` over ``axis_name`` of ``mesh``.

    styles:
      - ``"column"``: input replicated, output feature-sharded (each rank
        computes ``features // tp`` outputs: its rows of the dense
        ``[features, in]`` weight and of the bias); ``gather_output=True``
        all-gathers the result back to full features (the lm_head).
      - ``"row"``: input feature-sharded (``split_input=True`` slices a
        replicated input instead), output full features through one
        all-reduce.  The bias is a replicated parameter added after the
        sum, so it counts once whatever the degree.

    ``features`` is the global output width, ``in_features`` the global
    input width.  Without the axis (no mesh, or size 1) it is a plain
    ``Linear``.  With a ``generator`` the weights start as JAX's
    ``TPDense`` init (:meth:`reset_from`); without one, as ``Linear``'s.
    ``GPTLM`` takes neither: it draws the dense init and slices it
    (``models/convert.py:init_params``), so a model split over the axis
    holds the weights of the one-device model of the same seed.
    """

    def __init__(self, in_features: int, features: int, *, style: str = "column",
                 axis_name: str = "model", use_bias: bool = True, gather_output: bool = False,
                 split_input: bool = False, dtype=None, device=None, mesh=None,
                 generator: Optional[torch.Generator] = None):
        if style not in ("column", "row"):
            raise ValueError(f"unknown TPDense style: {style!r}")
        bound = model_axis(mesh, axis_name)
        tp = 1 if bound is None else bound[1]
        if style == "column" and features % tp:
            raise ValueError(f"column-parallel features={features} not divisible by tp={tp}")
        if style == "row" and in_features % tp:
            raise ValueError(f"row-parallel in_features={in_features} not divisible by tp={tp}")
        local_in = in_features // tp if style == "row" else in_features
        local_out = features // tp if style == "column" else features
        super().__init__(local_in, local_out, bias=use_bias, dtype=dtype, device=device)
        self.style, self.axis_name, self.mesh, self.tp = style, axis_name, mesh, tp
        self.gather_output, self.split_input = gather_output, split_input
        dims = {"weight": 0, "bias": 0} if style == "column" else {"weight": 1}
        shard_module(self, {n: d for n, d in dims.items() if getattr(self, n) is not None},
                     axis_name, mesh)
        if generator is not None:
            self.reset_from(generator)

    @torch.no_grad()
    def reset_from(self, generator: torch.Generator) -> None:
        """Redraw the weights as JAX's ``TPDense`` under ``ModuleShard``
        does: lecun-normal on this rank's slice from ``generator`` folded
        over the axis (each rank its own draws), the row kernel scaled by
        1/sqrt(tp) so its init statistics do not depend on the degree,
        biases 0.  The standalone layers' init, held to JAX's
        ``tests/test_tp.py``; ``GPTLM`` does not draw through it."""
        gen = fold_rng_over_axis(generator, self.axis_name, self.mesh) if self.tp > 1 else generator
        w = torch.empty(self.weight.shape, dtype=torch.float32)
        _lecun_normal_(w, w.shape[1], gen, 1.0 / math.sqrt(self.tp) if self.style == "row" else 1.0)
        self.weight.copy_(w)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.style == "column":
            y = F.linear(x, self.weight, self.bias)
            return all_gather(y, self.axis_name, self.mesh) if self.gather_output else y
        if self.split_input:
            x = split_over_axis(x, self.axis_name, -1, self.mesh)
        if self.tp == 1:
            return F.linear(x, self.weight, self.bias)
        y = all_reduce(F.linear(x, self.weight), self.axis_name, self.mesh)
        return y if self.bias is None else y + self.bias


class TPMLP(nn.Module):
    """Megatron MLP block: column-parallel ``up``, activation, row-parallel
    ``down``: one forward all-reduce per block."""

    def __init__(self, in_features: int, hidden_features: int, out_features: int, *,
                 axis_name: str = "model", activation: Callable = F.gelu, dtype=None,
                 device=None, mesh=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.activation = activation
        self.up = TPDense(in_features, hidden_features, style="column", axis_name=axis_name,
                          dtype=dtype, device=device, mesh=mesh, generator=generator)
        self.down = TPDense(hidden_features, out_features, style="row", axis_name=axis_name,
                            dtype=dtype, device=device, mesh=mesh, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down(self.activation(self.up(x)))


def export_single_device_params(params: Dict[str, Any],
                                fsdp_axes: Sequence[str] = ("data",)) -> Dict[str, torch.Tensor]:
    """Mesh-trained params (by name; ``DTensor`` shards, e.g. a state's
    ``partitioned(state.params)``) in the mesh-free module layout: each leaf
    sharded only over ``fsdp_axes`` (FSDP slices of a real dim) becomes its
    full tensor, gathered with ``fsdp.gather_params`` (one all-gather per
    axis and dtype; a collective, so every rank of the mesh calls this
    together), and plain tensors pass as they are.  A leaf split over any
    other axis above 1 (tensor or pipeline parallelism) raises JAX's
    ``ValueError``: such weights live divided across ranks by design, and
    serve under the mesh (``models.generate.generate_sharded``)."""
    by_axis: Dict[str, Dict[str, Any]] = {}
    for name, leaf in params.items():
        axes = sharded_axes(leaf)
        mesh = getattr(leaf, "device_mesh", None)
        for axis in axes:
            size = mesh.size(mesh.mesh_dim_names.index(axis))
            if axis in fsdp_axes or size == 1:
                continue
            raise ValueError(
                f"parameter {name} is split over mesh axis {axis!r} (size {size}); export "
                "requires tp/pipe degree 1 — run inference under the mesh instead. "
                f"(If {axis!r} is a RENAMED data axis used for FSDP, pass "
                f"fsdp_axes=({axis!r},) to export it.)")
        if axes:
            by_axis.setdefault(axes[0], {})[name] = leaf
    out = dict(params)
    with torch.no_grad():
        for axis, leaves in by_axis.items():
            out.update(gather_params(leaves, axis))
    return out
