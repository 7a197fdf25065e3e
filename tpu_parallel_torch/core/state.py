"""Train state and batch containers: the port of ``tpu_parallel/core/state.py``.

The JAX ``TrainState`` is an immutable pytree of fp32 params, optimizer
state, a PRNG key and an optional EMA shadow.  Here it is a mutable object
updated in place, which keeps one copy of each buffer: the module (weights
in ``config.dtype``, what the forward reads), fp32 master weights, fp32
gradient accumulators and the fp32 EMA shadow.  :meth:`TrainState.state_dict`
is the checkpoint's view of it and :meth:`TrainState.load` writes one back
in place, so every buffer keeps its address.  The gradient accumulators
of replicated parameters are views into one flat fp32 buffer
(``flat_grads``), so a data-parallel step syncs them with one collective
and no copy.

Under FSDP (``parallel/fsdp.py``) a sharded module parameter is this rank's
slice, and so are its master, accumulator, optimizer moments and EMA
shadow: every such tensor of the state holds this rank's slice only, and
:meth:`TrainState.partitioned` views them as ``DTensor`` shards.  Under
pipeline parallelism (``parallel/pp.py``) the module holds this rank's
stage plus the leaves replicated over ``pipe``; the state's tensors for a
stage-owned parameter carry its ``pp.StageInfo`` tag (``stages``), so the
gradient sync, the clip and the checkpoints know which axes it lives on.

Every module parameter of a state carries its fp32 accumulator as its
``main_grad``; :func:`fold_grads` adds a backward's ``.grad`` there.  It is
the one way gradients reach the accumulators: after each minibatch
(:meth:`TrainState.accumulate_grads`) and, inside the pipeline schedules,
after each microbatch's backward.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Callable, Dict, Iterable, Iterator, Optional

import torch
from torch import nn


def map_tensors(fn: Callable[[torch.Tensor], Any], tree):
    """``tree`` (dicts, lists and tuples of tensors and plain values) with
    ``fn`` applied to every tensor; other leaves are kept as they are."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tensors(fn, v) for v in tree)
    return tree


def _local(t):
    return t.to_local() if hasattr(t, "to_local") else t


def _load_tree(dst, src, path: str):
    """Copy ``src``'s tensors into ``dst``'s in place (same structure,
    shapes and dtypes, else ``ValueError`` naming the path); returns what
    takes ``dst``'s place (``dst`` itself for tensors and containers).
    ``DTensor`` leaves on either side count as their local tensors."""
    if isinstance(dst, torch.Tensor):
        dst, src = _local(dst), _local(src)
        if not isinstance(src, torch.Tensor) or src.shape != dst.shape or src.dtype != dst.dtype:
            got = (tuple(src.shape), src.dtype) if isinstance(src, torch.Tensor) else type(src)
            raise ValueError(f"{path}: checkpoint has {got}, the state {tuple(dst.shape)} "
                             f"{dst.dtype}")
        dst.copy_(src)
        return dst
    if isinstance(dst, dict):
        if not isinstance(src, dict) or set(src) != set(dst):
            raise ValueError(f"{path}: checkpoint keys differ from the state's")
        for k in dst:
            dst[k] = _load_tree(dst[k], src[k], f"{path}.{k}")
        return dst
    if isinstance(dst, (list, tuple)):
        if not isinstance(src, (list, tuple)) or len(src) != len(dst):
            raise ValueError(f"{path}: checkpoint structure differs from the state's")
        items = [_load_tree(d, s, f"{path}[{i}]") for i, (d, s) in enumerate(zip(dst, src))]
        if isinstance(dst, list):
            dst[:] = items
            return dst
        return tuple(items)
    if type(src) is not type(dst):
        raise ValueError(f"{path}: checkpoint has {type(src).__name__}, the state "
                         f"{type(dst).__name__}")
    return src


def _rows(batch, start: int, stop: int):
    """Rows [start, stop) of every field of a batch dataclass (views)."""
    return type(batch)(**{
        f.name: None if getattr(batch, f.name) is None else getattr(batch, f.name)[start:stop]
        for f in dataclasses.fields(batch)
    })


@dataclasses.dataclass
class Batch:
    """Generic supervised batch: ``inputs`` [batch, ...] and integer
    ``labels`` [batch]."""

    inputs: torch.Tensor
    labels: torch.Tensor

    @property
    def size(self) -> int:
        return self.inputs.shape[0]

    def rows(self, start: int, stop: int) -> "Batch":
        """Rows [start, stop) of both fields (views, no copy)."""
        return _rows(self, start, stop)


@dataclasses.dataclass
class TextBatch:
    """Language-modeling batch: token ids plus next-token targets, all
    [batch, seq].  ``segment_ids``/``positions`` support packed sequences;
    ``loss_mask`` zeroes padding out of the loss."""

    tokens: torch.Tensor
    targets: torch.Tensor
    loss_mask: Optional[torch.Tensor] = None
    segment_ids: Optional[torch.Tensor] = None
    positions: Optional[torch.Tensor] = None

    @property
    def size(self) -> int:
        return self.tokens.shape[0]

    def rows(self, start: int, stop: int) -> "TextBatch":
        """Rows [start, stop) of every field (views, no copy)."""
        return _rows(self, start, stop)

    def cols(self, start: int, stop: int) -> "TextBatch":
        """Token positions [start, stop) of every field: a sequence block
        (views, no copy)."""
        return TextBatch(**{f.name: None if getattr(self, f.name) is None
                            else getattr(self, f.name)[:, start:stop]
                            for f in dataclasses.fields(self)})


def _flat_views(tensors: Dict[str, torch.Tensor], device):
    """One zeroed fp32 buffer holding a tensor shaped like each of
    ``tensors``, in order: ``(buffer, {name: view})``."""
    flat = torch.zeros(sum(t.numel() for t in tensors.values()), dtype=torch.float32,
                       device=device)
    views, offset = {}, 0
    for name, t in tensors.items():
        views[name] = flat[offset:offset + t.numel()].view(t.shape)
        offset += t.numel()
    return flat, views


def get_num_params(state_or_model: Any) -> int:
    """Total parameter count of a module or a :class:`TrainState`, sharded
    parameters at their full size."""
    from tpu_parallel_torch.parallel.fsdp import shard_info

    model = getattr(state_or_model, "model", state_or_model)
    total = 0
    for p in model.parameters():
        info = shard_info(p)
        total += p.numel() if info is None else math.prod(info.global_shape)
    return total


def fold_grads(params: Iterable[torch.Tensor]) -> None:
    """Add each parameter's ``.grad`` into its fp32 ``main_grad`` (the
    accumulator :class:`TrainState` gives it) and clear it, so gradients
    sum over minibatches and microbatches in fp32.  A parameter without
    a ``.grad`` (an FSDP slice, whose gather's backward adds into the
    accumulator itself) or without a ``main_grad`` is left as it is."""
    accs, new = [], []
    for p in params:
        acc = getattr(p, "main_grad", None)
        if acc is not None and p.grad is not None:
            accs.append(acc)
            new.append(p.grad)
            p.grad = None
    if accs:
        torch._foreach_add_(accs, new)


@dataclasses.dataclass
class TrainState:
    """A module, its fp32 master weights and gradient accumulators, the
    optimizer and its state, an explicit ``torch.Generator`` and, when EMA is
    on, the fp32 shadow of the masters (``ema_params``, by name; None when
    off; evaluation prefers it).

    flax keeps fp32 params and casts them to ``config.dtype`` at each use;
    its gradient is the ``config.dtype`` cotangent cast back to fp32.  Here
    the module holds the cast weights; each backward writes ``.grad`` in
    their dtype, :meth:`accumulate_grads` adds it into ``grads`` (fp32) and
    clears it, and :meth:`apply_gradients` updates ``params`` and writes them
    back into the module rounded to its dtype.  fp32 module weights (the
    LayerNorms, or every weight of an fp32 config) are their own masters.
    ``grads`` are views into ``flat_grads``, one fp32 buffer in parameter
    order, for the replicated parameters.  Each module parameter's
    ``main_grad`` is its accumulator (:func:`fold_grads`).

    An FSDP-sharded module parameter (``shards`` maps its name to its
    ``ShardInfo``) holds this rank's slice, and so do its master, its
    accumulator and the optimizer's and EMA's tensors for it.  Its
    accumulator is a view of a second fp32 buffer, set as the parameter's
    ``main_grad``: the gather's backward adds the reduce-scattered fp32
    gradient there, never rounded to the module's dtype.
    """

    model: nn.Module
    tx: Any  # an in-place transformation with init/update (core.optim)
    params: Dict[str, torch.Tensor]
    grads: Dict[str, torch.Tensor]
    opt_state: Any
    rng: torch.Generator
    step: int = 0
    ema_params: Optional[Dict[str, torch.Tensor]] = None
    flat_grads: Optional[torch.Tensor] = None
    shards: Dict[str, Any] = dataclasses.field(default_factory=dict)
    stages: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @classmethod
    def create(cls, model: nn.Module, tx, rng: torch.Generator,
               params: Optional[Dict[str, torch.Tensor]] = None) -> "TrainState":
        """Masters from ``params`` (fp32 values by parameter name, e.g. the
        draws of ``init_params`` or ``params_from_jax(..., dtype=float32)``;
        full tensors, sliced here for sharded parameters) or, without them,
        from the module's own values."""
        from tpu_parallel_torch.parallel.fsdp import shard_info
        from tpu_parallel_torch.parallel.pp import stage_info, tag_stage

        masters, shards = {}, {}
        module = dict(model.named_parameters())
        with torch.no_grad():
            for name, p in module.items():
                info = shard_info(p)
                value = None
                if params is not None:
                    value = params[name] if info is None else info.local(params[name])
                    p.copy_(value)
                if info is not None:
                    shards[name] = info
                if p.dtype == torch.float32:
                    master = p.detach()
                else:
                    master = (value if value is not None else p).detach().to(
                        device=p.device, dtype=torch.float32, copy=True)
                masters[name] = master
        device = next(iter(module.values())).device
        flat, grads = _flat_views({n: m for n, m in masters.items() if n not in shards}, device)
        if shards:
            _, sharded = _flat_views({n: masters[n] for n in shards}, device)
            grads = {n: grads[n] if n in grads else sharded[n] for n in masters}
        stages = {n: info for n, p in module.items() if (info := stage_info(p)) is not None}
        for name, info in stages.items():
            tag_stage(masters[name], info)
            tag_stage(grads[name], info)
        for name, p in module.items():
            p.main_grad = grads[name]
        return cls(model=model, tx=tx, params=masters, grads=grads,
                   opt_state=tx.init(masters), rng=rng, flat_grads=flat, shards=shards,
                   stages=stages)

    def partitioned(self, tree):
        """``tree`` (a dict by parameter name, or a structure holding such
        dicts, like the optimizer state) with each sharded parameter's
        tensor viewed as a ``DTensor`` shard, the counterpart of
        ``nn.Partitioned`` (no copy; other values as they are), and each
        stage-owned one tagged with its ``pp.StageInfo``.  Without shards
        or stages, ``tree`` itself."""
        if not self.shards and not self.stages:
            return tree
        if isinstance(tree, dict):
            if tree.keys() == self.params.keys():
                from tpu_parallel_torch.parallel.pp import tag_stage

                return {n: tag_stage(self.shards[n].dtensor(v) if n in self.shards else v,
                                     self.stages.get(n))
                        for n, v in tree.items()}
            return {k: self.partitioned(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(self.partitioned(v) for v in tree)
        return tree

    def zero_grads(self) -> None:
        torch._foreach_zero_(list(self.grads.values()))

    def accumulate_grads(self) -> None:
        """Add each parameter's ``.grad`` into its fp32 accumulator and clear it."""
        fold_grads(self.model.parameters())

    @torch.no_grad()
    def apply_gradients(self, grads: Dict[str, torch.Tensor]) -> None:
        """One optimizer step on the masters from ``grads`` (consumed in
        place), then the masters into the module.  The transformation gets
        a new dict, the sharded gradients in it as ``DTensor`` views (the
        clip's norm reads them); it may rebind its entries, never
        ``grads``'s own, so the accumulators stay views of their buffers."""
        updates, self.opt_state = self.tx.update(self.partitioned(dict(grads)), self.opt_state,
                                                 self.params)
        names = list(self.params)
        torch._foreach_add_([self.params[n] for n in names],
                            [_local(updates[n]) for n in names])
        self._masters_to_module()
        self.step += 1

    @torch.no_grad()
    def _masters_to_module(self) -> None:
        """Write the masters into the module's non-fp32 weights, rounded."""
        module = dict(self.model.named_parameters())
        cast = [n for n in self.params if module[n].dtype != torch.float32]
        if cast:
            torch._foreach_copy_([module[n].data for n in cast], [self.params[n] for n in cast])

    @torch.no_grad()
    def seed_ema(self) -> None:
        """Start the EMA shadow as a copy of the masters."""
        self.ema_params = {n: p.clone() for n, p in self.params.items()}

    @contextlib.contextmanager
    def ema_weights(self) -> Iterator[None]:
        """Inside, the module holds the EMA shadow's weights (when one is
        kept; evaluation prefers it); after, bitwise its own again."""
        if self.ema_params is None:
            yield
            return
        params = dict(self.model.named_parameters())
        saved = {n: p.detach().clone() for n, p in params.items()}
        with torch.no_grad():
            torch._foreach_copy_([params[n].data for n in self.ema_params],
                                 list(self.ema_params.values()))
        try:
            yield
        finally:
            with torch.no_grad():
                torch._foreach_copy_([params[n].data for n in saved], list(saved.values()))

    @torch.no_grad()
    def update_ema(self, decay: float) -> None:
        """e = e * decay + p * (1 - decay) over the masters, in JAX's order
        (``tpu_parallel/parallel/spmd.py``'s ``ema_update``)."""
        names = list(self.ema_params)
        ema = [self.ema_params[n] for n in names]
        torch._foreach_mul_(ema, decay)
        torch._foreach_add_(ema, torch._foreach_mul([self.params[n] for n in names], 1 - decay))

    def state_dict(self) -> Dict[str, Any]:
        """The checkpoint's view: the masters, the optimizer state, the step,
        the generator's ``get_state()`` and the EMA shadow (None when off).
        Tensors are the state's own (no copy); sharded ones are ``DTensor``
        views (:meth:`partitioned`)."""
        return dict(step=self.step, params=self.partitioned(self.params),
                    opt_state=self.partitioned(self.opt_state), rng=self.rng.get_state(),
                    ema_params=self.partitioned(self.ema_params))

    @torch.no_grad()
    def load(self, state: Dict[str, Any]) -> None:
        """Write a :meth:`state_dict` back IN PLACE: every tensor is copied
        into the buffer it came from (so addresses hold), the generator's
        state is set, the module's weights are rewritten from the masters,
        and a half-done step's gradients (accumulators and ``.grad``) are
        cleared.  The structure must match, EMA included (``ValueError``);
        ``checkpoint.Checkpointer.restore`` absorbs an EMA turned on or off."""
        if set(state) != {"step", "params", "opt_state", "rng", "ema_params"}:
            raise ValueError(f"not a TrainState.state_dict: keys {sorted(state)}")
        if (state["ema_params"] is None) != (self.ema_params is None):
            raise ValueError("the checkpoint's ema_params and the state's differ in presence")
        _load_tree(self.params, state["params"], "params")
        self.opt_state = _load_tree(self.opt_state, state["opt_state"], "opt_state")
        if self.ema_params is not None:
            _load_tree(self.ema_params, state["ema_params"], "ema_params")
        self.step = int(state["step"])
        self.rng.set_state(state["rng"])
        self._masters_to_module()
        self.zero_grads()
        for p in self.model.parameters():
            p.grad = None
