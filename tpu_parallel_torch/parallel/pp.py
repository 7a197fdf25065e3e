"""Pipeline parallelism over a ``pipe`` mesh axis: the port of
``tpu_parallel/parallel/pp.py``.

JAX runs every pipe rank in lockstep under ``shard_map``: each tick every
rank applies its stage, bubble ticks compute on zeros that the schedule
masks, and ``lax.ppermute`` moves activations one rank along the ring.
Here each pipe rank is its own process, so it keeps JAX's static
schedules (the same tick tables) but not the lockstep: a rank reads the
table on the host and runs only the ticks where it holds a real
microbatch.  A skipped bubble changes no number, since JAX masks it to
exactly zero.  Activations and their gradients move by
``dist.batch_isend_irecv`` pairs that every rank derives from the one
table (:func:`_exchange`): at tick ``t`` a rank posts its send of tick
``t`` together with its receive for tick ``t + 1``, so the exchanges of
one tick complete on every rank before any rank needs tick ``t + 1``'s
input, and no rank waits on a peer that waits on it.  Each send adds one
to :data:`pp_send_launches`, each receive one to
:data:`pp_recv_launches`.  Gloo's point-to-point ops hand the tensor's
data pointer to the TCP transport, which cannot read device memory, so
over gloo a CUDA tensor is staged through a host buffer
(``runtime/comm.py:post_exchange``; the transport,
not the compute: the stages run on the device); NCCL takes device
tensors directly.

Stage ownership is by construction: a rank builds only its own layers
(:class:`PipelineModule`, ``models/gpt.py``), each parameter tagged with a
:class:`StageInfo` (:func:`stage_info`).  The state, the gradient sync, the
clip and the checkpoints read the tag: a stage-owned leaf is reduced over
the other axes only, its square norm is summed over ``pipe``, and every
rank checkpoints its own keys.

The schedules:

- GPipe (:func:`execute_pipeline`): ``m + n - 1`` ticks, rank ``r`` on
  microbatch ``t - r``.
- Interleaved (:func:`execute_interleaved_pipeline`): rank ``r``'s virtual
  stage ``j`` is global chunk ``j * n + r``; microbatch ``i`` enters at
  ``inject_tick(i)`` and rank ``r`` holds it at tick ``t`` with
  ``j = ((t - r) mod vn) // n``.  GPipe is its ``interleave=1`` case.
  Both differentiate through the forward schedule as JAX's AD does: the
  forward is one autograd function whose backward walks the table in
  reverse, receiving each output's gradient from rank ``r + 1``,
  back-propagating the saved stage output and sending the input's
  gradient to rank ``r - 1``.  No autograd graph crosses a process.
- 1F1B (:func:`pipeline_1f1b_grads`): rank ``r`` forwards microbatch
  ``i`` at tick ``i + r`` (without a graph) and runs its backward at tick
  ``i + 2n - 2 - r``, recomputing the stage from the input saved in a
  ``2n - 1``-slot ring, as JAX's ``jax.vjp`` replay does.
- Decode (:func:`execute_pipeline_decode`): rank ``r`` runs its stage at
  tick ``r`` and the last rank's output is broadcast over the axis.

``pass_validity`` serves MoE's balance loss.  JAX runs every stage at
every tick and hands it an ``aux_scale`` of 0.0 on a bubble, so the garbage
it computes there sows exactly 0.  A rank here runs only its real ticks,
each with a ``moe_losses`` list, and the schedule returns JAX's per-tick
table beside its output: one entry per schedule tick, the stage's summed
balance on a real tick and exactly 0 on a bubble.  The table is
differentiable: its gradient reaches each tick's routers in the reverse
walk.  :func:`execute_pipeline_step` is JAX's lockstep tick (every rank at
every tick, bubbles skipped and zero), kept for callers of JAX's API that
drive a schedule tick by tick; the model's path is
:func:`execute_interleaved_pipeline`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from tpu_parallel_torch.core.rng import fold_seed
from tpu_parallel_torch.core.state import fold_grads
from tpu_parallel_torch.runtime.comm import post_exchange
from tpu_parallel_torch.runtime.mesh import axis_group

# point-to-point operations posted by the schedules (forward, backward and
# decode alike), by direction
pp_send_launches = 0
pp_recv_launches = 0

@dataclasses.dataclass(frozen=True, eq=False)
class StageInfo:
    """A stage-owned parameter: it lives on the ranks at coordinate
    ``index`` of mesh axis ``axis`` (``size`` ranks, its ``group``) and on
    no other pipe coordinate."""

    mesh: Any
    axis: str
    size: int
    index: int
    group: Any


def stage_info(leaf) -> Optional[StageInfo]:
    """The :class:`StageInfo` of a stage-owned tensor (a module parameter,
    or a state tensor for one), else None."""
    return getattr(leaf, "_pipe_stage", None)


def tag_stage(tensor: torch.Tensor, info: Optional[StageInfo]) -> torch.Tensor:
    """Tag ``tensor`` as stage-owned (no-op for ``info=None``); returns it."""
    if info is not None:
        tensor._pipe_stage = info
    return tensor


def pipe_axis(mesh, axis_name: str = "pipe"):
    """``(group, size, index)`` of ``axis_name`` when ``mesh`` binds it above
    size 1, else None: without it a model runs as one stage."""
    bound = axis_group(mesh, axis_name)
    return bound if bound is not None and bound[1] > 1 else None


def mark_stage(module: nn.Module, mesh, axis_name: str = "pipe") -> nn.Module:
    """Tag every parameter of ``module`` as owned by this rank's stage of
    ``axis_name`` (nothing on an axis of size 1 or an unbound one)."""
    bound = pipe_axis(mesh, axis_name)
    if bound is None:
        return module
    group, size, index = bound
    info = StageInfo(mesh, axis_name, size, index, group)
    for p in module.parameters():
        tag_stage(p, info)
    return module


def last_stage_mask(mesh=None, axis_name: str = "pipe") -> float:
    """1.0 on the final pipe rank (or without a pipe axis), 0.0 elsewhere:
    pipeline outputs are valid on the last stage only."""
    bound = pipe_axis(mesh, axis_name)
    return 1.0 if bound is None or bound[2] == bound[1] - 1 else 0.0


def _exchange(group, sends: Sequence[Tuple[torch.Tensor, int]],
              recvs: Sequence[Tuple[torch.Tensor, int]]) -> None:
    """One tick's point-to-point ops (:func:`post_exchange`), each send
    counted in :data:`pp_send_launches` and each receive in
    :data:`pp_recv_launches`."""
    global pp_send_launches, pp_recv_launches
    post_exchange(group, sends, recvs)
    pp_send_launches += len(sends)
    pp_recv_launches += len(recvs)


def _stack_extras(extras: Optional[dict], num_microbatches: int,
                  microbatch_size: int) -> Tuple[Tuple[str, torch.Tensor], ...]:
    """Split per-token batch tensors ``[batch, ...]`` into the microbatch
    layout ``[m, mb, ...]``: one definition for every schedule, so the
    slicing never diverges from the activation split."""
    out = []
    for name, arr in sorted((extras or {}).items()):
        if arr.shape[0] != num_microbatches * microbatch_size:
            raise ValueError(
                f"extras[{name!r}] leading dim {arr.shape[0]} != batch "
                f"{num_microbatches * microbatch_size}"
            )
        out.append((name, arr.reshape(num_microbatches, microbatch_size, *arr.shape[1:])))
    return tuple(out)


def _index_extras(extras: Tuple[Tuple[str, torch.Tensor], ...], mb_index: int,
                  kwargs: dict) -> dict:
    """``kwargs`` with microbatch ``mb_index``'s slice of each extra.  Each
    rank indexes the microbatch it holds; extras never ride the ring."""
    if not extras:
        return kwargs
    kwargs = dict(kwargs)
    for name, stacked in extras:
        kwargs[name] = stacked[mb_index]
    return kwargs


def _microbatch_rng(base: Optional[int], *index: int) -> Optional[torch.Generator]:
    """The dropout generator of one (microbatch, chunk): seeded from the
    call's base draw, so a replay (1F1B's recompute) redraws the same
    masks (JAX splits the dropout key per scan tick)."""
    if base is None:
        return None
    return torch.Generator().manual_seed(fold_seed(0, base, *index))


def _base_seed(rng: Optional[torch.Generator]) -> Optional[int]:
    if rng is None:
        return None
    return int(torch.randint(0, 2**62, (1,), generator=rng))


def inject_tick(i: int, num_stages: int, interleave: int) -> int:
    """The tick at which microbatch ``i`` enters rank 0 (JAX's
    ``inject_tick``): ``i`` under GPipe."""
    return (i // num_stages) * interleave * num_stages + i % num_stages


def schedule_steps(num_stages: int, interleave: int, num_microbatches: int,
                   stage: int) -> List[Tuple[int, int, int]]:
    """Rank ``stage``'s real work in the circular schedule: ``(tick,
    virtual stage j, microbatch i)`` in tick order, bubbles left out.  The
    schedule runs ``inject_tick(m - 1) + v * n`` ticks (``m + n - 1`` for
    GPipe); rank ``r`` holds at tick ``t`` the item of age ``r + j * n``
    injected at ``tau = t - r - j * n``, microbatch ``(tau // vn) * n +
    tau % vn`` when ``tau >= 0`` and it is below ``m``."""
    n, v, m = num_stages, interleave, num_microbatches
    vn = v * n
    total = inject_tick(m - 1, n, v) + vn
    steps = []
    for t in range(total):
        j = ((t - stage) % vn) // n
        tau = t - stage - j * n
        if tau < 0:
            continue
        i = (tau // vn) * n + tau % vn
        if i < m:
            steps.append((t, j, i))
    return steps


def _chunk_params(chunks) -> List[torch.Tensor]:
    """The parameters of the modules behind ``chunks`` (modules, or
    ``functools.partial`` of one), each once: the ones whose gradients
    ``fold_grads`` moves into their fp32 accumulators after each
    microbatch, as JAX's scan accumulates them."""
    seen: Dict[int, torch.Tensor] = {}
    for c in chunks:
        module = getattr(c, "func", c)
        if isinstance(module, nn.Module):
            for p in module.parameters():
                seen.setdefault(id(p), p)
    return list(seen.values())


def _call_stage(stage: Callable, x: torch.Tensor, kwargs: dict, pass_validity: bool):
    """``(y, balance)``: ``stage(x, **kwargs)``, which must keep ``x``'s
    shape, and under ``pass_validity`` its summed balance (the stage called
    with a ``moe_losses`` list); None otherwise."""
    sown = [] if pass_validity else None
    if pass_validity:
        kwargs = dict(kwargs, moe_losses=sown)
    y = stage(x, **kwargs)
    if y.shape != x.shape:
        raise ValueError(
            f"pipeline stages must preserve activation shape; got "
            f"{tuple(x.shape)} -> {tuple(y.shape)}"
        )
    if sown is None:
        return y, None
    return y, (sum(v.sum() for v in sown) if sown else torch.zeros((), device=y.device))


class _Run:
    """One pipelined call: the chunks, the schedule, the inputs' split."""

    def __init__(self, chunks, x_shape, dtype, device, num_microbatches, interleave,
                 group, size, index, extras, kwargs, base_seed, pass_validity=False):
        self.chunks, self.v = chunks, interleave
        self.pass_validity = pass_validity
        self.n_ticks = inject_tick(num_microbatches - 1, size, interleave) + interleave * size
        self.m, self.group, self.n, self.r = num_microbatches, group, size, index
        self.mb_shape = (x_shape[0] // num_microbatches, *x_shape[1:])
        self.x_shape, self.dtype, self.device = tuple(x_shape), dtype, device
        self.extras, self.kwargs, self.base_seed = extras, kwargs, base_seed
        self.steps = schedule_steps(size, interleave, num_microbatches, index)
        self.by_tick = {t: (j, i) for t, j, i in self.steps}
        self.params = _chunk_params(chunks)

    def fed(self, j: int) -> bool:
        """Rank 0's first virtual stage reads the microbatch itself."""
        return self.r == 0 and j == 0

    def final(self, j: int) -> bool:
        """The last rank's last virtual stage finishes the item."""
        return self.r == self.n - 1 and j == self.v - 1

    def call(self, j: int, i: int, x: torch.Tensor):
        """:func:`_call_stage` of chunk ``j`` on microbatch ``i``."""
        kwargs = _index_extras(self.extras, i, self.kwargs)
        gen = _microbatch_rng(self.base_seed, i, j)
        if gen is not None:
            kwargs["dropout_rng"] = gen
        return _call_stage(self.chunks[j], x, kwargs, self.pass_validity)

    def table(self, balances: Dict[int, torch.Tensor]) -> torch.Tensor:
        """The per-tick balance table [n_ticks] (fp32, values only): the
        stage's balance on its real ticks, exactly 0 on the bubbles."""
        out = torch.zeros(self.n_ticks, dtype=torch.float32, device=self.device)
        for t, b in balances.items():
            out[t] = b.detach()
        return out

    def new_act(self) -> torch.Tensor:
        return torch.empty(self.mb_shape, dtype=self.dtype, device=self.device)

    def forward(self, x: torch.Tensor, grad: bool):
        """Walk the table: returns ``(outputs [batch, ...] on the last rank,
        zeros elsewhere; the saved (input, output) per tick)``."""
        out = torch.zeros(self.m, *self.mb_shape, dtype=self.dtype, device=self.device)
        micro = x.reshape(self.m, *self.mb_shape) if self.r == 0 else None
        ticks = sorted({t for t, _, _ in self.steps}
                       | {t - 1 for t, j, _ in self.steps if not self.fed(j)})
        prev, nxt = (self.r - 1) % self.n, (self.r + 1) % self.n
        saved: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
        self.balances: Dict[int, torch.Tensor] = {}
        inbox: Dict[int, torch.Tensor] = {}
        for t in ticks:
            y = None
            if t in self.by_tick:
                j, i = self.by_tick[t]
                x_in = micro[i] if self.fed(j) else inbox.pop(t)
                with torch.set_grad_enabled(grad):
                    if grad:
                        x_in = x_in.detach().requires_grad_(True)
                    y, balance = self.call(j, i, x_in)
                if balance is not None:
                    self.balances[t] = balance
                if grad:
                    saved[t] = (x_in, y)
                if self.final(j):
                    out[i] = y.detach()
            sends, recvs = [], []
            if y is not None and not self.final(self.by_tick[t][0]):
                sends.append((y, nxt))
            if t + 1 in self.by_tick and not self.fed(self.by_tick[t + 1][0]):
                inbox[t + 1] = self.new_act()
                recvs.append((inbox[t + 1], prev))
            _exchange(self.group, sends, recvs)
        return out.reshape(self.x_shape), saved

    def backward(self, saved, grad_out: torch.Tensor,
                 grad_table: Optional[torch.Tensor] = None) -> Optional[torch.Tensor]:
        """Walk the table in reverse: each step back-propagates its saved
        output with the gradient from rank ``r + 1`` (or the caller's, for
        a finished item), and its balance with the table's gradient at its
        tick, and sends its input's gradient to rank ``r - 1``.  Returns
        the gradient of the fed microbatches (rank 0)."""
        g_out = grad_out.reshape(self.m, *self.mb_shape) if self.r == self.n - 1 else None
        gx = torch.zeros(self.m, *self.mb_shape, dtype=self.dtype, device=self.device) \
            if self.r == 0 else None
        ticks = sorted({t for t, _, _ in self.steps}
                       | {t + 1 for t, j, _ in self.steps if not self.final(j)}, reverse=True)
        prev, nxt = (self.r - 1) % self.n, (self.r + 1) % self.n
        inbox: Dict[int, torch.Tensor] = {}
        for t in ticks:
            g_in = None
            if t in self.by_tick:
                j, i = self.by_tick[t]
                x_in, y = saved.pop(t)
                g = g_out[i] if self.final(j) else inbox.pop(t)
                balance = self.balances.get(t)
                if grad_table is not None and balance is not None and balance.requires_grad:
                    torch.autograd.backward([y, balance], [g.to(y.dtype), grad_table[t]])
                else:
                    torch.autograd.backward(y, g.to(y.dtype))
                fold_grads(self.params)
                g_in = x_in.grad if x_in.grad is not None else torch.zeros_like(x_in)
                if self.fed(j):
                    gx[i] = g_in
                    g_in = None
            sends, recvs = [], []
            if g_in is not None:
                sends.append((g_in, prev))
            if t - 1 in self.by_tick and not self.final(self.by_tick[t - 1][0]):
                inbox[t - 1] = self.new_act()
                recvs.append((inbox[t - 1], nxt))
            _exchange(self.group, sends, recvs)
        return None if gx is None else gx.reshape(self.x_shape)


class _PipelineFn(torch.autograd.Function):
    """The forward schedule as one autograd node: ``apply(run, anchor, x)``
    -> ``(out, table)``, the per-tick balance table empty without
    ``pass_validity``.  ``anchor`` is a 0-dim tensor that requires grad, so
    every rank's output joins the loss's graph (ranks past 0 feed no
    ``x``)."""

    @staticmethod
    def forward(ctx, run: _Run, anchor, x):
        out, saved = run.forward(x, grad=True)
        ctx.run, ctx.saved = run, saved
        table = run.table(run.balances) if run.pass_validity else out.new_zeros(0)
        return out, table

    @staticmethod
    def backward(ctx, grad_out, grad_table):
        gx = ctx.run.backward(ctx.saved, grad_out,
                              grad_table if ctx.run.pass_validity else None)
        ctx.saved = None
        return None, None, gx


_ANCHOR: Dict[Any, torch.Tensor] = {}


def _anchor(device) -> torch.Tensor:
    if device not in _ANCHOR:
        _ANCHOR[device] = torch.zeros((), device=device, requires_grad=True)
    return _ANCHOR[device]


def _check_batch(batch_size: int, num_microbatches: int) -> None:
    if batch_size % num_microbatches != 0:
        raise ValueError(
            f"per-device batch {batch_size} not divisible by "
            f"num_microbatches={num_microbatches}"
        )


def execute_interleaved_pipeline(
    chunks: Sequence[Callable],
    x: torch.Tensor,
    *,
    num_microbatches: int,
    mesh,
    axis_name: str = "pipe",
    extras: Optional[dict] = None,
    dropout_rng: Optional[torch.Generator] = None,
    pass_validity: bool = False,
    **kwargs,
):
    """Run this rank's ``chunks`` (its virtual stages ``j = 0..v-1``, global
    chunks ``j * n + r``) over the circular schedule.

    ``x`` [batch, ...] is read on rank 0 only (other ranks may pass any
    tensor of its shape, dtype and device, e.g. ``torch.empty``); it is
    split into ``num_microbatches``.  Returns the pipeline's output on the
    last rank and zeros elsewhere (JAX's masked collection).  ``extras``
    maps stage keywords to per-token tensors ``[batch, ...]`` (positions,
    segment ids): each rank indexes its microbatch's slice.  With
    ``dropout_rng`` (a CPU generator) each (microbatch, chunk) call gets a
    ``dropout_rng`` keyword of its own.  When gradients are enabled the
    schedule is differentiable: its backward runs the reverse schedule.
    ``pass_validity`` calls each real tick's chunk with a ``moe_losses``
    list (``BlockStack`` takes both) and returns
    ``(out, table)``: ``table`` [ticks] the chunk's summed balance per
    schedule tick, exactly 0 on this rank's bubbles (JAX's sown
    collection), differentiable."""
    bound = pipe_axis(mesh, axis_name)
    if bound is None:
        raise ValueError(f"the pipeline needs the {axis_name!r} mesh axis bound above size 1")
    group, size, index = bound
    _check_batch(x.shape[0], num_microbatches)
    mb = x.shape[0] // num_microbatches
    run = _Run(list(chunks), x.shape, x.dtype, x.device, num_microbatches, len(chunks),
               group, size, index, _stack_extras(extras, num_microbatches, mb), kwargs,
               _base_seed(dropout_rng), pass_validity)
    if torch.is_grad_enabled():
        out, table = _PipelineFn.apply(run, _anchor(x.device), x)
    else:
        out = run.forward(x, grad=False)[0]
        table = run.table(run.balances)
    return (out, table) if pass_validity else out


def execute_pipeline(
    stage: Callable,
    x: torch.Tensor,
    *,
    num_microbatches: int,
    mesh,
    axis_name: str = "pipe",
    broadcast_outputs: bool = False,
    extras: Optional[dict] = None,
    dropout_rng: Optional[torch.Generator] = None,
    pass_validity: bool = False,
    **kwargs,
):
    """Run ``stage`` (this rank's) over the GPipe schedule: ``m + n - 1``
    ticks, rank ``r`` on microbatch ``t - r``
    (:func:`execute_interleaved_pipeline` with one chunk).  Returns the
    last stage's outputs there and zeros elsewhere; ``broadcast_outputs``
    sums them over the axis (one all-reduce whose backward is a sum, JAX's
    ``psum``), so every rank holds the real output.  ``pass_validity``
    returns ``(out, table)`` as the interleaved schedule does."""
    out = execute_interleaved_pipeline(
        [stage], x, num_microbatches=num_microbatches, mesh=mesh, axis_name=axis_name,
        extras=extras, dropout_rng=dropout_rng, pass_validity=pass_validity, **kwargs)
    table = None
    if pass_validity:
        out, table = out
    if broadcast_outputs:
        from tpu_parallel_torch.parallel.tp import all_reduce

        out = all_reduce(out, axis_name, mesh)
    return out if table is None else (out, table)


def execute_pipeline_step(stage: Callable, carry: torch.Tensor, microbatch: torch.Tensor, *,
                          mesh, axis_name: str = "pipe", tick: Optional[int] = None,
                          num_microbatches: Optional[int] = None, pass_validity: bool = False,
                          extras: Tuple[Tuple[str, torch.Tensor], ...] = (), **kwargs):
    """One lockstep GPipe tick (JAX's ``execute_pipeline_step``): every rank
    of the axis calls it at every tick.  Rank 0 reads ``microbatch``, the
    others ``carry`` (what the previous rank sent last tick); the stage's
    output moves one rank along the ring (one send and one receive per
    rank, the wrap-around edge included, as ``lax.ppermute``).  Returns
    ``(carry_next, collected)``: the activation received for the next
    tick, and the stage's output on the last rank (zeros elsewhere).

    ``tick`` and ``num_microbatches`` say which microbatch the rank holds
    (``tick - rank``; ``extras`` as ``(name, [m, mb, ...])`` pairs are
    indexed by it).  A rank whose microbatch is out of range holds a
    bubble: it runs nothing and passes zeros on, where JAX computes on
    garbage it masks.  ``pass_validity`` runs the stage with a
    ``moe_losses`` list and returns a third value, the tick's summed
    balance: exactly 0 on a bubble."""
    if (pass_validity or extras) and (tick is None or num_microbatches is None):
        raise ValueError("pass_validity/extras require tick and num_microbatches")
    bound = pipe_axis(mesh, axis_name)
    if bound is None:
        raise ValueError(f"the pipeline needs the {axis_name!r} mesh axis bound above size 1")
    group, size, index = bound
    inputs = microbatch if index == 0 else carry
    mb_index = None if tick is None or num_microbatches is None else tick - index
    balance = None
    if mb_index is None or 0 <= mb_index < num_microbatches:
        outputs, balance = _call_stage(stage, inputs, _index_extras(extras, mb_index, kwargs),
                                       pass_validity)
    else:
        outputs = torch.zeros_like(inputs)
    collected = outputs if index == size - 1 else torch.zeros_like(outputs)
    carry_next = torch.empty_like(inputs)
    _exchange(group, [(outputs, (index + 1) % size)], [(carry_next, (index - 1) % size)])
    if not pass_validity:
        return carry_next, collected
    if balance is None:
        balance = torch.zeros((), dtype=torch.float32, device=inputs.device)
    return carry_next, collected, balance


def execute_pipeline_decode(stage: Callable, x: torch.Tensor, *, mesh, axis_name: str = "pipe",
                            **kwargs) -> torch.Tensor:
    """One batch's trip around the pipe ring for incremental decoding: rank
    ``r`` receives the activation from rank ``r - 1`` (rank 0 reads ``x``),
    runs its stage once, at its own tick ``r``, and sends the result on;
    the last rank's output is broadcast over the axis, so every rank
    returns the same hidden states (sampling must agree across ranks).

    JAX runs every rank's stage at every tick and passes ``cache_valid`` so
    only the rank whose tick it is commits its KV-cache writes; a rank here
    runs only on its own tick, so its caches see exactly the real pass and
    ``cache_valid`` has no counterpart.  ``kwargs`` pass straight to the
    stage."""
    bound = pipe_axis(mesh, axis_name)
    if bound is None:
        raise ValueError(f"pipelined decode needs the {axis_name!r} mesh axis bound")
    group, size, index = bound
    act = x
    if index > 0:
        act = torch.empty_like(x)
        _exchange(group, [], [(act, index - 1)])
    out = stage(act, **kwargs)
    if out.shape != x.shape:
        raise ValueError(f"pipeline stages must preserve activation shape; got "
                         f"{tuple(x.shape)} -> {tuple(out.shape)}")
    if index < size - 1:
        _exchange(group, [(out, index + 1)], [])
        out = torch.empty_like(x)
    out = out.contiguous()
    dist.broadcast(out, src=dist.get_global_rank(group, size - 1), group=group)
    return out


def _ring_slots(num_stages: int) -> int:
    """The size of 1F1B's ring of saved stage inputs: JAX's ``2n - 1``."""
    return 2 * num_stages - 1


def pipeline_1f1b_grads(
    fwd_fn: Callable,
    params: Sequence[torch.Tensor],
    batch,
    rng: Optional[torch.Generator],
    *,
    num_microbatches: int,
    mesh,
    axis_name: str = "pipe",
    act_shape: Tuple[int, ...],
    act_dtype,
    device=None,
    loss_key: str = "loss",
):
    """The memory-bounded 1F1B schedule: loss and gradients in one walk.

    ``fwd_fn(x_in, microbatch, rng_mb) -> (y, loss_sum, metrics)`` is the
    per-rank composite (the embedding on rank 0 in place of ``x_in``, this
    rank's stage, and on the last rank the loss summed over tokens with
    ``(sum, count)`` metrics; zero elsewhere).  Rank ``r`` forwards
    microbatch ``i`` at tick ``i + r`` without a graph, saves its input in
    slot ``i mod (2n - 1)`` of a ring, and at tick ``i + 2n - 2 - r``
    recomputes the stage from that input and back-propagates it (the last
    rank from its own loss, the others from the gradient rank ``r + 1``
    sent), sending the input's gradient to rank ``r - 1``: ``m + 2n - 2``
    ticks, each a forward, a recompute and a backward, of which the rank
    runs only the ones that hold a microbatch.  Rank ``r`` holds an input
    ``2 (n - 1 - r)`` ticks, so ``2n - 1`` slots (JAX's ring) never
    overwrite one before its backward reads it; rank 0 re-embeds its
    tokens and reads no saved input, so here rank 1's ``2n - 4`` ticks
    bind.  After each backward ``fold_grads`` adds the gradients of
    ``params`` into their ``main_grad`` (the fp32 accumulators a
    ``TrainState`` gives them, zeroed by the caller).  Each microbatch's
    dropout generator is derived from one draw of ``rng``, so the
    recompute redraws the forward's masks.

    Returns ``(grads, metrics)``: the accumulators, in the order of
    ``params``, divided in place by the token count summed over the axis
    (the mean-loss gradient of this data shard, ready for the
    partition-aware ``sync_gradients``), and the forward's summed
    metrics."""
    bound = pipe_axis(mesh, axis_name)
    group, n, r = bound if bound is not None else (None, 1, 0)
    m = num_microbatches
    slots = _ring_slots(n)
    params = list(params)

    def to_mb(a):
        if a is None:
            return None
        _check_batch(a.shape[0], m)
        return a.reshape(m, a.shape[0] // m, *a.shape[1:])

    fields = {f.name: to_mb(getattr(batch, f.name)) for f in dataclasses.fields(batch)}

    def mb_at(i):
        return type(batch)(**{k: None if v is None else v[i] for k, v in fields.items()})

    base = _base_seed(rng)
    saved: List[Optional[torch.Tensor]] = [None] * slots
    metrics = None
    total = m + 2 * n - 2

    def valid(i):
        return 0 <= i < m

    def new_act():
        return torch.empty(act_shape, dtype=act_dtype, device=device)

    inbox_f: Dict[int, torch.Tensor] = {}
    inbox_b: Dict[int, torch.Tensor] = {}
    for t in range(total):
        sends, recvs = [], []
        i_f = t - r
        if valid(i_f):
            x_in = inbox_f.pop(t) if r > 0 else None
            with torch.no_grad():
                y, _, mets = fwd_fn(x_in, mb_at(i_f), _microbatch_rng(base, i_f))
            mets = {k: (s.detach(), c.detach()) for k, (s, c) in mets.items()}
            metrics = mets if metrics is None else {
                k: (metrics[k][0] + s, metrics[k][1] + c) for k, (s, c) in mets.items()}
            saved[i_f % slots] = x_in
            if r < n - 1:
                sends.append((y, r + 1))
        i_b = t - (2 * n - 2 - r)
        if valid(i_b):
            x_saved = saved[i_b % slots]
            x = None if x_saved is None else x_saved.detach().requires_grad_(True)
            with torch.enable_grad():
                y, loss_sum, _ = fwd_fn(x, mb_at(i_b), _microbatch_rng(base, i_b))
                if r == n - 1:
                    torch.autograd.backward(loss_sum)
                else:
                    torch.autograd.backward(y, inbox_b.pop(t).to(y.dtype))
            fold_grads(params)
            if r > 0:
                sends.append((x.grad if x.grad is not None else torch.zeros_like(x), r - 1))
        if r > 0 and valid(t + 1 - r):
            inbox_f[t + 1] = new_act()
            recvs.append((inbox_f[t + 1], r - 1))
        if r < n - 1 and valid(t + 1 - (2 * n - 2 - r)):
            inbox_b[t + 1] = new_act()
            recvs.append((inbox_b[t + 1], r + 1))
        if group is not None:
            _exchange(group, sends, recvs)

    # the token count lives on the last rank only: share it around the pipe
    n_tok = metrics[loss_key][1].clone()
    if group is not None:
        dist.all_reduce(n_tok, group=group)
    inv = 1.0 / max(float(n_tok), 1.0)
    grads = [p.main_grad for p in params]
    if grads:
        torch._foreach_mul_(grads, inv)
    return grads, metrics


class _ChunkStack(nn.Module):
    """``interleave`` virtual-stage chunks on one rank (``chunk{j}``); the
    schedule calls chunk ``j`` for the item it holds."""

    def __init__(self, chunks: Sequence[nn.Module]):
        super().__init__()
        for j, c in enumerate(chunks):
            self.add_module(f"chunk{j}", c)

    def chunk(self, j: int) -> nn.Module:
        return getattr(self, f"chunk{j}")


class PipelineModule(nn.Module):
    """Wrap a stage constructor into a pipeline over ``axis_name`` of
    ``mesh``: this rank builds and owns only its stage (``interleave > 1``:
    its ``interleave`` chunks, global chunks ``j * n + r``), tagged
    :class:`StageInfo`, and the forward runs :func:`execute_pipeline` (or
    the interleaved schedule).  ``stage_fn()`` builds one stage (one chunk
    under interleave) from torch's default generator, seeded here with
    ``seed`` folded with the stage's global chunk index, so the stages draw
    independent weights, as JAX's ``ModuleShard`` folds the init key over
    the axis.  ``pass_validity``: the forward returns ``(out, table)``, the
    stage's per-tick balance table (:func:`execute_interleaved_pipeline`);
    the stage takes ``moe_losses`` (``BlockStack``)."""

    def __init__(self, stage_fn: Callable[[], nn.Module], num_microbatches: int, *, mesh,
                 axis_name: str = "pipe", broadcast_outputs: bool = False,
                 interleave: int = 1, seed: int = 0, pass_validity: bool = False):
        super().__init__()
        bound = pipe_axis(mesh, axis_name)
        if bound is None:
            raise ValueError(f"PipelineModule needs the {axis_name!r} mesh axis bound above "
                             "size 1")
        _, size, index = bound
        self.mesh, self.axis_name = mesh, axis_name
        self.num_microbatches, self.interleave = num_microbatches, interleave
        self.broadcast_outputs = broadcast_outputs
        self.pass_validity = pass_validity
        chunks = []
        for j in range(interleave):
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(fold_seed(0, seed, j * size + index))
                chunks.append(stage_fn())
        self.stage = _ChunkStack(chunks) if interleave > 1 else chunks[0]
        mark_stage(self.stage, mesh, axis_name)

    def forward(self, x: torch.Tensor, extras: Optional[dict] = None, **kwargs) -> torch.Tensor:
        if kwargs.get("decode"):
            if self.interleave > 1:
                raise NotImplementedError(
                    "incremental decoding under the interleaved schedule "
                    "(nn.switch chunks cannot lazily create their KV-cache "
                    "variables branch-by-branch)"
                )
            return execute_pipeline_decode(self.stage, x, mesh=self.mesh,
                                           axis_name=self.axis_name, **dict(extras or {}),
                                           **kwargs)
        if self.interleave > 1:
            if self.broadcast_outputs:
                raise NotImplementedError("broadcast_outputs under the interleaved schedule")
            return execute_interleaved_pipeline(
                [self.stage.chunk(j) for j in range(self.interleave)], x,
                num_microbatches=self.num_microbatches, mesh=self.mesh,
                axis_name=self.axis_name, extras=extras, pass_validity=self.pass_validity,
                **kwargs)
        return execute_pipeline(self.stage, x, num_microbatches=self.num_microbatches,
                                mesh=self.mesh, axis_name=self.axis_name,
                                broadcast_outputs=self.broadcast_outputs, extras=extras,
                                pass_validity=self.pass_validity, **kwargs)
