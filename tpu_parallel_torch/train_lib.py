"""Trainer: the port of ``tpu_parallel/train_lib.py``.

Config -> mesh -> model -> loss, optimizer and step -> loop, as the JAX
``Trainer``.  The step mirrors the JAX ``build_train_functions`` step:
accumulate this rank's gradients over minibatches, average them over the
mesh's data axis, clip them by their global norm, apply the optimizer
(adamw, lion or sgd) to fp32 master weights, update the EMA shadow when one
is kept, and add the step's ``(sum, count)`` metrics, summed over the data
axis, to the running ones.  :meth:`Trainer.fit` adds checkpoints, resume,
rollback-and-retry and periodic held-out evaluation.

The mesh is a ``DeviceMesh`` over the process group (``runtime.make_mesh``),
one rank per device; without a group it is ``None``, one device, and no
collective runs.  Each rank steps on its own rows of the global batch:
:meth:`Trainer.local_rows` cuts them from a global batch (the contiguous
block at the rank's data coordinate, as ``shard_map`` splits rows), and a
``DataLoader`` yields them directly.  Metrics are synced inside the step,
so every host decision (logging, rollback, keep-best) sees the same values
on every rank.

The step, the init and the evaluation come from
``parallel/spmd.py:build_train_functions``, as in JAX: one code path for
data parallelism, FSDP (``model_overrides.fsdp``: the model's blocks,
embedding and lm_head sharded over the data axis, the state's tensors for
them this rank's slices) and tensor parallelism (a model axis above 1: the
blocks' projections and the lm_head split over it, their state this
rank's slices, gradients synced over ``("data", "model")`` as JAX's
Trainer syncs them, metrics averaged over the model axis), pipeline
parallelism (a pipe axis above 1 dictates the model's ``pipe_size``: each
rank builds its stage, the replicated leaves' gradients are summed over
``pipe``; ``pipe_schedule`` ``"gpipe"`` or ``"1f1b"``) and sequence
parallelism (a seq axis above 1 with ``attn_impl`` ``"ring"`` or
``"ulysses"``: each rank steps on its block of every row's tokens,
``batch_spec`` ``("data", "seq")``, and gradients are synced over
``("data", "seq", "model")``).

FSDP together with a model axis above 1 (``llama_1b_3d``) splits each
tensor-parallel slice again over the data axis.  ``objective="mlm"`` trains
a bidirectional encoder (``bert_base``) on the masked-LM loss
(``models/gpt.py:make_mlm_loss``); a bidirectional model refuses the causal
objective, in JAX's words.  A model whose registry entry gives a
``Seq2SeqConfig`` (``t5_small``, ``t5_small_hf``, ``tiny_seq2seq``) trains
the ``EncoderDecoder`` on the teacher-forced loss
(``models/seq2seq.py:make_seq2seq_loss``) over ``Seq2SeqBatch`` rows
(``objective`` ``"causal"``, the default, or ``"seq2seq"``; ``"mlm"`` is
refused in JAX's words).
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
import time
from typing import Any, Callable, Dict, Optional

import torch
import torch.distributed as dist

from tpu_parallel_torch.core.metrics import Metrics
from tpu_parallel_torch.core.metrics import compute as compute_metrics
from tpu_parallel_torch.core.optim import (SGD, AddDecayedWeights, AdamW, Chain,
                                           ClipByGlobalNormSharded, Lion)
from tpu_parallel_torch.core.state import TrainState, get_num_params
from tpu_parallel_torch.data import lm_batch, seq2seq_batch
from tpu_parallel_torch.models.convert import init_params
from tpu_parallel_torch.models.gpt import (GPTConfig, GPTLM, bert_base, gpt2_125m, gpt2_350m,
                                           llama_1b, make_gpt_1f1b_grad_fn, make_gpt_loss,
                                           make_mlm_loss, tiny_test)
from tpu_parallel_torch.models.seq2seq import (EncoderDecoder, Seq2SeqConfig,
                                               make_seq2seq_loss, t5_small, t5_small_hf,
                                               tiny_seq2seq)
from tpu_parallel_torch.obs.registry import MetricRegistry
from tpu_parallel_torch.obs.tracer import NULL_TRACER, Tracer
from tpu_parallel_torch.parallel.spmd import build_train_functions, make_model_init
from tpu_parallel_torch.runtime import MeshConfig, make_mesh, resolve_device
from tpu_parallel_torch.runtime.mesh import (DATA_AXIS, MODEL_AXIS, PIPE_AXIS, SEQ_AXIS,
                                             axis_group, mesh_sizes)
from tpu_parallel_torch.utils.profiling import mfu

MODEL_REGISTRY: Dict[str, Callable[..., GPTConfig]] = {
    "gpt2_125m": gpt2_125m,
    "gpt2_350m": gpt2_350m,
    "llama_1b": llama_1b,
    "bert_base": bert_base,
    "tiny": tiny_test,
    # the encoder-decoder family: Seq2SeqConfig factories dispatch the
    # Trainer to EncoderDecoder, make_seq2seq_loss and seq2seq batches
    "t5_small": t5_small,
    "t5_small_hf": t5_small_hf,
    "tiny_seq2seq": tiny_seq2seq,
}

MESH_AXES = ("data", "model", "pipe", "seq")


def _mesh_sizes(mesh) -> Dict[str, int]:
    """``{axis: size}`` of a mesh given as a dict or an object with the JAX
    ``MeshConfig``'s fields; a size of -1 means "all remaining devices"."""
    get = mesh.get if isinstance(mesh, dict) else lambda k, d: getattr(mesh, k, d)
    sizes = {axis: int(get(axis, 1)) for axis in MESH_AXES}
    extra = set(mesh) - set(MESH_AXES) if isinstance(mesh, dict) else set()
    if extra:
        raise ValueError(f"mesh axes {sorted(extra)}: the mesh has {MESH_AXES}")
    return sizes


@dataclasses.dataclass
class TrainerConfig:
    """The JAX ``TrainerConfig``, field for field, with its defaults.

    ``mesh`` (a dict or an object with the ``MeshConfig`` fields) resolves
    against the process group's ranks (one device without a group); a
    data axis above 1 trains data-parallel, a model axis above 1
    tensor-parallel, a pipe axis above 1 pipeline-parallel, a seq axis
    above 1 sequence-parallel (``attn_impl`` ``"ring"`` or ``"ulysses"``).
    ``donate`` is accepted and changes
    nothing: the port's step already updates its buffers in place.  ``objective``:
    ``"causal"`` (next-token LM) or ``"mlm"`` (the masked-LM loss of encoder
    configs, corrupting ``mlm_mask_rate`` of the tokens); an
    encoder-decoder model trains teacher-forced under ``"causal"`` or
    ``"seq2seq"``.
    """

    model: str = "gpt2_125m"
    model_overrides: Dict[str, Any] = dataclasses.field(default_factory=dict)
    mesh: Any = dataclasses.field(
        default_factory=lambda: dict(data=-1, model=1, pipe=1, seq=1))
    global_batch_size: int = 32
    num_minibatches: int = 1
    steps: int = 20
    # "adamw" | "lion" | "sgd"
    optimizer: str = "adamw"
    # "causal" (next-token LM) | "mlm" (masked LM for bidirectional configs)
    objective: str = "causal"
    mlm_mask_rate: float = 0.15
    # "cosine" (decay to 10% of peak) | "linear" (decay to 0) | "constant";
    # all include the linear warmup over warmup_steps
    lr_schedule: str = "cosine"
    learning_rate: float = 3e-4
    # > 0 keeps an EMA (Polyak) shadow of the masters, updated every step
    # and preferred by evaluation; 0 = off
    ema_decay: float = 0.0
    warmup_steps: int = 10
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    seed: int = 0
    log_every: int = 10
    donate: bool = True

    @classmethod
    def from_config_dict(cls, cd) -> "TrainerConfig":
        """Build from a config dict (``tpu_parallel_torch.configs``)."""
        d = dict(cd)
        overrides = dict(d.pop("model_overrides", {}))
        return cls(model_overrides=overrides, **d)


def _linear(init: float, end: float, steps: int, count: int) -> float:
    """``optax.linear_schedule``: held at ``init`` when ``steps <= 0``."""
    if steps <= 0:
        return init
    frac = 1 - min(max(count, 0), steps) / steps
    return (init - end) * frac + end


def make_lr_schedule(config: TrainerConfig) -> Callable[[int], float]:
    """``config.lr_schedule`` with a linear warmup from 0 over
    ``warmup_steps``: ``count -> learning rate``, valued as the optax
    schedules of the JAX package at each step count (lr(0) = 0 under a
    warmup)."""
    peak, warmup = config.learning_rate, config.warmup_steps
    decay_steps = max(config.steps, warmup + 1)

    if config.lr_schedule == "cosine":
        # decay to 10% of peak; alpha = end / peak computed as optax does
        alpha = 0.0 if peak == 0.0 else peak * 0.1 / peak

        def after(count):
            count = min(count, decay_steps - warmup)
            cosine = 0.5 * (1 + math.cos(math.pi * count / (decay_steps - warmup)))
            return peak * ((1 - alpha) * cosine + alpha)
    elif config.lr_schedule == "linear":
        def after(count):
            return _linear(peak, 0.0, decay_steps - warmup, count)
    elif config.lr_schedule == "constant":
        def after(count):
            return peak
    else:
        raise ValueError(
            f"unknown lr_schedule {config.lr_schedule!r} (expected cosine | linear | constant)"
        )

    def schedule(count: int) -> float:
        if count < warmup:
            return _linear(0.0, peak, warmup, count)
        return after(count - warmup)

    return schedule


def make_optimizer(config: TrainerConfig) -> Chain:
    """The sharding-aware global-norm clip then ``config.optimizer`` with
    the schedule, as the JAX ``make_optimizer``: ``optax.adamw(schedule,
    weight_decay=wd)``, ``optax.lion(schedule, weight_decay=wd)``, or
    ``add_decayed_weights(wd)`` then ``optax.sgd(schedule, momentum=0.9)``."""
    schedule = make_lr_schedule(config)
    if config.optimizer == "adamw":
        tx = AdamW(schedule, weight_decay=config.weight_decay)
    elif config.optimizer == "lion":
        tx = Lion(schedule, weight_decay=config.weight_decay)
    elif config.optimizer == "sgd":
        # configs advertise weight_decay for every optimizer family; honor it
        return Chain(ClipByGlobalNormSharded(config.grad_clip),
                     AddDecayedWeights(config.weight_decay), SGD(schedule, momentum=0.9))
    elif config.optimizer == "adafactor":
        raise ValueError(
            "adafactor is not supported (the JAX package refuses it too: its "
            "factored state breaks sharding spec discovery); use adamw | lion | sgd"
        )
    else:
        raise ValueError(f"unknown optimizer {config.optimizer!r} (expected adamw | lion | sgd)")
    return Chain(ClipByGlobalNormSharded(config.grad_clip), tx)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Trainer:
    """Owns the mesh, the model, the optimizer and the train step.

    ``mesh`` defaults to ``make_mesh(config.mesh)``: ``None`` (one device)
    without a process group.  ``device`` defaults to ``"cuda"`` (under a
    group, this rank's card) and raises without a GPU.  The model is drawn
    from ``config.seed``; :meth:`init` builds the state, from those draws or
    from given fp32 weights (e.g. ``params_from_jax(tree, cfg,
    dtype=torch.float32)``), and broadcasts data-rank 0's masters.  The
    state's generator is a CPU ``torch.Generator`` seeded with
    ``config.seed``, equal on every rank: dropout folds it over the mesh
    (one draw per minibatch, the same on every rank) and draws one seed per
    layer from the folded one (the masks are drawn on the device).

    ``step_fn`` is an attribute a caller may replace (the counterpart of the
    JAX ``t.funcs.step_fn``): :meth:`fit` calls every step through it.

    Telemetry as in the JAX package: ``tracer`` records ``data_wait`` and
    ``compute`` spans on the ``trainer`` track (the compute span ends at a
    device synchronize, so it is the step's device time), and ``registry``
    receives ``train_*`` gauges at every log point.
    """

    def __init__(self, config: TrainerConfig, mesh=None, *, device="cuda",
                 tracer: Optional[Tracer] = None, registry: Optional[MetricRegistry] = None):
        if mesh is None:
            mesh = make_mesh(MeshConfig(**_mesh_sizes(config.mesh)))
        if config.ema_decay and not 0.0 < config.ema_decay < 1.0:
            raise ValueError(f"ema_decay={config.ema_decay} must be in (0, 1)")
        if config.model not in MODEL_REGISTRY:
            raise KeyError(f"model {config.model!r}: the port has {sorted(MODEL_REGISTRY)}")
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.registry = registry if registry is not None else MetricRegistry()
        self.config = config
        self.mesh = mesh
        self.device = resolve_device(device)
        overrides = {k: v for k, v in config.model_overrides.items() if v is not None}
        # the model's pipeline degree is dictated by the mesh
        overrides.setdefault("pipe_size", mesh_sizes(mesh)[PIPE_AXIS])
        self.model_config: GPTConfig = MODEL_REGISTRY[config.model](**overrides)
        self.is_seq2seq = isinstance(self.model_config, Seq2SeqConfig)
        if self.is_seq2seq:
            if config.objective not in ("causal", "seq2seq"):
                # "causal", the default, counts as the family's own objective
                raise ValueError(
                    f"objective={config.objective!r} is a single-stack "
                    "objective; encoder-decoder models train teacher-forced"
                )
        elif config.objective not in ("causal", "mlm"):
            raise ValueError(f"objective={config.objective!r} (causal | mlm)")
        if self.model_config.bidirectional and config.objective == "causal" \
                and not self.is_seq2seq:
            # next-token CE on a bidirectional model: attention sees the target
            raise ValueError(
                "bidirectional models cannot train with objective='causal' "
                "(attention sees the next-token target); use objective='mlm'"
            )
        schedule = self.model_config.pipe_schedule
        if schedule == "1f1b" and self.is_seq2seq:
            raise NotImplementedError(
                "pipe_schedule='1f1b' for the encoder-decoder family "
                "(two sequential pipelines need their own buffer walk)"
            )
        if schedule == "1f1b" and config.objective == "mlm":
            # the 1F1B schedule computes the causal loss itself
            raise NotImplementedError(
                "objective='mlm' under pipe_schedule='1f1b' (the schedule's per-microbatch "
                "loss is the causal one); use pipe_schedule='gpipe'")
        if schedule not in ("gpipe", "1f1b"):
            raise ValueError(
                f"pipe_schedule={schedule!r} (gpipe | 1f1b) — an unknown "
                "value would silently train with GPipe's m-proportional "
                "activation memory"
            )
        if mesh is not None:
            # a typo'd axis name would otherwise fold dropout over nothing
            # (fold_rng_over_axis skips unbound axes): validate it here, once
            for field in ("data_axis", "model_axis", "pipe_axis", "seq_axis"):
                ax = getattr(self.model_config, field)
                if ax not in mesh.mesh_dim_names:
                    raise ValueError(f"model config {field}={ax!r} is not a mesh axis "
                                     f"(mesh has {tuple(mesh.mesh_dim_names)})")
        data = mesh_sizes(mesh)[DATA_AXIS]
        if config.global_batch_size % data != 0:
            raise ValueError(f"global batch {config.global_batch_size} not divisible by "
                             f"data axis {data}")
        # sequence parallelism: a seq axis above 1 shards the token axis of
        # the batch; only ring and ulysses attention can run on a block
        seq = mesh_sizes(mesh)[SEQ_AXIS]
        if seq > 1 and self.model_config.attn_impl not in ("ring", "ulysses"):
            raise ValueError(
                f"mesh has seq={seq} but attn_impl={self.model_config.attn_impl!r} cannot "
                "shard the sequence axis — use attn_impl='ring' or 'ulysses'")
        lengths = [self.model_config.seq_len]
        if self.is_seq2seq:
            lengths.append(self.model_config.source_len)
        for length in lengths:
            if length % seq != 0:
                raise ValueError(f"seq_len {length} not divisible by seq axis {seq}")
        # the layout of a step's batch over the mesh, by batch dim (JAX's
        # P("data", "seq")): rows over data, token blocks over seq
        self.batch_spec = (DATA_AXIS, SEQ_AXIS) if seq > 1 else (DATA_AXIS,)
        bound = axis_group(mesh, DATA_AXIS)
        self.data_size, self.data_index = (1, 0) if bound is None else bound[1:]
        bound = axis_group(mesh, SEQ_AXIS)
        self.seq_size, self.seq_index = (1, 0) if bound is None else bound[1:]
        self.num_devices = 1 if mesh is None else mesh.size()
        # under a mesh, rank 0 of the group writes checkpoints and every
        # rank waits for the write at a barrier
        self._group = dist.group.WORLD if mesh is not None else None
        # the seeded weights are drawn once, by init (or restored): the
        # model starts with its modules' own values
        cfgm = self.model_config
        if self.is_seq2seq:
            self.model = EncoderDecoder(cfgm, device=self.device, seed=None, mesh=mesh)
            make_loss = make_seq2seq_loss
            example = seq2seq_batch(torch.Generator().manual_seed(0), config.global_batch_size,
                                    cfgm.source_len, cfgm.seq_len, cfgm.vocab_size,
                                    device=self.device)
        else:
            self.model = GPTLM(cfgm, device=self.device, seed=None, mesh=mesh)
            make_loss = make_gpt_loss
            if config.objective == "mlm":
                make_loss = functools.partial(make_mlm_loss, mask_rate=config.mlm_mask_rate)
            example = lm_batch(torch.Generator().manual_seed(0), config.global_batch_size,
                               cfgm.seq_len, cfgm.vocab_size, device=self.device)
        self.tx = make_optimizer(config)
        self.loss_fn = make_loss(cfgm, mesh=mesh)
        grad_fn = None
        if schedule == "1f1b":
            grad_fn = make_gpt_1f1b_grad_fn(cfgm, mesh=mesh)
        self.eval_loss_fn = make_loss(cfgm, train=False, mesh=mesh)
        self.example_batch = self.local_rows(example)
        # the losses are read at each call: a caller may replace them
        self.funcs = build_train_functions(
            make_model_init(self.model, self.tx),
            lambda model, batch, rng: self.loss_fn(model, batch, rng),
            mesh, grad_sync_axes=(DATA_AXIS, SEQ_AXIS, MODEL_AXIS), grad_psum_axes=(PIPE_AXIS,),
            num_minibatches=config.num_minibatches, grad_fn=grad_fn,
            eval_loss_fn=lambda model, batch, rng: self.eval_loss_fn(model, batch, rng),
            ema_decay=config.ema_decay,
        )
        self.state: Optional[TrainState] = None

    def local_rows(self, batch):
        """This rank's part of a global batch (``batch_spec``): the
        contiguous block of ``size / data`` rows at its data coordinate
        and, under sequence parallelism, of each row's tokens (tokens,
        targets, positions, segment ids, loss mask) the block of ``seq_len
        / seq`` at its seq coordinate (the whole batch on one device)."""
        n = batch.size // self.data_size
        batch = batch.rows(self.data_index * n, (self.data_index + 1) * n)
        if self.seq_size == 1:
            return batch
        if hasattr(batch, "seq_block"):  # a Seq2SeqBatch: source and target
            return batch.seq_block(self.seq_index, self.seq_size)
        t = batch.tokens.shape[1] // self.seq_size
        return batch.cols(self.seq_index * t, (self.seq_index + 1) * t)

    def init(self, params: Optional[Dict[str, torch.Tensor]] = None) -> TrainState:
        """A fresh state: masters from ``params`` (fp32 by parameter name)
        or from the seeded draws; the EMA shadow, when kept, starts at the
        masters."""
        if params is None:
            params = init_params(self.model, self.config.seed)
        rng = torch.Generator().manual_seed(self.config.seed)
        self.state = self.funcs.init_fn(rng, params)
        return self.state

    def step_fn(self, state: TrainState, metrics: Optional[Metrics], batch) -> tuple:
        """One optimizer step on this rank's rows ``batch`` -> ``(state,
        metrics)``, with the step's metrics, summed over the data axis,
        added to ``metrics`` (``funcs.step_fn``)."""
        return self.funcs.step_fn(state, metrics, batch)

    def _publish_gauges(self, metrics: Dict[str, float]) -> None:
        """Mirror one log point's metrics into the registry as ``train_*``
        gauges."""
        for key, value in metrics.items():
            if isinstance(value, (int, float)):
                self.registry.gauge(f"train_{key}").set(value)

    def _next_batch(self, batch_iter):
        return next(batch_iter) if batch_iter is not None else self.example_batch

    def train(self, batch_iter=None, steps: Optional[int] = None,
              log_fn: Callable[[int, Dict[str, float]], None] = None) -> Dict[str, float]:
        """Run the training loop; returns the metric means since the start,
        with ``tokens_per_sec`` over the steps after the first (which
        carries the kernel builds) and ``mfu`` where the device's peak is
        known.  ``batch_iter`` defaults to repeating ``example_batch``."""
        if self.state is None:
            self.init()
        steps = steps if steps is not None else self.config.steps
        state, metrics = self.state, None
        tokens_per_step = self.config.global_batch_size * self.model_config.seq_len
        last: Dict[str, float] = {}
        t_start = t0 = time.perf_counter()
        timed_from = 0
        tr = self.tracer
        for step in range(1, steps + 1):
            if tr.enabled:
                with tr.span("data_wait", track="trainer", step=step):
                    batch = self._next_batch(batch_iter)
            else:
                batch = self._next_batch(batch_iter)
            if step == 1 and self.is_seq2seq and not hasattr(batch, "src_tokens"):
                # the token-stream DataLoader yields TextBatch
                raise ValueError(
                    "seq2seq models need Seq2SeqBatch batches (src_tokens + "
                    "teacher-forced tokens/targets); the token-stream "
                    f"DataLoader yields {type(batch).__name__} — provide a "
                    "paired-data iterator"
                )
            if tr.enabled:
                # the synchronize pins the span to the step's device time
                with tr.span("compute", track="trainer", step=step):
                    state, metrics = self.step_fn(state, metrics, batch)
                    _sync(self.device)
            else:
                state, metrics = self.step_fn(state, metrics, batch)
            if step == 1:
                _sync(self.device)
                t0 = time.perf_counter()
                timed_from = 1
            if step % self.config.log_every == 0 or step == steps:
                _sync(self.device)
                dt = time.perf_counter() - t0
                last = compute_metrics(metrics)
                timed = step - timed_from
                if timed > 0:
                    last["tokens_per_sec"] = tokens_per_step * timed / dt
                else:
                    last["tokens_per_sec"] = tokens_per_step * step / max(
                        time.perf_counter() - t_start, 1e-9)
                # per device: tokens_per_step counts every rank's rows,
                # which the model axis splits again; the FLOP model is the
                # decoder-only transformer's, so an encoder-decoder gets none
                util = None if self.is_seq2seq else mfu(
                    last["tokens_per_sec"] / self.num_devices, self.model_config, self.device)
                if util is not None:
                    last["mfu"] = util
                self._publish_gauges(last)
                if log_fn is not None:
                    log_fn(step, last)
        self.state = state
        return last

    def _restore_into_state(self, ckpt, step: Optional[int] = None) -> None:
        if self.state is None:
            # the restore target: a fresh init, laid out (sharded) as this
            # trainer's mesh lays the state out, filled in place
            self.state = self.funcs.init_fn(torch.Generator().manual_seed(self.config.seed))
        ckpt.restore(self.state, step)
        if self.config.ema_decay and self.state.ema_params is None:
            # EMA turned on mid-run (the checkpoint predates it): seed the
            # shadow from the restored masters, as init would
            self.state.seed_ema()

    def fit(self, checkpoint_dir: str, *, data_loader=None, batch_iter=None,
            steps: Optional[int] = None, checkpoint_every: int = 100, max_failures: int = 3,
            max_to_keep: int = 3, log_fn: Callable[[int, Dict[str, float]], None] = None,
            eval_every: int = 0, eval_steps: int = 10, keep_best: bool = False) -> Dict[str, float]:
        """Fault-tolerant training: auto-resume, periodic async checkpoints,
        rollback-and-retry, as the JAX ``Trainer.fit``.

        On start, restores the latest checkpoint in ``checkpoint_dir`` if
        one exists; saves every ``checkpoint_every`` steps (and at the last)
        while the next steps run; on a step failure, rolls back to the last
        checkpoint (every buffer rewritten in place, the half-done step's
        gradients and the running metrics cleared) and retries, up to
        ``max_failures`` times.  ``eval_every > 0`` runs :meth:`evaluate` on
        the held-out split of ``data_loader`` (``eval_view()``) every that
        many steps and logs ``eval_*`` metrics; ``keep_best=True`` then
        also saves the lowest-eval-loss state under ``{checkpoint_dir}/best``
        with ``best_loss.json`` beside it, which a resumed run reads.

        ``data_loader`` (anything with ``batch_at(step)``) gives exact resume
        and rollback: step ``s`` always trains on batch ``s``.  A plain
        ``batch_iter`` cannot be rewound.
        """
        from tpu_parallel_torch.checkpoint import Checkpointer
        from tpu_parallel_torch.utils.logging_utils import print_exception

        steps = steps if steps is not None else self.config.steps
        if keep_best and not eval_every:
            raise ValueError("keep_best=True requires eval_every > 0")
        eval_iter_fn = None
        if eval_every:
            if data_loader is None or not hasattr(data_loader, "eval_view"):
                raise ValueError(
                    "eval_every > 0 needs a data_loader with eval_view() "
                    "(a held-out split); evaluating the training stream or "
                    "a synthetic batch would make the numbers meaningless"
                )
            eval_loader = data_loader.eval_view()
            eval_iter_fn = lambda: iter(eval_loader)
        ckpt = Checkpointer(checkpoint_dir, max_to_keep=max_to_keep, group=self._group)
        best_ckpt = None
        best_loss = float("inf")
        best_loss_path = os.path.join(checkpoint_dir, "best", "best_loss.json")
        if keep_best:
            best_ckpt = Checkpointer(os.path.join(checkpoint_dir, "best"), max_to_keep=1,
                                     group=self._group)
            if os.path.exists(best_loss_path):
                # resumed run: never let a worse post-resume eval overwrite
                # the surviving best snapshot
                with open(best_loss_path) as fh:
                    best_loss = json.load(fh)["loss"]

        def restore_latest():
            # drain the write in flight first: the latest step may still be
            # writing when a failure triggers rollback
            ckpt.wait()
            self._restore_into_state(ckpt)

        try:
            if ckpt.latest_step is not None:
                restore_latest()
            elif self.state is None:
                self.init()

            failures = 0
            metrics = None
            last: Dict[str, float] = {}
            step = self.state.step

            def rollback_or_reraise(exc):
                nonlocal failures, metrics
                print_exception(exc)
                failures += 1
                # a save in flight lands (on every rank's view of the
                # directory) before the check
                ckpt.wait()
                if failures > max_failures or ckpt.latest_step is None:
                    raise exc
                restore_latest()
                metrics = None
                return self.state.step

            tr = self.tracer
            while step < steps:
                data_span = (tr.span("data_wait", track="trainer", step=step + 1)
                             if tr.enabled else None)
                if data_loader is not None:
                    batch = data_loader.batch_at(step)
                else:
                    batch = self._next_batch(batch_iter)
                if data_span is not None:
                    data_span.finish()
                step_span = (tr.span("compute", track="trainer", step=step + 1)
                             if tr.enabled else None)
                try:
                    self.state, metrics = self.step_fn(self.state, metrics, batch)
                    # the rollback contract fences every step (a device
                    # fault surfaces here, not inside a later step)
                    _sync(self.device)
                except Exception as exc:  # noqa: BLE001 — device/transport failure
                    if step_span is not None:
                        step_span.finish(failed=True)
                    step = rollback_or_reraise(exc)
                    continue
                if step_span is not None:
                    step_span.finish()
                step += 1
                if step % checkpoint_every == 0 or step == steps:
                    ckpt.save(step, self.state, wait=False)
                if eval_every and (step % eval_every == 0 or step == steps):
                    try:
                        ev = self.evaluate(batch_iter=eval_iter_fn(), steps=eval_steps)
                    except Exception as exc:  # noqa: BLE001 — same contract as the step
                        step = rollback_or_reraise(exc)
                        continue
                    if log_fn is not None:
                        log_fn(step, {f"eval_{k}": v for k, v in ev.items()})
                    if best_ckpt is not None and ev["loss"] < best_loss:
                        best_loss = ev["loss"]
                        # wait=True: the loss marker must never outlive its
                        # snapshot
                        best_ckpt.save(step, self.state, wait=True)
                        if best_ckpt.writer:
                            with open(best_loss_path, "w") as fh:
                                json.dump({"loss": best_loss, "step": step}, fh)
                if step % self.config.log_every == 0 or step == steps:
                    last = compute_metrics(metrics)
                    self._publish_gauges(last)
                    if log_fn is not None:
                        log_fn(step, last)
            ckpt.wait()
            if best_ckpt is not None:
                best_ckpt.wait()
            return last
        finally:
            ckpt.close()
            if best_ckpt is not None:
                best_ckpt.close()

    @torch.no_grad()
    def evaluate(self, batch_iter=None, steps: int = 10) -> Dict[str, float]:
        """Mean metrics over ``steps`` eval batches (this rank's rows, summed
        over the data axis): dropout off, no update, the EMA shadow's
        weights when one is kept.  The module's weights are left bitwise as
        they were."""
        if self.state is None:
            self.init()
        metrics = None
        for _ in range(steps):
            metrics = self.funcs.eval_fn(self.state, metrics, self._next_batch(batch_iter))
        return compute_metrics(metrics)

    def save_checkpoint(self, directory: str, step: int, *, wait: bool = True) -> None:
        from tpu_parallel_torch.checkpoint import Checkpointer

        ckpt = Checkpointer(directory, group=self._group)
        try:
            ckpt.save(step, self.state, wait=wait)
        finally:
            ckpt.close()

    def restore_checkpoint(self, directory: str, step: Optional[int] = None) -> TrainState:
        """Restore ``step`` (default: the latest) of ``directory`` into this
        trainer's state, in place (a fresh state first when there is none)."""
        from tpu_parallel_torch.checkpoint import Checkpointer

        ckpt = Checkpointer(directory, group=self._group)
        try:
            self._restore_into_state(ckpt, step)
        finally:
            ckpt.close()
        return self.state

    @property
    def num_params(self) -> int:
        """Parameter count (logging and MFU): the whole model's, a pipeline
        stage's layers counted once per pipe rank (every stage holds as
        many).  Read off the parameters: no forward runs, so no ring or
        all-to-all either (JAX traces a mesh-free twin for it)."""
        total = get_num_params(self.model)
        if self.model.pipe is not None:
            stages = [self.model.encoder, self.model.decoder] if self.is_seq2seq \
                else [self.model.blocks]
            total += (self.model.pipe[1] - 1) * sum(get_num_params(m) for m in stages)
        return total
