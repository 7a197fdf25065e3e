"""Single-device trainer: the port of ``tpu_parallel/train_lib.py``.

Config -> model -> loss, optimizer and step -> loop, as the JAX ``Trainer``
does on a mesh, here on one device.  The step mirrors the JAX
``build_train_functions`` step: accumulate gradients over minibatches,
clip them by their global norm, apply AdamW to fp32 master weights, and add
the step's ``(sum, count)`` metrics to the running ones.

Not in the port yet, each raising when asked for: the ``lion`` and ``sgd``
optimizers, the MLM and seq2seq objectives, an EMA of the weights,
``evaluate`` and ``fit``; meshes (the JAX config's ``mesh``), dropout and
``loss_chunk`` raise at the model config.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Dict, Optional

import torch

from tpu_parallel_torch.core.accumulate import accumulate_gradients
from tpu_parallel_torch.core.metrics import Metrics, accumulate_metrics
from tpu_parallel_torch.core.metrics import compute as compute_metrics
from tpu_parallel_torch.core.optim import AdamW, Chain, ClipByGlobalNorm
from tpu_parallel_torch.core.state import TextBatch, TrainState
from tpu_parallel_torch.data import lm_batch
from tpu_parallel_torch.models.convert import init_params
from tpu_parallel_torch.models.gpt import GPTConfig, GPTLM, gpt2_125m, make_gpt_loss, tiny_test
from tpu_parallel_torch.runtime import resolve_device
from tpu_parallel_torch.utils.profiling import mfu

MODEL_REGISTRY: Dict[str, Callable[..., GPTConfig]] = {
    "gpt2_125m": gpt2_125m,
    "tiny": tiny_test,
}


@dataclasses.dataclass
class TrainerConfig:
    """The JAX ``TrainerConfig``'s fields that apply on one device, with its
    defaults."""

    model: str = "gpt2_125m"
    model_overrides: Dict[str, Any] = dataclasses.field(default_factory=dict)
    global_batch_size: int = 32
    num_minibatches: int = 1
    steps: int = 20
    optimizer: str = "adamw"
    objective: str = "causal"
    # "cosine" (decay to 10% of peak) | "linear" (decay to 0) | "constant";
    # all include the linear warmup over warmup_steps
    lr_schedule: str = "cosine"
    learning_rate: float = 3e-4
    ema_decay: float = 0.0
    warmup_steps: int = 10
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    seed: int = 0
    log_every: int = 10


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
    """Global-norm clip then ``config.optimizer`` with the schedule; adamw
    is ``optax.adamw(schedule, weight_decay=config.weight_decay)``."""
    if config.optimizer != "adamw":
        if config.optimizer in ("lion", "sgd"):
            raise NotImplementedError(f"optimizer={config.optimizer!r} is not in the port yet")
        raise ValueError(f"unknown optimizer {config.optimizer!r} (expected adamw | lion | sgd)")
    adamw = AdamW(make_lr_schedule(config), weight_decay=config.weight_decay)
    return Chain(ClipByGlobalNorm(config.grad_clip), adamw)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Trainer:
    """Owns the model, the optimizer and the train step, on one device.

    ``device`` defaults to ``"cuda"`` and raises without a GPU.  The model
    is drawn from ``config.seed``; :meth:`init` builds the state, from those
    draws or from given fp32 weights (e.g. ``params_from_jax(tree, cfg,
    dtype=torch.float32)``).
    """

    def __init__(self, config: TrainerConfig, *, device="cuda"):
        if config.objective != "causal":
            raise NotImplementedError(f"objective={config.objective!r}: the port trains 'causal'")
        if config.ema_decay:
            raise NotImplementedError("ema_decay > 0 (an EMA of the weights) is not in the port yet")
        if config.model not in MODEL_REGISTRY:
            raise KeyError(f"model {config.model!r}: the port has {sorted(MODEL_REGISTRY)}")
        self.config = config
        self.device = resolve_device(device)
        overrides = {k: v for k, v in config.model_overrides.items() if v is not None}
        self.model_config: GPTConfig = MODEL_REGISTRY[config.model](**overrides)
        self.model = GPTLM(self.model_config, device=self.device, seed=config.seed)
        self.tx = make_optimizer(config)
        self.loss_fn = make_gpt_loss(self.model_config)
        self.example_batch: TextBatch = lm_batch(
            torch.Generator().manual_seed(0), config.global_batch_size,
            self.model_config.seq_len, self.model_config.vocab_size, device=self.device,
        )
        self.state: Optional[TrainState] = None

    def init(self, params: Optional[Dict[str, torch.Tensor]] = None) -> TrainState:
        """A fresh state: masters from ``params`` (fp32 by parameter name)
        or from the seeded draws."""
        if params is None:
            params = init_params(self.model, self.config.seed)
        rng = torch.Generator(device=self.device).manual_seed(self.config.seed)
        self.state = TrainState.create(self.model, self.tx, rng, params)
        return self.state

    def step_fn(self, state: TrainState, metrics: Optional[Metrics],
                batch: TextBatch) -> tuple:
        """One optimizer step on ``batch`` -> ``(state, metrics)``, with the
        step's metrics added to ``metrics``."""
        grads, step_metrics = accumulate_gradients(
            state, batch, state.rng, self.config.num_minibatches, self.loss_fn
        )
        state.apply_gradients(grads)
        return state, accumulate_metrics(metrics, step_metrics)

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
        for step in range(1, steps + 1):
            batch = next(batch_iter) if batch_iter is not None else self.example_batch
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
                util = mfu(last["tokens_per_sec"], self.model_config, self.device)
                if util is not None:
                    last["mfu"] = util
                if log_fn is not None:
                    log_fn(step, last)
        self.state = state
        return last

    def evaluate(self, *args, **kwargs):
        raise NotImplementedError("Trainer.evaluate is not in the port yet")

    def fit(self, *args, **kwargs):
        raise NotImplementedError("Trainer.fit (checkpointed training) is not in the port yet")
