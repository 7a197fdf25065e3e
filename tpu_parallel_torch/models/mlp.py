"""MLP classifier, the parity model of the DP tutorials: the port of
``tpu_parallel/models/mlp.py``.

``hidden_{i}`` Dense layers with SiLU and dropout, then ``head``, computed
in ``config.dtype`` with the output cast to fp32.  flax infers a Dense's
input width at init; a ``Linear`` needs it, so the model takes
``input_size``.  ``dense_wrapper`` transforms the Dense class the model
builds every layer from (a sharding or tensor-parallel wrapper), so one
definition serves every strategy.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from tpu_parallel_torch.models.convert import init_params
from tpu_parallel_torch.models.layers import dropout
from tpu_parallel_torch.runtime import resolve_device


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    hidden_size: int = 512
    num_classes: int = 10
    dropout_rate: float = 0.1
    dtype: torch.dtype = torch.bfloat16
    num_hidden_layers: int = 1


class MLPClassifier(nn.Module):
    """inputs [batch, input_size] -> fp32 logits [batch, num_classes].

    ``device`` defaults to ``"cuda"`` and raises without a GPU; weights are
    drawn from ``seed`` with flax's Dense defaults (``convert.init_params``).
    ``dense_wrapper(nn.Linear)`` returns the class (or factory) each layer
    is built with, called as ``dense(in_features, out_features, dtype=,
    device=)``.
    """

    def __init__(self, config: MLPConfig, input_size: int, *,
                 dense_wrapper: Optional[Callable] = None, device="cuda", seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.config = config
        dense = nn.Linear if dense_wrapper is None else dense_wrapper(nn.Linear)
        width = input_size
        for i in range(config.num_hidden_layers):
            self.add_module(f"hidden_{i}", dense(width, config.hidden_size, dtype=config.dtype,
                                                 device=dev))
            width = config.hidden_size
        self.head = dense(width, config.num_classes, dtype=config.dtype, device=dev)
        init_params(self, seed)

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        """``train=True`` runs dropout when ``dropout_rate`` > 0, its masks
        drawn on the device from one seed per hidden layer taken from
        ``rng`` (a CPU generator)."""
        cfg = self.config
        seeds = None
        if train and cfg.dropout_rate > 0.0:
            if rng is None:
                raise ValueError("train=True with dropout_rate > 0 needs an rng (a CPU "
                                 "torch.Generator)")
            seeds = torch.randint(0, 2**62, (cfg.num_hidden_layers,), generator=rng).tolist()
        x = x.to(cfg.dtype)
        for i in range(cfg.num_hidden_layers):
            x = F.silu(getattr(self, f"hidden_{i}")(x))
            if seeds is not None:
                x = dropout(x, cfg.dropout_rate,
                            torch.Generator(device=x.device).manual_seed(seeds[i]))
        return self.head(x).float()
