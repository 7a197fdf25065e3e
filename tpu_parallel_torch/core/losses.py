"""Losses: the port of ``tpu_parallel/core/losses.py`` (per-token CE, the
causal-LM loss and the classification loss; the vocab-parallel CE comes
with tensor parallelism)."""

from __future__ import annotations

from typing import Sequence, Union

import torch
import torch.nn.functional as F

from tpu_parallel_torch.core.rng import fold_rng_over_axis

AxisNames = Union[str, Sequence[str]]


def token_cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-token CE with fp32 math from logits of any dtype: [..., vocab] and
    integer [...] targets -> [...] fp32."""
    vocab = logits.shape[-1]
    ce = F.cross_entropy(
        logits.float().reshape(-1, vocab), targets.reshape(-1).long(), reduction="none"
    )
    return ce.reshape(targets.shape)


def make_lm_loss():
    """Next-token cross-entropy for a ``TextBatch`` with loss masking, on the
    model's full logits: ``loss_fn(model, batch, rng) -> (loss, metrics)``
    with ``(sum, count)`` metrics ``loss`` and ``accuracy``.  ``rng`` is
    unused (no dropout in the port)."""

    def loss_fn(model, batch, rng=None):
        logits = model(batch.tokens, positions=batch.positions)
        loss = token_cross_entropy(logits, batch.targets)
        mask = batch.loss_mask if batch.loss_mask is not None else torch.ones_like(loss)
        n_tok = mask.sum()
        correct = ((logits.argmax(-1) == batch.targets) * mask).sum()
        loss_sum = (loss * mask).sum()
        metrics = {"loss": (loss_sum, n_tok), "accuracy": (correct.float(), n_tok)}
        return loss_sum / n_tok.clamp(min=1.0), metrics

    return loss_fn


def make_classification_loss(fold_axes: AxisNames = "data", mesh=None):
    """Softmax CE for a ``Batch``: ``loss_fn(model, batch, rng) -> (loss,
    metrics)``, the batch mean, with ``(sum, count)`` metrics ``loss`` and
    ``accuracy``.  Dropout draws from ``rng`` folded over ``fold_axes`` of
    ``mesh`` (per-rank masks; no mesh: ``rng`` itself)."""

    def loss_fn(model, batch, rng):
        dropout_rng = fold_rng_over_axis(rng, fold_axes, mesh)
        logits = model(batch.inputs, train=True, rng=dropout_rng)
        loss = F.cross_entropy(logits, batch.labels.long(), reduction="none")
        correct = (logits.argmax(-1) == batch.labels).sum()
        bs = torch.tensor(float(batch.labels.numel()), device=logits.device)
        metrics = {"loss": (loss.sum(), bs), "accuracy": (correct.float(), bs)}
        return loss.mean(), metrics

    return loss_fn
