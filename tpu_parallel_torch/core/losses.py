"""Losses: the port of ``tpu_parallel/core/losses.py`` (the single-device
parts: per-token CE and the causal-LM loss)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


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
