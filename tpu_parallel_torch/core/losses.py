"""Losses: the port of ``tpu_parallel/core/losses.py`` (the slice's part)."""

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
