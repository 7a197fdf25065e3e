"""Synthetic batches: the port of ``tpu_parallel/data/synthetic.py`` (the
LM part).  Draws come from a ``torch.Generator``; they are not jax.random's,
so tests that need the same batch on both sides make it with numpy."""

from __future__ import annotations

import torch

from tpu_parallel_torch.core.state import TextBatch


def lm_batch(rng: torch.Generator, batch_size: int, seq_len: int, vocab_size: int,
             device=None) -> TextBatch:
    """Next-token-prediction batch from a random token stream, drawn on the
    generator's device and placed on ``device`` (default: the same)."""
    tokens = torch.randint(0, vocab_size, (batch_size, seq_len + 1), generator=rng,
                           device=rng.device).to(device or rng.device)
    return TextBatch(
        tokens=tokens[:, :-1],
        targets=tokens[:, 1:],
        loss_mask=torch.ones(batch_size, seq_len, device=tokens.device),
        positions=torch.arange(seq_len, device=tokens.device).expand(batch_size, seq_len),
    )
