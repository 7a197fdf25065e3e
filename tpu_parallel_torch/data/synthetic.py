"""Synthetic batches: the port of ``tpu_parallel/data/synthetic.py``
(classification, LM and seq2seq).  Draws come from a ``torch.Generator``;
they are not jax.random's, so tests that need the same batch on both sides
make it with numpy."""

from __future__ import annotations

import torch

from tpu_parallel_torch.core.state import Batch, TextBatch


def classification_batch(rng: torch.Generator, batch_size: int, input_size: int,
                         num_classes: int, device=None) -> Batch:
    """Normal inputs [batch, input_size] and integer labels in
    [0, num_classes), drawn on the generator's device and placed on
    ``device`` (default: the same)."""
    inputs = torch.randn(batch_size, input_size, generator=rng, device=rng.device)
    labels = torch.randint(0, num_classes, (batch_size,), generator=rng, device=rng.device)
    return Batch(inputs=inputs.to(device or rng.device), labels=labels.to(device or rng.device))


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


def seq2seq_batch(rng: torch.Generator, batch_size: int, src_len: int, dst_len: int,
                  vocab_size: int, bos_id: int = 1, device=None):
    """Teacher-forced seq2seq batch (a ``Seq2SeqBatch``): random source
    tokens in [2, vocab_size), the target the source cycled to ``dst_len``
    (a learnable copy task, shape-exact for every ``dst_len``), the decoder
    input BOS then the target shifted right, and an all-True ``src_mask``;
    drawn on the generator's device and placed on ``device`` (default: the
    same)."""
    from tpu_parallel_torch.models.seq2seq import Seq2SeqBatch

    src = torch.randint(2, vocab_size, (batch_size, src_len), generator=rng,
                        device=rng.device).to(device or rng.device)
    reps = -(-dst_len // src_len)  # ceil
    tgt = src.repeat(1, reps)[:, :dst_len]
    bos = torch.full((batch_size, 1), bos_id, dtype=src.dtype, device=src.device)
    return Seq2SeqBatch(src_tokens=src, tokens=torch.cat([bos, tgt[:, :-1]], dim=1),
                        targets=tgt, src_mask=torch.ones_like(src, dtype=torch.bool))
