"""Per-row sampling filters: the port of ``filter_logits`` from
``tpu_parallel/serving/spec_decode.py``.

:func:`~tpu_parallel_torch.serving.engine.sample_tokens` draws from this
filtered distribution, and speculative decoding's rejection rule
(:func:`~tpu_parallel_torch.serving.spec_decode.target_probs`) verifies
against the same one.
"""

from __future__ import annotations

import torch


def filter_logits(logits, temperature, top_k, top_p) -> torch.Tensor:
    """Per-row filters over [rows, vocab] logits with per-row knob tensors
    [rows], in fp32: temperature scale first, then top-k and top-p by
    intersection, the argmax always surviving the nucleus cut;
    ``top_k <= 0`` and ``top_p`` outside (0, 1) disable that filter.
    Greedy rows (``temperature <= 0``) get a guarded divide: callers take
    the argmax for them and never read their filtered values."""
    lf = logits.float()
    t = torch.where(temperature > 0.0, temperature, torch.ones_like(temperature))[:, None]
    x = lf / t
    vocab = x.shape[-1]
    # per-row top-k: the kth-largest value through one ascending sort
    k = top_k.to(torch.long).clamp(0, vocab)
    asc = torch.sort(x, dim=-1).values
    kth = asc.gather(-1, (vocab - k).clamp(0, vocab - 1)[:, None])
    x = x.masked_fill((k > 0)[:, None] & (x < kth), float("-inf"))
    # per-row nucleus on the (already top-k-filtered) distribution
    desc = torch.flip(torch.sort(x, dim=-1).values, dims=(-1,))
    probs = torch.softmax(desc, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = cum - probs < top_p[:, None]  # mass BEFORE the token < p
    cutoff = desc.masked_fill(~keep, float("inf")).amin(dim=-1, keepdim=True)
    use_p = ((top_p > 0.0) & (top_p < 1.0))[:, None]
    return x.masked_fill(use_p & (x < cutoff), float("-inf"))
