"""Autoregressive generation with a KV cache: the port of
``tpu_parallel/models/generate.py``.

A prefill over the prompt fills every layer's cache, then a Python loop of
single-token decode steps appends to it and attends the cached prefix.  The
cache is updated in place.  Sampling draws from an explicit
``torch.Generator`` (it will not give the JAX package's random bits: only
greedy decoding is comparable token for token).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from tpu_parallel_torch.models.gpt import GPTLM
from tpu_parallel_torch.models.layers import KVCache


def _sample(logits, generator: Optional[torch.Generator], temperature: float,
            top_k: int, top_p: float = 0.0) -> torch.Tensor:
    """One token per row from [batch, vocab] logits, in fp32.

    ``temperature == 0`` is greedy.  ``top_k`` keeps the k highest logits;
    ``top_p`` in (0, 1) keeps the smallest prefix of the sorted distribution
    whose mass reaches p (the argmax always survives).  Both filters compose
    and apply after the temperature scale.
    """
    logits = logits.float()
    if temperature == 0.0:
        return logits.argmax(dim=-1)
    logits = logits / temperature
    if top_k > 0:
        kth = logits.topk(top_k, dim=-1).values[:, -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if 0.0 < top_p < 1.0:
        desc = logits.sort(dim=-1, descending=True).values
        probs = torch.softmax(desc, dim=-1)
        # keep tokens whose mass BEFORE them is < p (so top-1 always stays)
        keep = probs.cumsum(dim=-1) - probs < top_p
        cutoff = torch.where(keep, desc, torch.full_like(desc, float("inf")))
        cutoff = cutoff.amin(dim=-1, keepdim=True)
        logits = logits.masked_fill(logits < cutoff, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def decode_step(model: GPTLM, cache: List[KVCache], tok, positions):
    """One single-token decode tick.  ``tok``/``positions``: [batch] current
    tokens and their global positions.  Returns ``(hidden [batch, 1,
    d_model], cache)``; the cache is the same object, updated in place."""
    hidden = model(tok[:, None], positions=positions[:, None], decode=True,
                   hidden_only=True, cache=cache)
    return hidden, cache


def padded_prefill_inputs(lengths, width: int, device=None):
    """RIGHT-padded prefill positions for prompts of ``lengths`` in a
    ``width``-wide bucket: real tokens get 0..len-1, pad slots -1.  Returns
    ``(positions [b, width] int32, last_idx [b] int32)``."""
    lengths = torch.as_tensor(lengths, dtype=torch.int32, device=device)
    iota = torch.arange(width, dtype=torch.int32, device=lengths.device)[None, :]
    positions = torch.where(iota < lengths[:, None], iota, torch.full_like(iota, -1))
    return positions, lengths - 1


def prefill_step(model: GPTLM, tokens, positions) -> Tuple[torch.Tensor, List[KVCache]]:
    """Fresh-cache prefill over ``tokens`` [b, P] at explicit ``positions``
    [b, P] (pads -1: written to the cache's position table, never attended).
    Returns ``(hidden [b, P, d_model], cache)``."""
    cache = model.init_cache(tokens.shape[0])
    hidden = model(tokens, positions=positions, decode=True, hidden_only=True, cache=cache)
    return hidden, cache


def _generate_core(model: GPTLM, prompt, generator, max_new_tokens: int,
                   temperature: float, top_k: int, top_p: float = 0.0,
                   prompt_mask=None) -> torch.Tensor:
    """Prefill then decode loop.  The lm_head reads only each step's last
    position.  ``prompt_mask`` [b, P] serves RAGGED batches: rows LEFT-padded
    (False at the left), each continuing from its own length."""
    cfg = model.config
    b, prompt_len = prompt.shape
    if prompt_len + max_new_tokens > cfg.seq_len:
        raise ValueError(
            f"prompt ({prompt_len}) + max_new_tokens ({max_new_tokens}) "
            f"exceeds seq_len ({cfg.seq_len})"
        )

    def next_token(hidden):
        return _sample(model.lm_head(hidden[:, -1]), generator, temperature, top_k, top_p)

    if prompt_mask is None:
        positions = torch.arange(prompt_len, device=prompt.device).expand(b, prompt_len)
        lengths = torch.full((b,), prompt_len, dtype=torch.long, device=prompt.device)
    else:
        if tuple(prompt_mask.shape) != tuple(prompt.shape):
            raise ValueError(
                f"prompt_mask shape {tuple(prompt_mask.shape)} != prompt shape "
                f"{tuple(prompt.shape)}"
            )
        m = prompt_mask.long()
        positions = torch.where(m > 0, m.cumsum(dim=1) - 1, torch.full_like(m, -1))
        lengths = m.sum(dim=1)
    hidden, cache = prefill_step(model, prompt, positions)
    tok = next_token(hidden)
    out = [tok]
    pos = lengths
    for _ in range(max_new_tokens - 1):
        hidden, cache = decode_step(model, cache, tok, pos)
        tok = next_token(hidden)
        out.append(tok)
        pos = pos + 1
    return torch.stack(out, dim=1)


@torch.inference_mode()
def generate(model: GPTLM, prompt, generator: Optional[torch.Generator] = None, *,
             max_new_tokens: int = 32, temperature: float = 0.0, top_k: int = 0,
             top_p: float = 0.0, prompt_mask=None) -> torch.Tensor:
    """Generate ``max_new_tokens`` continuations of ``prompt`` [batch, P].

    Returns the continuation only, [batch, max_new_tokens] (greedy when
    ``temperature == 0``).  ``prompt`` (and ``prompt_mask``) must be on the
    model's device; ``generator`` too, and defaults to one seeded with 0.
    """
    if prompt.device != model.device:
        raise ValueError(f"prompt is on {prompt.device}, the model on {model.device}")
    if generator is None:
        generator = torch.Generator(device=model.device).manual_seed(0)
    return _generate_core(
        model, prompt, generator, max_new_tokens, temperature, top_k, top_p,
        prompt_mask=prompt_mask,
    )
