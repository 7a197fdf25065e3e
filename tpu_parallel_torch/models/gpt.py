"""Decoder-only transformer LM: the port of ``tpu_parallel/models/gpt.py``.

Single device.  ``GPTLM`` holds its weights (made from a seed, or loaded
from a JAX parameter tree through ``models/convert.py``) and keeps the
JAX call's keywords: ``positions``, ``segment_ids``, ``decode`` (with a per-layer
list of :class:`KVCache`, updated in place) and ``hidden_only``.
:func:`make_gpt_loss` is the training loss, with the lm_head applied in it.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from tpu_parallel_torch.core.losses import token_cross_entropy
from tpu_parallel_torch.models.convert import init_params
from tpu_parallel_torch.models.layers import (
    BlockStack,
    Embedding,
    KVCache,
    TransformerConfig,
    make_norm,
)
from tpu_parallel_torch.runtime import resolve_device

_PIPELINE_DEFAULTS = (
    ("pipe_size", 1), ("pipe_interleave", 1), ("pipe_schedule", "gpipe"),
    ("loss_chunk", 0),
)


@dataclasses.dataclass(frozen=True)
class GPTConfig(TransformerConfig):
    """TransformerConfig plus the JAX package's pipeline and chunked-loss
    knobs, which this slice does not implement (setting one raises)."""

    pipe_size: int = 1
    pipe_interleave: int = 1
    pipe_schedule: str = "gpipe"
    loss_chunk: int = 0

    def __post_init__(self):
        super().__post_init__()
        for field, default in _PIPELINE_DEFAULTS:
            if getattr(self, field) != default:
                raise NotImplementedError(
                    f"{field}={getattr(self, field)!r}: pipeline parallelism and "
                    "the chunked loss are not in the PyTorch port yet"
                )


class GPTLM(nn.Module):
    """tokens [B, S] -> logits [B, S, vocab] in ``config.dtype``.

    ``device`` defaults to ``"cuda"`` and raises without a GPU; the weights
    are drawn from ``seed`` with a CPU ``torch.Generator`` (the same weights
    on every device).  The lm_head is untied from the token embedding.
    """

    def __init__(self, config: GPTConfig, *, device="cuda", seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.config = config
        self.embed = Embedding(config, dev)
        self.blocks = BlockStack(config, config.n_layers, dev)
        self.norm_final = make_norm(config, dev)
        self.lm_head = nn.Linear(config.d_model, config.vocab_size, bias=False,
                                 dtype=config.dtype, device=dev)
        init_params(self, seed)

    @property
    def device(self) -> torch.device:
        return self.lm_head.weight.device

    def init_cache(self, batch: int) -> List[KVCache]:
        """An empty decode cache, one :class:`KVCache` of ``seq_len`` slots
        per layer, for ``batch`` rows."""
        return [KVCache.empty(self.config, batch, self.device) for _ in range(self.config.n_layers)]

    def forward(self, tokens, positions=None, segment_ids=None, decode: bool = False,
                hidden_only: bool = False, cache: Optional[List[KVCache]] = None,
                write_index=None, block_table=None) -> torch.Tensor:
        """``decode=True`` appends to ``cache`` (from :meth:`init_cache`) and
        attends the cached prefix; without ``positions`` it continues from
        the cache's write index.  ``write_index``/``block_table`` (the
        serving engine's slot-indexed and paged writes) are not in the port
        yet and raise."""
        cfg = self.config
        if write_index is not None or block_table is not None:
            raise NotImplementedError(
                "slot-indexed (write_index) and paged (block_table) cache writes "
                "come with the serving-engine slice of the port"
            )
        if decode:
            if cache is None:
                raise ValueError("decode=True needs a cache (GPTLM.init_cache)")
            if positions is None:
                t = tokens.shape[1]
                positions = (cache[0].index + torch.arange(t, device=tokens.device)).expand(
                    tokens.shape[0], t
                )
        elif tokens.shape[1] > cfg.seq_len:
            raise ValueError(f"{tokens.shape[1]} tokens exceed seq_len {cfg.seq_len}")
        x = self.embed(tokens, positions)
        x = self.blocks(x, positions, segment_ids, decode, cache if decode else None)
        x = self.norm_final(x).to(cfg.dtype)
        if hidden_only:
            return x
        return self.lm_head(x)


def gpt2_125m(**overrides) -> GPTConfig:
    return GPTConfig(**{
        **dict(vocab_size=50304, d_model=768, n_layers=12, n_heads=12, seq_len=1024),
        **overrides,
    })


def tiny_test(**overrides) -> GPTConfig:
    """Small config for CPU tests: real structure, toy sizes, fp32."""
    return GPTConfig(**{
        **dict(vocab_size=256, d_model=32, n_layers=4, n_heads=4, seq_len=32,
               dtype=torch.float32, num_microbatches=2),
        **overrides,
    })


def _lm_head_params(config: GPTConfig, model: GPTLM) -> torch.Tensor:
    """The lm_head weight the loss applies.  The JAX version gathers it once
    when FSDP-sharded; on one device it is the weight itself."""
    del config
    return model.lm_head.weight


def make_ce_fn():
    """``(lm_weight, hidden, targets, mask) -> (loss_sum, correct_sum)``:
    lm_head, fp32 cross-entropy and accuracy on full logits (the JAX
    ``make_ce_fn`` off the mesh).  ``loss_chunk`` raises at the config."""

    def ce_block(lm_weight, h, targets, mask):
        logits = F.linear(h, lm_weight)
        ce = token_cross_entropy(logits, targets)
        loss_sum = (ce * mask).sum()
        correct = ((logits.argmax(-1) == targets) * mask).sum()
        return loss_sum, correct

    return ce_block


def make_gpt_loss(config: GPTConfig):
    """Next-token CE in the ``accumulate_gradients`` loss shape:
    ``loss_fn(model, batch, rng) -> (loss, metrics)``.

    The model runs with ``hidden_only=True`` and the lm_head is applied here,
    as in the JAX package.  ``rng`` is unused: the port has no dropout.
    Pipeline, tensor parallelism, MoE and ``loss_chunk`` raise at the config.
    """
    ce_fn = make_ce_fn()

    def loss_fn(model, batch, rng=None):
        hidden = model(batch.tokens, positions=batch.positions,
                       segment_ids=batch.segment_ids, hidden_only=True)
        mask = (batch.loss_mask if batch.loss_mask is not None
                else torch.ones(batch.targets.shape, device=hidden.device))
        n_tok = mask.sum()
        loss_sum, correct = ce_fn(_lm_head_params(config, model), hidden, batch.targets, mask)
        metrics = {"loss": (loss_sum, n_tok), "accuracy": (correct.float(), n_tok)}
        return loss_sum / n_tok.clamp(min=1.0), metrics

    return loss_fn
