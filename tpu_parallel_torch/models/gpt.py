"""Decoder-only transformer LM: the port of ``tpu_parallel/models/gpt.py``.

``GPTLM`` holds its weights (made from a seed, or loaded
from a JAX parameter tree through ``models/convert.py``) and keeps the
JAX call's keywords: ``positions``, ``segment_ids``, ``train`` (dropout,
drawn from ``rng``), ``decode`` (with a per-layer list of :class:`KVCache`,
updated in place) and ``hidden_only``.  :func:`make_gpt_loss` is the
training loss, with the lm_head applied in it, ``loss_chunk`` positions at
a time when that is set.  Under ``config.fsdp`` and a mesh, the blocks,
the embedding and the lm_head are FSDP-sharded over the data axis
(``parallel/fsdp.py``); the loss gathers the lm_head once for all its
chunks.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from tpu_parallel_torch.core.losses import token_cross_entropy
from tpu_parallel_torch.core.rng import fold_rng_over_axis
from tpu_parallel_torch.models.convert import init_params
from tpu_parallel_torch.models.layers import (
    BlockStack,
    Embedding,
    KVCache,
    PagedKVCache,
    TransformerConfig,
    make_norm,
)
from tpu_parallel_torch.parallel.fsdp import gather_module_params, maybe_shard
from tpu_parallel_torch.runtime import resolve_device

_PIPELINE_DEFAULTS = (
    ("pipe_size", 1), ("pipe_interleave", 1), ("pipe_schedule", "gpipe"),
)


@dataclasses.dataclass(frozen=True)
class GPTConfig(TransformerConfig):
    """TransformerConfig plus the JAX package's pipeline knobs, which the
    port does not implement yet (setting one raises, ROADMAP queue A item
    5), and ``loss_chunk``: > 0 runs the lm_head and cross-entropy
    ``loss_chunk`` sequence positions at a time, each chunk checkpointed,
    so the logits exist only as [batch, loss_chunk, vocab]."""

    pipe_size: int = 1
    pipe_interleave: int = 1
    pipe_schedule: str = "gpipe"
    loss_chunk: int = 0

    def __post_init__(self):
        super().__post_init__()
        for field, default in _PIPELINE_DEFAULTS:
            if getattr(self, field) != default:
                raise NotImplementedError(
                    f"{field}={getattr(self, field)!r}: pipeline parallelism is not in "
                    "the PyTorch port yet (ROADMAP queue A item 5)"
                )
        if self.loss_chunk < 0:
            raise ValueError(f"loss_chunk={self.loss_chunk} < 0")


class GPTLM(nn.Module):
    """tokens [B, S] -> logits [B, S, vocab] in ``config.dtype``.

    ``device`` defaults to ``"cuda"`` and raises without a GPU; the weights
    are drawn from ``seed`` with a CPU ``torch.Generator`` (the same weights
    on every device).  The lm_head is untied from the token embedding.
    ``mesh`` (``runtime.make_mesh``) binds the data axis that
    ``config.fsdp`` shards over; without one an FSDP config holds full
    weights, as JAX's wrap is the identity on an unbound axis.
    """

    def __init__(self, config: GPTConfig, *, device="cuda", seed: int = 0, mesh=None):
        super().__init__()
        dev = resolve_device(device)
        self.config = config
        self.embed = maybe_shard(Embedding(config, dev), config, mesh)
        self.blocks = BlockStack(config, config.n_layers, dev, mesh)
        self.norm_final = make_norm(config, dev)
        self.lm_head = maybe_shard(nn.Linear(config.d_model, config.vocab_size, bias=False,
                                             dtype=config.dtype, device=dev), config, mesh)
        init_params(self, seed)

    @property
    def device(self) -> torch.device:
        return self.lm_head.weight.device

    def init_cache(self, batch: int, beam_width: Optional[int] = None) -> List[KVCache]:
        """An empty decode cache, one :class:`KVCache` of ``seq_len`` slots
        per layer, for ``batch`` rows; under ``kv_block_tokens`` > 0 one
        :class:`PagedKVCache` pool per layer instead (row-count free, as
        JAX's paged cache: rows address it through block tables).  Under
        ``kv_cache_dtype="int8"`` either layout holds int8 payloads and
        fp32 scale stores.

        ``beam_width`` (default ``config.beam_width``) > 1 gives each
        layer's cache its own ``beam_src`` table, the identity ([batch,
        seq_len], row r's slots all held by row r), as JAX keeps one per
        layer; every layer's table is equal by construction.  Decode steps
        then read through lazy beam attention, ``batch`` rows being
        ``batch // beam_width`` prompts of ``beam_width`` beams each."""
        cfg = self.config
        beam_width = cfg.beam_width if beam_width is None else beam_width
        if cfg.kv_block_tokens:
            if beam_width > 1:
                raise NotImplementedError(
                    "paged KV cache under lazy beam search (the beam_src bookkeeping "
                    "assumes contiguous per-row caches)"
                )
            return [PagedKVCache.empty(cfg, self.device) for _ in range(cfg.n_layers)]
        caches = [KVCache.empty(cfg, batch, self.device) for _ in range(cfg.n_layers)]
        if beam_width > 1:
            for c in caches:
                c.seed_beam_src(beam_width)
        return caches

    def forward(self, tokens, positions=None, segment_ids=None, decode: bool = False,
                hidden_only: bool = False, cache: Optional[List[KVCache]] = None,
                write_index=None, block_table=None, train: bool = False,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        """``train=True`` runs dropout when ``dropout_rate`` > 0, with one
        seed per layer drawn from ``rng`` (a CPU generator).  ``decode=True`` appends to ``cache`` (from :meth:`init_cache`) and
        attends the cached prefix; without ``positions`` it continues from
        the cache's write index.  ``write_index`` [batch] (the serving
        engine's slot-indexed writes) puts row r's tokens at cache columns
        ``write_index[r] + [0..T)``, dropping targets outside the cache.
        ``block_table`` [batch, seq_len // block_tokens] addresses a
        :class:`PagedKVCache` pool (-1 = unmapped: reads masked out, writes
        dropped); it needs ``write_index``."""
        cfg = self.config
        if block_table is not None and not decode:
            raise ValueError("block_table needs decode=True")
        if write_index is not None and not decode:
            raise ValueError("write_index needs decode=True")
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
        dropout_rng = None
        if train and cfg.dropout_rate > 0.0:
            if rng is None:
                raise ValueError("train=True with dropout_rate > 0 needs an rng (a CPU "
                                 "torch.Generator)")
            dropout_rng = rng
        x = self.embed(tokens, positions)
        x = self.blocks(x, positions, segment_ids, decode, cache if decode else None,
                        write_index, block_table, dropout_rng)
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
    """The lm_head weight the loss applies, gathered ONCE when FSDP-sharded
    (every chunk of the chunked loss reuses it; its backward reduce-scatters
    the gradient of all chunks at once); otherwise the weight itself."""
    del config
    return gather_module_params(model.lm_head)["weight"]


def make_ce_fn(config: GPTConfig):
    """``(lm_weight, hidden, targets, mask) -> (loss_sum, correct_sum)``:
    lm_head, fp32 cross-entropy and accuracy (the JAX ``make_ce_fn`` off the
    mesh), on full logits or, under ``config.loss_chunk``, one checkpointed
    chunk of ``loss_chunk`` positions at a time (the JAX scan of
    ``jax.checkpoint(body)``): the backward recomputes each chunk's logits,
    so none outlives its chunk."""
    chunk = config.loss_chunk

    def ce_block(lm_weight, h, targets, mask):
        logits = F.linear(h, lm_weight)
        ce = token_cross_entropy(logits, targets)
        loss_sum = (ce * mask).sum()
        correct = ((logits.argmax(-1) == targets) * mask).sum()
        return loss_sum, correct

    def chunked_ce(lm_weight, h, targets, mask):
        s = targets.shape[1]
        if s % chunk != 0:
            raise ValueError(f"seq_len={s} not divisible by loss_chunk={chunk}")
        loss_sum = correct = 0.0
        for i in range(0, s, chunk):
            part = checkpoint(ce_block, lm_weight, h[:, i:i + chunk], targets[:, i:i + chunk],
                              mask[:, i:i + chunk], use_reentrant=False)
            loss_sum = loss_sum + part[0]
            correct = correct + part[1]
        return loss_sum, correct

    return chunked_ce if chunk else ce_block


def make_gpt_loss(config: GPTConfig, train: bool = True, mesh=None):
    """Next-token CE in the ``accumulate_gradients`` loss shape:
    ``loss_fn(model, batch, rng) -> (loss, metrics)``.

    The model runs with ``hidden_only=True`` and the lm_head is applied here,
    as in the JAX package.  ``rng`` (a CPU generator) seeds dropout when
    ``train``, folded over the config's data, model, pipe and seq axes of
    ``mesh`` as JAX folds it (per-rank masks under data parallelism; no
    mesh: ``rng`` itself); ``train=False`` builds the evaluation variant
    (dropout off).  Pipeline, tensor parallelism and MoE raise at the
    config.
    """
    ce_fn = make_ce_fn(config)
    fold_axes = (config.data_axis, config.model_axis, config.pipe_axis, config.seq_axis)

    def loss_fn(model, batch, rng=None):
        if train and config.dropout_rate > 0.0 and rng is not None:
            rng = fold_rng_over_axis(rng, fold_axes, mesh)
        hidden = model(batch.tokens, positions=batch.positions,
                       segment_ids=batch.segment_ids, hidden_only=True, train=train, rng=rng)
        mask = (batch.loss_mask if batch.loss_mask is not None
                else torch.ones(batch.targets.shape, device=hidden.device))
        n_tok = mask.sum()
        loss_sum, correct = ce_fn(_lm_head_params(config, model), hidden, batch.targets, mask)
        metrics = {"loss": (loss_sum, n_tok), "accuracy": (correct.float(), n_tok)}
        return loss_sum / n_tok.clamp(min=1.0), metrics

    return loss_fn
