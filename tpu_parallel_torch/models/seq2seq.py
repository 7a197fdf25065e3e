"""Encoder-decoder (seq2seq) family: the port of ``tpu_parallel/models/seq2seq.py``.

A T5-shaped model: a bidirectional encoder over the source (the
:class:`~tpu_parallel_torch.models.layers.BlockStack` with
``bidirectional=True``: on the flash path one non-causal kernel call per
layer, pads forming their own segment), a causal decoder over the target
(:class:`DecoderStack`: self-attention, cross-attention into the encoder's
output, then the MLP or the MoE layer, pre-norm), one token embedding
shared by both sides and an untied lm_head.  Under ``positional="relative"``
each stack has one :class:`~tpu_parallel_torch.models.layers.RelativePositionBias`
(bidirectional buckets for the encoder, causal for the decoder); the
cross-attention carries no bias.

Cross-attention is GQA-native and plain PyTorch (JAX leaves its einsums to
XLA): :func:`cross_attention` during training, and in decoding
:func:`cross_decode_attention` over a :class:`CrossKVCache`, the memory's
K/V projected once at prefill into a head-major ``[kv_heads, batch,
source_len, head_dim]`` layout that every decode step's batched products
read in place.  Beam search replicates the cross caches once, at the
expansion; neither beam form gathers them per step.

Every mesh strategy of the LM composes: FSDP wraps the embedding, each
block of both stacks and the lm_head; tensor parallelism splits the
projections (cross-attention's ``q`` and ``kv`` column-parallel, ``out``
row-parallel, the ``kv`` weight interleaving k|v per kv head); sequence
parallelism shards both stacks' token axes with ring or Ulysses
self-attention, and the decoder gathers the seq-sharded memory and mask
once, outside the checkpointed stack; pipeline parallelism gives each pipe
rank ``encoder_layers / pipe`` encoder blocks and ``n_layers / pipe``
decoder blocks, run as two GPipe passes: the encoder's broadcasts its
output, the decoder's takes the memory, the mask and the positions as
per-microbatch extras (the memory's gradient flows back through them).
MoE replaces the MLP in both stacks.  JAX's refusals stand, in its words:
MoE under the pipeline, the post-norm and embedding-norm knobs, the
relative bias or interleave under the pipeline, and decoding under a seq
axis or a pipe mesh.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from tpu_parallel_torch.core.rng import fold_rng_over_axis
from tpu_parallel_torch.models.convert import init_params
from tpu_parallel_torch.models.generate import (_sample, _sample_sharded, _top_k,
                                                beam_advance_src, beam_backtrack,
                                                beam_expand_cache, beam_reorder_cache,
                                                beam_seed_src)
from tpu_parallel_torch.models.gpt import GPTConfig, _lm_head_params, make_ce_fn, stage_layers
from tpu_parallel_torch.models.layers import (MLP, Attention, BlockStack, Embedding, KVCache,
                                              RelativePositionBias, _inv_sqrt_head_dim, dropout,
                                              make_norm, remat_kwargs_for, seq_parallel_active)
from tpu_parallel_torch.models.moe import MoEMLP
from tpu_parallel_torch.ops.ulysses import gather_sequence
from tpu_parallel_torch.parallel import pp
from tpu_parallel_torch.parallel.fsdp import maybe_shard
from tpu_parallel_torch.parallel import tp
from tpu_parallel_torch.parallel.tp import TPDense, model_axis
from tpu_parallel_torch.runtime import resolve_device
from tpu_parallel_torch.runtime.mesh import axis_group


@dataclasses.dataclass(frozen=True)
class Seq2SeqConfig(GPTConfig):
    """GPTConfig plus the encoder/decoder split.

    ``n_layers`` is the DECODER depth; ``enc_layers`` sizes the encoder
    (default: the same depth).  ``src_seq_len`` bounds the source length
    (the learned position table and the memory; default ``seq_len``)."""

    enc_layers: Optional[int] = None
    src_seq_len: Optional[int] = None

    @property
    def encoder_layers(self) -> int:
        return self.enc_layers if self.enc_layers is not None else self.n_layers

    @property
    def source_len(self) -> int:
        return self.src_seq_len if self.src_seq_len is not None else self.seq_len


@dataclasses.dataclass
class Seq2SeqBatch:
    """Source tokens plus teacher-forced decoder tokens and targets.

    ``src_mask`` [B, S_src] flags real source positions (False: padding,
    masked out of the encoder's attention and every cross-attention);
    ``loss_mask`` [B, S_dst] zeroes padding out of the CE."""

    src_tokens: torch.Tensor
    tokens: torch.Tensor
    targets: torch.Tensor
    src_mask: Optional[torch.Tensor] = None
    loss_mask: Optional[torch.Tensor] = None

    @property
    def size(self) -> int:
        return self.src_tokens.shape[0]

    def _map(self, fn) -> "Seq2SeqBatch":
        return Seq2SeqBatch(**{f.name: None if getattr(self, f.name) is None
                               else fn(getattr(self, f.name)) for f in dataclasses.fields(self)})

    def rows(self, start: int, stop: int) -> "Seq2SeqBatch":
        """Rows [start, stop) of every field (views, no copy)."""
        return self._map(lambda t: t[start:stop])

    def seq_block(self, index: int, count: int) -> "Seq2SeqBatch":
        """Block ``index`` of ``count`` equal blocks of every field's token
        axis (JAX's ``P("data", "seq")`` splits the source and the target
        alike): views, no copy."""
        def block(t):
            n = t.shape[1] // count
            return t[:, index * n:(index + 1) * n]
        return self._map(block)


def cross_attention(q, k, v, memory_mask=None) -> torch.Tensor:
    """Full-visibility attention of decoder queries over encoder memory,
    JAX's ``cross_attention``: ``q`` [B, T, h, dh], ``k``/``v`` [B, S, h_kv,
    dh] with ``h % h_kv == 0`` (grouped queries contract against their kv
    head, no K/V expansion), ``memory_mask`` [B, S] masking source pads
    with fp32's smallest value.  q is scaled in its dtype, the scores and
    the softmax are fp32, the products in q's dtype."""
    b, tq, h, head_dim = q.shape
    h_kv = k.shape[2]
    scale = _inv_sqrt_head_dim(head_dim, q.dtype)
    qg = (q * scale).reshape(b, tq, h_kv, h // h_kv, head_dim)
    scores = torch.einsum("bqngd,bknd->bngqk", qg, k).float()
    if memory_mask is not None:
        keep = memory_mask.bool()[:, None, None, None, :]
        scores = scores.masked_fill(~keep, torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bngqk,bknd->bqngd", probs, v)
    return out.reshape(b, tq, h, head_dim)


def cross_decode_attention(q, k_heads, v_heads, memory_mask) -> torch.Tensor:
    """:func:`cross_attention` against a head-major cross cache: ``k_heads``
    / ``v_heads`` [kv_heads, B, S, dh], contiguous, read as they lie (kv
    heads and rows collapse into the batched products' one batch dim, as
    :func:`~tpu_parallel_torch.models.layers.decode_attention` reads the
    self-attention cache); ``memory_mask`` [B, S] bool."""
    b, nq, h, head_dim = q.shape
    h_kv, _, s, _ = k_heads.shape
    group = h // h_kv
    scale = _inv_sqrt_head_dim(head_dim, q.dtype)
    qh = (q.reshape(b, nq, h_kv, group, head_dim).permute(2, 0, 3, 1, 4) * scale).reshape(
        h_kv * b, group * nq, head_dim)
    scores = torch.bmm(qh, k_heads.view(h_kv * b, s, head_dim).transpose(1, 2)).float().view(
        h_kv, b, group, nq, s)
    scores = scores.masked_fill(~memory_mask[None, :, None, None, :],
                                torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.bmm(probs.view(h_kv * b, group * nq, s), v_heads.view(h_kv * b, s, head_dim))
    return out.view(h_kv, b, group, nq, head_dim).permute(1, 3, 0, 2, 4).reshape(
        b, nq, h, head_dim)


class CrossKVCache:
    """One decoder layer's cross-attention cache (JAX's ``cross_key`` /
    ``cross_value`` / ``cross_mask``): the memory's K/V projected once at
    prefill, stored head-major ``[kv_heads, batch, source_len, head_dim]``
    (this rank's kv heads), and the source mask [batch, source_len] bool.
    Empty until the prefill writes it."""

    def __init__(self):
        self.key_heads: Optional[torch.Tensor] = None
        self.value_heads: Optional[torch.Tensor] = None
        self.mask: Optional[torch.Tensor] = None

    @property
    def filled(self) -> bool:
        return self.key_heads is not None

    def write(self, k, v, memory_mask=None) -> None:
        """Store ``k``/``v`` [B, S, kv_heads, dh] head-major (one copy each,
        at prefill) and the mask (all True without one)."""
        self.key_heads = k.permute(2, 0, 1, 3).contiguous()
        self.value_heads = v.permute(2, 0, 1, 3).contiguous()
        b, s = k.shape[:2]
        self.mask = (torch.ones(b, s, dtype=torch.bool, device=k.device) if memory_mask is None
                     else memory_mask.bool().contiguous())

    def take_rows(self, rows: torch.Tensor) -> "CrossKVCache":
        """A new cache whose row i copies row ``rows[i]`` (beam expansion)."""
        new = CrossKVCache()
        new.key_heads = self.key_heads.index_select(1, rows)
        new.value_heads = self.value_heads.index_select(1, rows)
        new.mask = self.mask.index_select(0, rows)
        return new


@dataclasses.dataclass
class Seq2SeqCache:
    """The decoder's decode state: per layer a self-attention
    :class:`~tpu_parallel_torch.models.layers.KVCache` and a
    :class:`CrossKVCache`, and the model-level decode position counter
    (JAX's ``pos_counter/decode_pos``), advanced by every decode call."""

    self_attn: List[KVCache]
    cross: List[CrossKVCache]
    index: int = 0


class CrossAttention(nn.Module):
    """Decoder-side cross-attention into the encoder memory, TP-structural:
    ``q`` column-parallel at query-head width, the memory's ``kv``
    column-parallel at kv-head width (k|v interleaved per kv head, JAX's
    layout), ``out`` row-parallel.  With ``decode=True`` and ``memory``
    given (the prefill) the projected K/V are written to ``cache``; later
    steps pass ``memory=None`` and read it, so the source is projected once
    per generation.  No checkpoint name tags its values: the remat
    policies recompute it, as JAX's unnamed einsums."""

    def __init__(self, config: Seq2SeqConfig, device=None, mesh=None):
        super().__init__()
        self.config = config
        cfg = config
        bound = model_axis(mesh, cfg.model_axis)
        tp = 1 if bound is None else bound[1]
        n_kv = cfg.n_kv_heads or cfg.n_heads
        self.local_heads = cfg.n_heads // tp
        self.local_kv = n_kv // tp

        def dense(i, o, style):
            return TPDense(i, o, style=style, axis_name=cfg.model_axis, use_bias=cfg.dense_bias,
                           dtype=cfg.dtype, device=device, mesh=mesh)

        self.q = dense(cfg.d_model, cfg.n_heads * cfg.head_dim, "column")
        self.kv = dense(cfg.d_model, 2 * n_kv * cfg.head_dim, "column")
        self.out = dense(cfg.n_heads * cfg.head_dim, cfg.d_model, "row")

    def forward(self, x, memory, memory_mask=None, decode: bool = False,
                cache: Optional[CrossKVCache] = None,
                dropout_gen: Optional[torch.Generator] = None) -> torch.Tensor:
        cfg = self.config
        b, t = x.shape[:2]
        dh = cfg.head_dim
        q = self.q(x).view(b, t, self.local_heads, dh)
        k = v = None
        if memory is not None:
            s = memory.shape[1]
            k, v = self.kv(memory).view(b, s, self.local_kv, 2 * dh).split(dh, dim=-1)
        elif not decode:
            raise ValueError("cross-attention needs `memory` outside decode")
        if decode:
            if k is None and (cache is None or not cache.filled):
                raise ValueError(
                    "decode step before prefill: run one decode=True apply "
                    "WITH `memory` first to populate the cross K/V cache"
                )
            if k is not None:  # prefill: project once, persist
                cache.write(k, v, memory_mask)
            out = cross_decode_attention(q, cache.key_heads, cache.value_heads, cache.mask)
        else:
            out = cross_attention(q, k, v, memory_mask)
        out = self.out(out.reshape(b, t, self.local_heads * dh))
        if dropout_gen is not None:
            out = dropout(out, cfg.dropout_rate, dropout_gen)
        return out


class DecoderBlock(nn.Module):
    """Pre-norm decoder block: x + self_attn(norm_self(x)); x +
    cross_attn(norm_cross(x), memory); x + mlp(norm_mlp(x)) (the MoE layer
    ``moe`` under ``moe_experts`` > 0, expert-choice refused when decoding).
    With a ``dropout_seed`` dropout runs after each sublayer, its masks
    drawn in that order from one generator.  Returns ``(x, balance)``."""

    def __init__(self, config: Seq2SeqConfig, device=None, mesh=None):
        super().__init__()
        self.config = config
        self.norm_self = make_norm(config, device)
        self.self_attn = Attention(config, device, mesh)
        self.norm_cross = make_norm(config, device)
        self.cross_attn = CrossAttention(config, device, mesh)
        self.norm_mlp = make_norm(config, device)
        if config.moe_experts > 0:
            self.moe = MoEMLP(config, device, mesh)
        else:
            self.mlp = MLP(config, device, mesh)

    def forward(self, x, memory, memory_mask=None, positions=None, decode: bool = False,
                self_cache=None, cross_cache=None, dropout_seed: Optional[int] = None,
                attn_bias=None):
        cfg = self.config
        if decode and cfg.moe_experts > 0 and cfg.moe_router == "expert_choice":
            raise NotImplementedError(
                "incremental decoding with expert-choice routing "
                "(the routing pool collapses to one token per row)"
            )
        dtype = cfg.dtype
        gen = None
        if dropout_seed is not None:
            gen = torch.Generator(device=x.device).manual_seed(dropout_seed)
        x = x + self.self_attn(self.norm_self(x).to(dtype), positions, None, decode, self_cache,
                               dropout_gen=gen, attn_bias=attn_bias)
        x = x + self.cross_attn(self.norm_cross(x).to(dtype), memory, memory_mask, decode,
                                cross_cache, gen)
        h = self.norm_mlp(x).to(dtype)
        if cfg.moe_experts > 0:
            y, balance = self.moe(h, dropout_gen=gen)
        else:
            y, balance = self.mlp(h, dropout_gen=gen), None
        return x + y, balance


class DecoderStack(nn.Module):
    """``n_layers`` decoder blocks named ``layer_{i}`` (``layer_ids``: a
    pipeline stage's global indices), each checkpointed under
    ``config.remat`` when gradients are taken and FSDP-sharded under
    ``config.fsdp``, as :class:`~tpu_parallel_torch.models.layers.BlockStack`.
    Decoding reads and writes ``caches`` (a :class:`Seq2SeqCache`) by
    position in the stack."""

    def __init__(self, config: Seq2SeqConfig, n_layers: int, device=None, mesh=None,
                 layer_ids: Optional[List[int]] = None):
        super().__init__()
        self.config = config
        self.layer_ids = list(range(n_layers)) if layer_ids is None else list(layer_ids)
        self.n_layers = len(self.layer_ids)
        for i in self.layer_ids:
            self.add_module(f"layer_{i}",
                            maybe_shard(DecoderBlock(config, device, mesh), config, mesh))

    def forward(self, x, memory=None, memory_mask=None, positions=None, decode: bool = False,
                caches: Optional[Seq2SeqCache] = None,
                dropout_rng: Optional[torch.Generator] = None,
                moe_losses: Optional[list] = None, attn_bias=None) -> torch.Tensor:
        remat = self.config.remat and not decode and torch.is_grad_enabled()
        kwargs = remat_kwargs_for(self.config) if remat else None
        seeds = [None] * self.n_layers
        if dropout_rng is not None:
            seeds = torch.randint(0, 2**62, (self.n_layers,), generator=dropout_rng).tolist()
        for k, i in enumerate(self.layer_ids):
            layer = getattr(self, f"layer_{i}")
            if remat:
                x, balance = checkpoint(layer, x, memory, memory_mask, positions, False, None,
                                        None, seeds[k], attn_bias, **kwargs)
            else:
                self_cache = caches.self_attn[k] if caches is not None else None
                cross_cache = caches.cross[k] if caches is not None else None
                x, balance = layer(x, memory, memory_mask, positions, decode, self_cache,
                                   cross_cache, seeds[k], attn_bias)
            if balance is not None and moe_losses is not None:
                moe_losses.append(balance)
        return x


class EncoderDecoder(nn.Module):
    """``(src [B, S_src], dst [B, S_dst]) -> logits [B, S_dst, vocab]`` in
    ``config.dtype``.

    The token embedding (``embed``, its position table as long as the
    longer side under learned positions) is shared by the encoder and the
    decoder; ``encoder`` is a bidirectional
    :class:`~tpu_parallel_torch.models.layers.BlockStack` and ``decoder`` a
    :class:`DecoderStack`, closed by ``enc_norm`` and ``dec_norm``; the
    lm_head is untied (column-parallel over the vocabulary on a model axis,
    its logits gathered by the forward, not by the loss).  Under
    ``positional="relative"`` ``enc_rel_bias`` and ``dec_rel_bias`` give
    each stack one bias for all its layers, computed from row 0's
    positions: every row must hold the same positions (ragged or packed
    rows are refused upstream).

    ``device``, ``seed`` and ``mesh`` as :class:`~tpu_parallel_torch.models.gpt.GPTLM`'s.
    """

    def __init__(self, config: Seq2SeqConfig, *, device="cuda", seed: Optional[int] = 0,
                 mesh=None):
        super().__init__()
        cfg = config
        # JAX's setup refusals, in its order and words
        if cfg.pipe_interleave > 1 and cfg.pipe_size <= 1:
            raise ValueError(
                "pipe_interleave > 1 requires pipe_size > 1 (a pipe mesh "
                "axis); on a pipe=1 mesh the knob would be silently ignored"
            )
        if cfg.moe_experts > 0 and cfg.pipe_size > 1:
            raise NotImplementedError(
                "MoE under the pipelined encoder-decoder (bubble-tick sow "
                "masking is wired for the GPTLM pipeline only)"
            )
        if not cfg.prenorm or cfg.embed_norm:
            raise NotImplementedError(
                "post-norm / embed-norm variants in the seq2seq stacks "
                "(BERT-interop knobs; the seq2seq family is pre-norm)"
            )
        dev = resolve_device(device)
        self.config = cfg
        self.mesh = mesh
        table = max(cfg.seq_len, cfg.source_len)
        self.enc_config = dataclasses.replace(cfg, bidirectional=True, seq_len=cfg.source_len)
        self.dec_config = dataclasses.replace(cfg, bidirectional=False)
        self.embed = maybe_shard(Embedding(dataclasses.replace(cfg, seq_len=table), dev, mesh),
                                 cfg, mesh)
        self.pipe = None
        enc_ids = dec_ids = None
        if cfg.pipe_size > 1:
            if cfg.positional == "relative":
                raise NotImplementedError("relative position bias under pipeline parallelism")
            if cfg.pipe_interleave > 1:
                raise NotImplementedError("the interleaved schedule for encoder-decoder models")
            for n, what in ((cfg.encoder_layers, "enc_layers"), (cfg.n_layers, "n_layers")):
                if n % cfg.pipe_size != 0:
                    raise ValueError(f"{what}={n} not divisible by pipe_size={cfg.pipe_size}")
            self.pipe = pp.pipe_axis(mesh, cfg.pipe_axis)
            if self.pipe is not None:
                if self.pipe[1] != cfg.pipe_size:
                    raise ValueError(f"pipe_size={cfg.pipe_size}, the mesh's {cfg.pipe_axis!r} "
                                     f"axis has {self.pipe[1]}")
                enc_ids = stage_layers(
                    dataclasses.replace(cfg, n_layers=cfg.encoder_layers), self.pipe[2])
                dec_ids = stage_layers(cfg, self.pipe[2])
        self.encoder = BlockStack(self.enc_config, cfg.encoder_layers, dev, mesh,
                                  layer_ids=enc_ids)
        self.decoder = DecoderStack(self.dec_config, cfg.n_layers, dev, mesh, layer_ids=dec_ids)
        if self.pipe is not None:
            pp.mark_stage(self.encoder, mesh, cfg.pipe_axis)
            pp.mark_stage(self.decoder, mesh, cfg.pipe_axis)
        self.enc_norm = make_norm(cfg, dev)
        self.dec_norm = make_norm(cfg, dev)
        self.lm_head = maybe_shard(
            TPDense(cfg.d_model, cfg.vocab_size, style="column", axis_name=cfg.model_axis,
                    use_bias=False, gather_output=True, dtype=cfg.dtype, device=dev, mesh=mesh),
            cfg, mesh)
        self.enc_rel_bias = self.dec_rel_bias = None
        if cfg.positional == "relative":
            # T5: one bucketed table per stack; cross-attention has none
            if cfg.attn_impl != "xla":
                raise NotImplementedError("relative position bias needs attn_impl='xla'")
            self.enc_rel_bias = RelativePositionBias(self.enc_config, True, dev)
            self.dec_rel_bias = RelativePositionBias(self.dec_config, False, dev)
        bound = model_axis(mesh, cfg.model_axis)
        self.local_kv_heads = (cfg.n_kv_heads or cfg.n_heads) // (1 if bound is None else bound[1])
        if seed is not None:
            init_params(self, seed)

    @property
    def is_last_stage(self) -> bool:
        """True off a pipeline and on its last rank: where outputs are real."""
        return self.pipe is None or self.pipe[2] == self.pipe[1] - 1

    @property
    def device(self) -> torch.device:
        return self.embed.tok.weight.device

    def init_cache(self, batch: int) -> Seq2SeqCache:
        """An empty decode state for ``batch`` rows: a self-attention
        :class:`KVCache` of ``seq_len`` slots and an empty
        :class:`CrossKVCache` per decoder layer (this rank's kv heads), the
        position counter at 0."""
        if self.config.kv_block_tokens:
            raise NotImplementedError("the paged KV cache for encoder-decoder decoding")
        caches = [KVCache.empty(self.dec_config, batch, self.device, self.local_kv_heads)
                  for _ in range(self.decoder.n_layers)]
        return Seq2SeqCache(caches, [CrossKVCache() for _ in caches])

    def _dropout_rng(self, train: bool, rng):
        if train and self.config.dropout_rate > 0.0:
            if rng is None:
                raise ValueError("train=True with dropout_rate > 0 needs an rng (a CPU "
                                 "torch.Generator)")
            return rng
        return None

    def _need_pipe(self) -> None:
        if self.pipe is None:
            raise ValueError(f"pipe_size={self.config.pipe_size} needs the "
                             f"{self.config.pipe_axis!r} mesh axis bound: build the model on "
                             "the training mesh")

    def encode(self, src, src_mask=None, train: bool = False,
               rng: Optional[torch.Generator] = None,
               moe_losses: Optional[list] = None) -> torch.Tensor:
        """Source tokens -> memory [B, S_src, d_model].  Padding leaves the
        encoder's attention as its own segment (real tokens segment 1, pads
        0: JAX's ids), and every cross-attention through the mask the
        caller threads to :meth:`decode`."""
        cfg = self.config
        if src.shape[1] > cfg.source_len:
            raise ValueError(f"{src.shape[1]} source tokens exceed source_len {cfg.source_len}")
        x = self.embed(src)  # under SP the embedding offsets its positions itself
        segment_ids = None if src_mask is None else src_mask.to(torch.int32)
        attn_bias = None
        if self.enc_rel_bias is not None:
            pos = torch.arange(src.shape[1], device=src.device)
            attn_bias = self.enc_rel_bias(pos, pos)
        dropout_rng = self._dropout_rng(train, rng)
        if cfg.pipe_size > 1:
            self._need_pipe()
            extras = {"segment_ids": segment_ids} if segment_ids is not None else None
            x = pp.execute_pipeline(self.encoder, x, num_microbatches=cfg.num_microbatches,
                                    mesh=self.mesh, axis_name=cfg.pipe_axis,
                                    broadcast_outputs=True, extras=extras,
                                    dropout_rng=dropout_rng)
        else:
            x = self.encoder(x, None, segment_ids, dropout_rng=dropout_rng,
                             moe_losses=moe_losses, attn_bias=attn_bias)
        return self.enc_norm(x).to(cfg.dtype)

    def decode(self, dst, memory, src_mask=None, positions=None, train: bool = False,
               rng: Optional[torch.Generator] = None, decode: bool = False,
               cache: Optional[Seq2SeqCache] = None, hidden_only: bool = False,
               moe_losses: Optional[list] = None) -> torch.Tensor:
        """Decoder tokens (and ``memory`` from :meth:`encode`; None in decode
        steps after the prefill) -> logits, or the final hidden states with
        ``hidden_only``.  ``decode=True`` appends to ``cache``
        (:meth:`init_cache`), its positions by default the cache's counter
        plus ``arange(T)``."""
        cfg = self.config
        if decode and seq_parallel_active(cfg, self.mesh):
            raise NotImplementedError(
                "incremental decoding under sequence parallelism "
                "(serve seq2seq on a data/model mesh)"
            )
        if decode and cfg.pipe_size > 1:
            raise NotImplementedError(
                "incremental decoding for pipelined encoder-decoder "
                "models (the cross-attention caches would need their "
                "own ring plumbing)"
            )
        t = dst.shape[1]
        if decode:
            if cache is None:
                raise ValueError("decode=True needs a cache (EncoderDecoder.init_cache)")
            if positions is None:
                positions = (cache.index + torch.arange(t, device=dst.device)).expand(
                    dst.shape[0], t)
            cache.index += t
        elif t > cfg.seq_len:
            raise ValueError(f"{t} tokens exceed seq_len {cfg.seq_len}")
        if memory is not None and seq_parallel_active(cfg, self.mesh):
            # the memory arrives seq-sharded; every cross-attention needs
            # the whole source: one gather here, outside the checkpointed
            # stack (its backward sums the cotangents over the axis and
            # keeps this rank's block, as lax.all_gather's)
            memory = tp.all_gather(memory.transpose(1, 2), cfg.seq_axis,
                                   self.mesh).transpose(1, 2)
            if src_mask is not None:
                src_mask = gather_sequence(src_mask.to(torch.int32), cfg.seq_axis,
                                           self.mesh).bool()
        x = self.embed(dst, positions)
        attn_bias = None
        if self.dec_rel_bias is not None:
            attn_bias = self.dec_rel_bias.for_step(positions, t, cfg.seq_len, decode)
        dropout_rng = self._dropout_rng(train, rng)
        if cfg.pipe_size > 1:
            self._need_pipe()
            # memory and mask are inputs every rank holds (the encoder's
            # pipeline broadcast its output): per-microbatch extras
            extras = {"memory": memory}
            if src_mask is not None:
                extras["memory_mask"] = src_mask
            if positions is not None:
                extras["positions"] = positions
            x = pp.execute_pipeline(self.decoder, x, num_microbatches=cfg.num_microbatches,
                                    mesh=self.mesh, axis_name=cfg.pipe_axis, extras=extras,
                                    dropout_rng=dropout_rng)
            if not self.is_last_stage:
                return x if hidden_only else x.new_zeros(*x.shape[:-1], cfg.vocab_size)
        else:
            x = self.decoder(x, memory, src_mask, positions, decode, cache, dropout_rng,
                             moe_losses, attn_bias)
        x = self.dec_norm(x).to(cfg.dtype)
        if hidden_only:
            return x
        return self.lm_head(x)

    def forward(self, src, dst, src_mask=None, train: bool = False,
                rng: Optional[torch.Generator] = None, decode: bool = False,
                cache: Optional[Seq2SeqCache] = None, hidden_only: bool = False,
                moe_losses: Optional[list] = None) -> torch.Tensor:
        """:meth:`encode` then :meth:`decode`.  ``train=True`` runs dropout
        (``dropout_rate`` > 0) from ``rng``; ``moe_losses`` receives every
        encoder and decoder block's balance value."""
        memory = self.encode(src, src_mask, train=train, rng=rng, moe_losses=moe_losses)
        return self.decode(dst, memory, src_mask, train=train, rng=rng, decode=decode,
                           cache=cache, hidden_only=hidden_only, moe_losses=moe_losses)


def make_seq2seq_loss(config: Seq2SeqConfig, train: bool = True, mesh=None):
    """Teacher-forced CE over decoder positions in the
    ``accumulate_gradients`` loss shape, JAX's ``make_seq2seq_loss``: the
    model's hidden states, the lm_head and the CE of
    :func:`~tpu_parallel_torch.models.gpt.make_ce_fn` (vocab-parallel on a
    model axis, chunked under ``loss_chunk``, the FSDP lm_head gathered
    once).  Dropout folds ``rng`` over the data, model, pipe and seq axes.
    Under MoE the balance term divides the blocks' summed values by
    ``encoder_layers + n_layers``; under a pipe axis the loss and its counts
    are the last rank's (elsewhere a zero joined to the schedule)."""
    ce_fn = make_ce_fn(config, mesh)
    fold_axes = (config.data_axis, config.model_axis, config.pipe_axis, config.seq_axis)
    moe = config.moe_experts > 0
    denom = config.encoder_layers + config.n_layers

    def loss_fn(model, batch: Seq2SeqBatch, rng=None):
        if train and config.dropout_rate > 0.0 and rng is not None:
            rng = fold_rng_over_axis(rng, fold_axes, mesh)
        sown = [] if moe else None
        hidden = model(batch.src_tokens, batch.tokens, src_mask=batch.src_mask, train=train,
                       rng=rng, hidden_only=True, moe_losses=sown)
        aux = None
        if moe:
            aux = sum(v.sum() for v in sown) / denom if sown else \
                torch.zeros((), device=hidden.device)
        if not model.is_last_stage:
            zero = hidden.sum() * 0.0
            none = torch.zeros((), device=hidden.device)
            return zero, {"loss": (zero.detach(), none), "accuracy": (none, none)}
        mask = (batch.loss_mask if batch.loss_mask is not None
                else torch.ones(batch.targets.shape, device=hidden.device))
        n_tok = mask.sum()
        loss_sum, correct = ce_fn(_lm_head_params(config, model), hidden, batch.targets, mask)
        metrics = {"loss": (loss_sum, n_tok), "accuracy": (correct.float(), n_tok)}
        total = loss_sum / n_tok.clamp(min=1.0)
        if moe:
            metrics["moe_balance"] = (aux.detach() * n_tok, n_tok)
            total = total + config.moe_balance_weight * aux
        return total, metrics

    return loss_fn


def _length_guards(cfg: Seq2SeqConfig, src, max_new_tokens: int) -> None:
    """JAX's guards: no silent clamping of positions or cache writes."""
    if max_new_tokens > cfg.seq_len:
        raise ValueError(
            f"max_new_tokens ({max_new_tokens}) exceeds decoder seq_len "
            f"({cfg.seq_len})"
        )
    if src.shape[1] > cfg.source_len:
        raise ValueError(
            f"source length ({src.shape[1]}) exceeds the encoder's "
            f"source_len ({cfg.source_len})"
        )


def _seq2seq_core(model: EncoderDecoder, src, src_mask, generator, *, bos_id: int,
                  max_new_tokens: int, temperature: float, top_k: int,
                  top_p: float = 0.0) -> torch.Tensor:
    """Encode once, prefill BOS through the decoder (writing the self and
    the cross caches), then single-token steps.  On the model's
    tensor-parallel axis the logits stay vocab-sharded and
    :func:`~tpu_parallel_torch.models.generate._sample_sharded` picks the
    token (every model rank the same)."""
    cfg = model.config
    _length_guards(cfg, src, max_new_tokens)
    b = src.shape[0]
    mesh = model.mesh
    if model_axis(mesh, cfg.model_axis) is not None:
        def next_token(hidden):
            logits = F.linear(hidden[:, -1], model.lm_head.weight)
            return _sample_sharded(logits, generator, temperature, top_k, top_p,
                                   cfg.model_axis, mesh)
    else:
        def next_token(hidden):
            return _sample(model.lm_head(hidden[:, -1]), generator, temperature, top_k, top_p)

    memory = model.encode(src, src_mask)
    cache = model.init_cache(b)
    bos = torch.full((b, 1), bos_id, dtype=torch.long, device=src.device)
    hidden = model.decode(bos, memory, src_mask, decode=True, cache=cache, hidden_only=True)
    tok = next_token(hidden)
    out = [tok]
    for _ in range(max_new_tokens - 1):
        hidden = model.decode(tok[:, None], None, decode=True, cache=cache, hidden_only=True)
        tok = next_token(hidden)
        out.append(tok)
    return torch.stack(out, dim=1)


@torch.inference_mode()
def seq2seq_generate(model: EncoderDecoder, src, src_mask=None,
                     generator: Optional[torch.Generator] = None, *, bos_id: int = 0,
                     max_new_tokens: int = 32, temperature: float = 0.0, top_k: int = 0,
                     top_p: float = 0.0) -> torch.Tensor:
    """Encode once, then KV-cached autoregressive decoding: [B,
    max_new_tokens] (greedy at ``temperature == 0``; the sampling filters
    are the LM's).  ``src`` (and ``src_mask``) on the model's device;
    ``generator`` too, default one seeded with 0.  Mesh-sharded weights
    serve through :func:`seq2seq_generate_sharded` (or
    ``export_single_device_params`` for data and FSDP meshes)."""
    if src.device != model.device:
        raise ValueError(f"src is on {src.device}, the model on {model.device}")
    if generator is None:
        generator = torch.Generator(device=model.device).manual_seed(0)
    return _seq2seq_core(model, src, src_mask, generator, bos_id=bos_id,
                         max_new_tokens=max_new_tokens, temperature=temperature, top_k=top_k,
                         top_p=top_p)


@torch.inference_mode()
def seq2seq_generate_sharded(model: EncoderDecoder, src, mesh=None, src_mask=None,
                             rng: Optional[torch.Generator] = None, *, bos_id: int = 0,
                             max_new_tokens: int = 32, temperature: float = 0.0,
                             top_k: int = 0, top_p: float = 0.0) -> torch.Tensor:
    """Serve a mesh-trained seq2seq model under its own mesh, as
    ``generate_sharded``: tensor-parallel weights stay split (the self and
    cross caches hold each rank's heads), each data rank decodes its block
    of the GLOBAL ``src`` rows, and the tokens are all-gathered over the
    data axis (every rank returns [B, max_new_tokens]).  ``rng`` (a CPU
    generator, default seeded 0) folds over the data axis only.  A
    collective: every rank of the mesh calls it."""
    mesh = model.mesh if mesh is None else mesh
    if mesh is not model.mesh:
        raise ValueError("seq2seq_generate_sharded needs the mesh the model was built on")
    if src.device != model.device:
        raise ValueError(f"src is on {src.device}, the model on {model.device}")
    if rng is None:
        rng = torch.Generator().manual_seed(0)
    data = axis_group(mesh, model.config.data_axis)
    size, index = (1, 0) if data is None else data[1:]
    b = src.shape[0]
    if b % size:
        raise ValueError(f"batch {b} not divisible by data axis {size}")
    n = b // size
    rows = slice(index * n, (index + 1) * n)
    rng = fold_rng_over_axis(rng, (model.config.data_axis,), mesh)
    seed = int(torch.randint(0, 2**62, (1,), generator=rng))
    generator = torch.Generator(device=model.device).manual_seed(seed)
    out = _seq2seq_core(model, src[rows], None if src_mask is None else src_mask[rows],
                        generator, bos_id=bos_id, max_new_tokens=max_new_tokens,
                        temperature=temperature, top_k=top_k, top_p=top_p)
    if size == 1:
        return out
    full = out.new_empty(b, max_new_tokens)
    dist.all_gather_into_tensor(full, out.contiguous(), group=data[0])
    return full


def beam_expand_seq2seq_cache(cache: Seq2SeqCache, k: int) -> Seq2SeqCache:
    """Every row replicated ``k`` ways (beam j of row i = row i*k+j), the
    self caches and, once, the beam-invariant cross caches."""
    rows = torch.arange(cache.cross[0].mask.shape[0],
                        device=cache.cross[0].mask.device).repeat_interleave(k)
    return Seq2SeqCache(beam_expand_cache(cache.self_attn, k),
                        [c.take_rows(rows) for c in cache.cross], cache.index)


@torch.inference_mode()
def seq2seq_generate_beam(model: EncoderDecoder, src, src_mask=None, *, bos_id: int = 0,
                          max_new_tokens: int = 32, num_beams: int = 4,
                          length_penalty: float = 0.0, lazy: bool = True):
    """Beam search for the encoder-decoder family: ``(tokens [B,
    max_new_tokens], scores [B])``, the best continuation per source row,
    scored by total log-probability / ``max_new_tokens ** length_penalty``.
    Encode and prefill once per source row, replicate the caches
    ``num_beams`` ways, then per step keep the top beams of the joint
    continuations (``generate_beam``'s mechanics and tie order).
    ``lazy=True`` follows the self caches' ancestry through ``beam_src``
    tables (no cache is ever gathered); ``lazy=False`` reorders the self
    caches every step.  The cross caches are beam-invariant: neither form
    touches them after the expansion."""
    cfg = model.config
    if src.device != model.device:
        raise ValueError(f"src is on {src.device}, the model on {model.device}")
    _length_guards(cfg, src, max_new_tokens)
    b = src.shape[0]
    k = num_beams
    vocab = cfg.vocab_size
    dev = src.device

    def logp_of(hidden):
        return torch.log_softmax(model.lm_head(hidden[:, -1]).float(), dim=-1)

    memory = model.encode(src, src_mask)
    cache = model.init_cache(b)
    bos = torch.full((b, 1), bos_id, dtype=torch.long, device=dev)
    hidden = model.decode(bos, memory, src_mask, decode=True, cache=cache, hidden_only=True)
    scores, first = _top_k(logp_of(hidden), k)  # [b, k] each
    cache = beam_expand_seq2seq_cache(cache, k)
    if lazy:
        beam_seed_src(cache.self_attn, k)
    tok = first.reshape(b * k)
    offsets = torch.arange(b, device=dev)[:, None] * k
    toks, srcs = [], []
    for _ in range(max_new_tokens - 1):
        hidden = model.decode(tok[:, None], None, decode=True, cache=cache, hidden_only=True)
        joint = scores[:, :, None] + logp_of(hidden).view(b, k, vocab)
        scores, flat = _top_k(joint.view(b, k * vocab), k)
        src_beam = flat // vocab
        next_tok = flat % vocab
        row_idx = (src_beam + offsets).reshape(b * k)
        if lazy:
            cache.self_attn = beam_advance_src(cache.self_attn, row_idx)
        else:
            cache.self_attn = beam_reorder_cache(cache.self_attn, row_idx)
        tok = next_tok.reshape(b * k)
        toks.append(next_tok)
        srcs.append(src_beam)
    if toks:
        toks, srcs = torch.stack(toks), torch.stack(srcs)
    else:
        toks = srcs = first.new_zeros((0, b, k))
    out = beam_backtrack(first, toks, srcs, scores)
    best = scores.max(dim=-1).values
    if length_penalty:
        best = best / torch.tensor(float(max_new_tokens), device=dev) ** length_penalty
    return out, best


def t5_small(**overrides) -> Seq2SeqConfig:
    """T5-small-shaped encoder-decoder (~60M parameters, vocab padded to a
    multiple of 128)."""
    return Seq2SeqConfig(**{
        **dict(vocab_size=32128, d_model=512, n_layers=6, enc_layers=6, n_heads=8, seq_len=512,
               mlp_ratio=4, norm="rmsnorm", mlp="gelu"),
        **overrides,
    })


def t5_small_hf(**overrides) -> Seq2SeqConfig:
    """T5-small in its checkpoint-faithful form, for
    :func:`~tpu_parallel_torch.models.hf.from_hf_t5`: relative position
    bias (32 buckets, max distance 128, one table per stack), RMSNorm at eps
    1e-6 (T5LayerNorm), bias-free projections, the ReLU MLP (``mlp="geglu"``
    for v1.1 checkpoints), unscaled attention folded into the imported q
    weights, the xla attention path (the bias refuses the flash kernels)."""
    return Seq2SeqConfig(**{
        **dict(vocab_size=32128, d_model=512, n_layers=6, enc_layers=6, n_heads=8, seq_len=512,
               mlp_ratio=4, positional="relative", norm="rmsnorm", norm_eps=1e-6, mlp="relu",
               dense_bias=False, attn_impl="xla", scan_layers=False),
        **overrides,
    })


def tiny_seq2seq(**overrides) -> Seq2SeqConfig:
    """Toy config for CPU tests: real structure, toy sizes, fp32."""
    return Seq2SeqConfig(**{
        **dict(vocab_size=256, d_model=32, n_layers=2, enc_layers=2, n_heads=4, seq_len=32,
               src_seq_len=32, dtype=torch.float32, num_microbatches=2),
        **overrides,
    })
