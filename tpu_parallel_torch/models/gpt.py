"""Transformer LM (decoder, or with ``bidirectional`` the encoder): the
port of ``tpu_parallel/models/gpt.py``.

``GPTLM`` holds its weights (made from a seed, or loaded
from a JAX parameter tree through ``models/convert.py``) and keeps the
JAX call's keywords: ``positions``, ``segment_ids``, ``train`` (dropout,
drawn from ``rng``), ``decode`` (with a per-layer list of :class:`KVCache`,
updated in place) and ``hidden_only``.  :func:`make_gpt_loss` is the
training loss, with the lm_head applied in it, ``loss_chunk`` positions at
a time when that is set.  Under ``config.fsdp`` and a mesh, the blocks,
the embedding and the lm_head are FSDP-sharded over the data axis
(``parallel/fsdp.py``); the loss gathers the lm_head once for all its
chunks.  On a mesh whose model axis is above 1 the blocks are
tensor-parallel and the lm_head is column-parallel over the vocabulary
(``parallel/tp.py``): ``GPTLM.forward`` gathers the logits, the loss
does not (``core/losses.py:vocab_parallel_cross_entropy``).

On a mesh whose pipe axis is above 1 (``config.pipe_size``, dictated by
the mesh) each rank builds only its stage: rank ``r``'s virtual stage
``j`` holds layers ``[(j n + r) L_c, (j n + r + 1) L_c)`` under their
one-device names (``blocks.layer_{i}``), tagged stage-owned
(``parallel/pp.py``).  The embedding, ``norm_final`` and the lm_head are
held by every rank (replicated over ``pipe``, their gradients summed over
it), but only rank 0 embeds and only the last rank applies the norm, the
lm_head and the loss: their gradients are exactly zero elsewhere, as
JAX's masks make them.  The forward runs the GPipe or the interleaved
schedule (``pp.execute_interleaved_pipeline``), a decode step the ring
(``pp.execute_pipeline_decode``), and :func:`make_gpt_1f1b_grad_fn` the
1F1B schedule.

``positional="relative"`` gives the model one T5 bias table (``rel_bias``)
above the stack, on the xla path.  The encoder-decoder family lives in
``models/seq2seq.py``.

The encoder family: :class:`EncoderClassifier` (the trunk's hidden states
pooled and classified), :func:`make_mlm_loss` (the masked-LM objective,
its corruption drawn by :func:`mlm_mask`), ``bert_base`` and
``bert_base_hf`` (post-norm, the embedding LayerNorm: the layout
``models/hf.py`` imports BERT checkpoints into).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from tpu_parallel_torch.core.losses import token_cross_entropy, vocab_parallel_cross_entropy
from tpu_parallel_torch.core.rng import fold_rng_over_axis, fold_seed
from tpu_parallel_torch.core.state import TextBatch
from tpu_parallel_torch.models.convert import init_params
from tpu_parallel_torch.models.layers import (
    BlockStack,
    Embedding,
    KVCache,
    PagedKVCache,
    RelativePositionBias,
    TransformerConfig,
    dropout,
    make_norm,
)
from tpu_parallel_torch.parallel import pp
from tpu_parallel_torch.parallel.fsdp import gather_module_params, maybe_shard
from tpu_parallel_torch.parallel.tp import TPDense, model_axis
from tpu_parallel_torch.runtime import resolve_device


@dataclasses.dataclass(frozen=True)
class GPTConfig(TransformerConfig):
    """TransformerConfig plus the JAX package's pipeline knobs and
    ``loss_chunk``.  ``pipe_size``: the number of pipeline stages (the
    mesh's pipe axis); ``pipe_interleave`` > 1: that many virtual stages per
    rank (the circular schedule); ``pipe_schedule``: ``"gpipe"`` (gradients
    through the forward schedule) or ``"1f1b"`` (:func:`make_gpt_1f1b_grad_fn`,
    checked by the Trainer).  ``loss_chunk`` > 0 runs the lm_head and
    cross-entropy ``loss_chunk`` sequence positions at a time, each chunk
    checkpointed, so the logits exist only as [batch, loss_chunk, vocab]."""

    pipe_size: int = 1
    pipe_interleave: int = 1
    pipe_schedule: str = "gpipe"
    loss_chunk: int = 0

    def __post_init__(self):
        super().__post_init__()
        if self.loss_chunk < 0:
            raise ValueError(f"loss_chunk={self.loss_chunk} < 0")


def _pipe_refusals(cfg: GPTConfig) -> None:
    """JAX's build-time pipeline errors, in its words."""
    if cfg.pipe_interleave > 1 and cfg.pipe_size <= 1:
        raise ValueError(
            "pipe_interleave > 1 requires pipe_size > 1 (a pipe mesh "
            "axis); on a pipe=1 mesh the knob would be silently ignored"
        )
    if cfg.pipe_size > 1:
        chunks = cfg.pipe_size * cfg.pipe_interleave
        if cfg.n_layers % chunks != 0:
            raise ValueError(
                f"n_layers={cfg.n_layers} not divisible by pipe_size*"
                f"pipe_interleave={chunks}"
            )
        if cfg.pipe_interleave > 1 and cfg.moe_experts > 0:
            raise NotImplementedError(
                "MoE under the interleaved pipeline schedule (chunk "
                "branches would sow mismatched loss collections)"
            )


def _relative_refusals(cfg: GPTConfig) -> None:
    """JAX's build-time errors of the relative bias on ``GPTLM``, in its
    words: one table above the stack, so no pipeline, and the xla path."""
    if cfg.positional != "relative":
        return
    if cfg.pipe_size > 1:
        raise NotImplementedError("relative position bias under pipeline parallelism")
    if cfg.attn_impl != "xla":
        raise NotImplementedError(
            "relative position bias needs attn_impl='xla' (the "
            "flash/ring/ulysses kernels take no additive score bias)"
        )


def stage_layers(cfg: GPTConfig, stage: int) -> List[int]:
    """The global layer indices pipe rank ``stage`` owns, chunk by chunk:
    virtual stage ``j`` is global chunk ``j * pipe_size + stage``."""
    n, v = cfg.pipe_size, cfg.pipe_interleave
    per = cfg.n_layers // (n * v)
    return [c * per + k for c in (j * n + stage for j in range(v)) for k in range(per)]


class GPTLM(nn.Module):
    """tokens [B, S] -> logits [B, S, vocab] in ``config.dtype``.

    ``device`` defaults to ``"cuda"`` and raises without a GPU; the weights
    are drawn from ``seed`` with a CPU ``torch.Generator`` (the same weights
    on every device, and every rank's slice of the same full weights);
    ``seed=None`` leaves the modules' own initial values, for a caller that
    loads or draws the weights itself (the ``Trainer``'s ``init``: the
    host's draws are most of a large model's build).
    The lm_head is untied from the token embedding.  ``mesh``
    (``runtime.make_mesh``) binds the data axis that ``config.fsdp``
    shards over and the model axis that tensor parallelism splits: there
    the lm_head is column-parallel over the vocabulary and the forward
    all-gathers its logits.  ``head=False`` builds no lm_head (the trunk of
    :class:`EncoderClassifier`, whose JAX tree has none): only
    ``hidden_only`` calls.  A post-norm config (``prenorm=False``) has no
    ``norm_final``.  Without a mesh an FSDP config holds full
    weights, as JAX's wrap is the identity on an unbound axis.  FSDP
    together with a model axis above 1 (``llama_1b_3d``'s mesh) splits
    each tensor-parallel slice again over the data axis, by JAX's rule on
    the slice's shape (``fsdp.shard_dim``; a nested ``ShardInfo``).
    Under ``positional="relative"`` one :class:`RelativePositionBias`,
    ``rel_bias``, above the stack gives every layer the same T5 score bias
    (JAX's refusals: no pipeline, the xla path only, no packed
    ``segment_ids``, no slot-indexed ``write_index``).
    """

    def __init__(self, config: GPTConfig, *, device="cuda", seed: Optional[int] = 0, mesh=None,
                 head: bool = True):
        super().__init__()
        bound = model_axis(mesh, config.model_axis)
        _pipe_refusals(config)
        _relative_refusals(config)
        pipe = pp.pipe_axis(mesh, config.pipe_axis)
        if pipe is not None and pipe[1] != config.pipe_size:
            raise ValueError(f"pipe_size={config.pipe_size}, the mesh's {config.pipe_axis!r} "
                             f"axis has {pipe[1]}")
        dev = resolve_device(device)
        self.config = config
        self.mesh = mesh
        self.pipe = pipe
        self.embed = maybe_shard(Embedding(config, dev, mesh), config, mesh)
        self.rel_bias = None
        if config.positional == "relative":
            self.rel_bias = RelativePositionBias(config, config.bidirectional, dev)
        if pipe is None:
            self.blocks = BlockStack(config, config.n_layers, dev, mesh)
        else:
            self.blocks = pp.mark_stage(BlockStack(
                config, config.n_layers, dev, mesh, layer_ids=stage_layers(config, pipe[2]),
                chunks=config.pipe_interleave), mesh, config.pipe_axis)
        # post-norm stacks (BERT) end normalized by their last block's
        # norm_mlp: no final norm, as JAX's tree has none
        self.norm_final = make_norm(config, dev) if config.prenorm else None
        self.lm_head = None
        if head:
            self.lm_head = maybe_shard(
                TPDense(config.d_model, config.vocab_size, style="column",
                        axis_name=config.model_axis, use_bias=False, gather_output=True,
                        dtype=config.dtype, device=dev, mesh=mesh),
                config, mesh)
        # the kv heads this rank's caches hold
        self.local_kv_heads = (config.n_kv_heads or config.n_heads) // (
            1 if bound is None else bound[1])
        if seed is not None:
            init_params(self, seed)

    @property
    def is_last_stage(self) -> bool:
        """True off a pipeline and on its last rank: where outputs are real."""
        return self.pipe is None or self.pipe[2] == self.pipe[1] - 1

    @property
    def device(self) -> torch.device:
        return self.embed.tok.weight.device

    def init_cache(self, batch: int, beam_width: Optional[int] = None) -> List[KVCache]:
        """An empty decode cache, one :class:`KVCache` of ``seq_len`` slots
        per layer of this rank, for ``batch`` rows (this rank's kv heads);
        under ``kv_block_tokens`` > 0 one :class:`PagedKVCache` pool per
        layer instead (row-count free, as
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
            return [PagedKVCache.empty(cfg, self.device, self.local_kv_heads)
                    for _ in range(self.blocks.n_layers)]
        caches = [KVCache.empty(cfg, batch, self.device, self.local_kv_heads)
                  for _ in range(self.blocks.n_layers)]
        if beam_width > 1:
            for c in caches:
                c.seed_beam_src(beam_width)
        return caches

    def forward(self, tokens, positions=None, segment_ids=None, decode: bool = False,
                hidden_only: bool = False, cache: Optional[List[KVCache]] = None,
                write_index=None, block_table=None, train: bool = False,
                rng: Optional[torch.Generator] = None,
                moe_losses: Optional[list] = None) -> torch.Tensor:
        """``train=True`` runs dropout when ``dropout_rate`` > 0, with one
        seed per layer drawn from ``rng`` (a CPU generator).  ``decode=True`` appends to ``cache`` (from :meth:`init_cache`) and
        attends the cached prefix; without ``positions`` it continues from
        the cache's write index.  ``write_index`` [batch] (the serving
        engine's slot-indexed writes) puts row r's tokens at cache columns
        ``write_index[r] + [0..T)``, dropping targets outside the cache.
        ``block_table`` [batch, seq_len // block_tokens] addresses a
        :class:`PagedKVCache` pool (-1 = unmapped: reads masked out, writes
        dropped); it needs ``write_index``.  ``moe_losses`` (a list; JAX's
        mutable ``"losses"`` collection) receives the MoE blocks'
        load-balance values: one per layer, or under a pipeline one
        per-tick table of this rank's stage (bubble ticks exactly 0)."""
        cfg = self.config
        if block_table is not None and not decode:
            raise ValueError("block_table needs decode=True")
        if write_index is not None and not decode:
            raise ValueError("write_index needs decode=True")
        if write_index is not None and cfg.positional == "relative":
            # the shared bias table is computed from row 0's positions; a
            # slot pool's rows sit at different depths
            raise NotImplementedError(
                "slot-indexed cache writes with relative position bias "
                "(the shared bias table assumes row-uniform positions; "
                "slot-pool rows sit at different depths)"
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
        dropout_rng = None
        if train and cfg.dropout_rate > 0.0:
            if rng is None:
                raise ValueError("train=True with dropout_rate > 0 needs an rng (a CPU "
                                 "torch.Generator)")
            dropout_rng = rng
        if cfg.pipe_size > 1:
            x = self._pipeline(tokens, positions, segment_ids, decode, cache, write_index,
                               block_table, dropout_rng, moe_losses)
            if not self.is_last_stage and not decode:
                # outputs are real on the last rank only: skip the norm and
                # the lm_head here (JAX masks what they would give)
                if hidden_only:
                    return x
                return x.new_zeros(*x.shape[:-1], cfg.vocab_size)
        else:
            x = self.embed(tokens, positions)
            attn_bias = None
            if self.rel_bias is not None:
                # one bucketed score bias for every layer, computed above
                # the stack
                if segment_ids is not None:
                    raise NotImplementedError("relative position bias with packed sequences")
                attn_bias = self.rel_bias.for_step(positions, tokens.shape[1], cfg.seq_len,
                                                   decode)
            x = self.blocks(x, positions, segment_ids, decode, cache if decode else None,
                            write_index, block_table, dropout_rng, moe_losses=moe_losses,
                            attn_bias=attn_bias)
        if self.norm_final is not None:
            x = self.norm_final(x).to(cfg.dtype)
        if hidden_only:
            return x
        if self.lm_head is None:
            raise ValueError("a GPTLM built with head=False gives hidden states only "
                             "(hidden_only=True)")
        return self.lm_head(x)

    def _pipeline(self, tokens, positions, segment_ids, decode, cache, write_index,
                  block_table, dropout_rng, moe_losses=None) -> torch.Tensor:
        """The block stack over the pipe axis: rank 0 embeds, the schedule
        runs the stages, and the result is real on the last rank (every
        rank when decoding)."""
        cfg = self.config
        if write_index is not None or block_table is not None:
            raise NotImplementedError(
                "slot-indexed cache writes under pipeline parallelism "
                "(the decode ring's per-stage caches would need the "
                "write-slot table as a ring extra — serve pipe meshes "
                "through generate_sharded, not the serving engine)"
            )
        if decode and segment_ids is not None:
            raise NotImplementedError(
                "incremental decoding with packed sequences (segment_ids)"
            )
        if self.pipe is None:
            if decode:
                raise ValueError(
                    f"pipe_size={cfg.pipe_size} decoding needs the "
                    f"{cfg.pipe_axis!r} mesh axis bound: serve through "
                    "generate_sharded under the training mesh (plain "
                    "generate()/generate_beam() run without a mesh)"
                )
            raise ValueError(f"pipe_size={cfg.pipe_size} needs the {cfg.pipe_axis!r} mesh axis "
                             "bound: build the model on the training mesh")
        shape = (*tokens.shape, cfg.d_model)
        if self.pipe[2] == 0:
            x = self.embed(tokens, positions)
        else:
            # only rank 0 embeds; the schedule reads no input elsewhere
            x = torch.empty(shape, dtype=cfg.dtype, device=tokens.device)
        if decode:
            if cfg.pipe_interleave > 1:
                raise NotImplementedError(
                    "incremental decoding under the interleaved schedule "
                    "(nn.switch chunks cannot lazily create their KV-cache "
                    "variables branch-by-branch)"
                )
            return pp.execute_pipeline_decode(
                functools.partial(self.blocks, positions=positions, decode=True, caches=cache),
                x, mesh=self.mesh, axis_name=cfg.pipe_axis)
        extras = {}
        if positions is not None:
            extras["positions"] = positions
        if segment_ids is not None:
            extras["segment_ids"] = segment_ids
        chunks = [functools.partial(self.blocks, chunk=j) for j in range(cfg.pipe_interleave)]
        # MoE: bubble ticks contribute exactly 0 to the balance (pass_validity)
        moe = cfg.moe_experts > 0
        out = pp.execute_interleaved_pipeline(
            chunks, x, num_microbatches=cfg.num_microbatches, mesh=self.mesh,
            axis_name=cfg.pipe_axis, extras=extras, dropout_rng=dropout_rng, pass_validity=moe)
        if not moe:
            return out
        if moe_losses is not None:
            moe_losses.append(out[1])
        return out[0]


class EncoderClassifier(nn.Module):
    """Sequence classification over the bidirectional trunk, JAX's
    ``EncoderClassifier``: the encoder's hidden states (a :class:`GPTLM`
    named ``encoder``, built without an lm_head) pooled (``"first"``: the
    first token, CLS-style; ``"mean"``: the mean over the row's first
    segment when ``segment_ids`` are given, padding and packed neighbours
    left out, else over every position), a tanh ``pooler`` (a Linear in
    ``config.dtype``), dropout when training, and an fp32 ``classifier`` ->
    ``[batch, num_classes]`` fp32 logits.  The trunk composes with FSDP and
    tensor parallelism as the LM does (``mesh``); the pooler and the
    classifier are replicated, as in JAX's tree.  ``device`` and ``seed`` as
    :class:`GPTLM`'s (``convert.init_params``: flax's Dense defaults for
    the pooler and the classifier).  A causal config raises JAX's
    ``ValueError``: under a causal mask the pooled position cannot see the
    sequence."""

    def __init__(self, config: GPTConfig, num_classes: int, pool: str = "first", *,
                 device="cuda", seed: Optional[int] = 0, mesh=None):
        super().__init__()
        if not config.bidirectional:
            raise ValueError(
                "EncoderClassifier requires bidirectional=True — under a "
                "causal mask the pooled position cannot see the sequence"
            )
        if pool not in ("first", "mean"):
            raise ValueError(f"pool={pool!r} (first | mean)")
        dev = resolve_device(device)
        self.config = config
        self.num_classes = num_classes
        self.pool = pool
        self.encoder = GPTLM(config, device=dev, seed=None, mesh=mesh, head=False)
        self.pooler = nn.Linear(config.d_model, config.d_model, dtype=config.dtype, device=dev)
        self.classifier = nn.Linear(config.d_model, num_classes, dtype=torch.float32,
                                    device=dev)
        if seed is not None:
            init_params(self, seed)

    @property
    def device(self) -> torch.device:
        return self.classifier.weight.device

    def forward(self, tokens, positions=None, segment_ids=None, train: bool = False,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        """``train=True`` runs dropout (``dropout_rate`` > 0) in the trunk and
        on the pooled vector, seeded from ``rng`` (a CPU generator)."""
        cfg = self.config
        h = self.encoder(tokens, positions=positions, segment_ids=segment_ids,
                         hidden_only=True, train=train, rng=rng)
        if self.pool == "mean":
            if segment_ids is not None:
                # the row's first segment only: pads and packed neighbours
                # must not move the pooled vector
                w = (segment_ids == segment_ids[:, :1]).to(h.dtype)[..., None]
                pooled = (h * w).sum(dim=1) / w.sum(dim=1).clamp(min=1.0)
            else:
                pooled = h.mean(dim=1)
        else:
            pooled = h[:, 0]
        pooled = torch.tanh(self.pooler(pooled))
        if train and cfg.dropout_rate > 0.0:
            seed = int(torch.randint(0, 2**62, (1,), generator=rng))
            pooled = dropout(pooled, cfg.dropout_rate,
                             torch.Generator(device=pooled.device).manual_seed(seed))
        # fp32 class logits: a tiny tensor, and the CE's upcast costs nothing
        return self.classifier(pooled.float())


def mlm_mask(config: GPTConfig, tokens: torch.Tensor, rng: torch.Generator,
             mask_rate: float = 0.15, mesh=None) -> torch.Tensor:
    """The masked-LM corruption pattern of one batch: a bool tensor shaped
    like ``tokens``, each position True with probability ``mask_rate``,
    drawn on ``tokens``' device from one seed that ``rng`` (a CPU
    generator, advanced by one draw) gives, folded over the config's data
    and seq axes of ``mesh`` only (JAX's rule: model and pipe ranks hold the
    same tokens and must corrupt them alike; data and seq shards draw
    their own)."""
    seed = fold_seed(int(torch.randint(0, 2**63 - 1, (1,), generator=rng)), 17)
    gen = fold_rng_over_axis(torch.Generator().manual_seed(seed),
                             (config.data_axis, config.seq_axis), mesh)
    draw = int(torch.randint(0, 2**63 - 1, (1,), generator=gen))
    device_gen = torch.Generator(device=tokens.device).manual_seed(draw)
    return torch.rand(tokens.shape, generator=device_gen, device=tokens.device) < mask_rate


def make_mlm_loss(config: GPTConfig, mask_rate: float = 0.15,
                  mask_token_id: Optional[int] = None, train: bool = True, mesh=None):
    """Masked-LM objective for bidirectional (encoder) configs, JAX's
    ``make_mlm_loss``: ``loss_fn(model, batch, rng, masked=None)``.  Each
    call corrupts the positions of :func:`mlm_mask` (``mask_rate`` of the
    tokens) to ``mask_token_id`` (default the last vocabulary id, [MASK]
    by convention) and scores the model on recovering the originals at
    exactly those positions (times ``batch.loss_mask``), through
    :func:`make_gpt_loss`'s machinery (vocab-parallel on a model axis,
    chunked under ``loss_chunk``, the last pipe rank's).  ``masked`` (a bool
    tensor like ``batch.tokens``) replaces the draw: the loss on a given
    mask.  The training loss draws from ``rng`` (advancing it, so every
    minibatch and step corrupts anew); the evaluation variant
    (``train=False``) draws from a copy and leaves ``rng`` as it was.
    Dropout keeps its own fold over every axis inside the inner loss."""
    inner = make_gpt_loss(config, train=train, mesh=mesh)
    mask_id = mask_token_id if mask_token_id is not None else config.vocab_size - 1

    def loss_fn(model, batch, rng=None, masked=None):
        if masked is None:
            if rng is None:
                raise ValueError("the MLM loss draws its mask from rng (a CPU torch.Generator)")
            source = rng
            if not train:
                source = torch.Generator()
                source.set_state(rng.get_state())
            masked = mlm_mask(config, batch.tokens, source, mask_rate, mesh)
        loss_mask = masked.float()
        if batch.loss_mask is not None:
            loss_mask = loss_mask * batch.loss_mask
        mlm_batch = TextBatch(tokens=torch.where(masked, mask_id, batch.tokens),
                              targets=batch.tokens, loss_mask=loss_mask,
                              positions=batch.positions, segment_ids=batch.segment_ids)
        return inner(model, mlm_batch, rng)

    return loss_fn


def gpt2_125m(**overrides) -> GPTConfig:
    return GPTConfig(**{
        **dict(vocab_size=50304, d_model=768, n_layers=12, n_heads=12, seq_len=1024),
        **overrides,
    })


def gpt2_350m(**overrides) -> GPTConfig:
    return GPTConfig(**{
        **dict(vocab_size=50304, d_model=1024, n_layers=24, n_heads=16, seq_len=1024),
        **overrides,
    })


def llama_1b(**overrides) -> GPTConfig:
    return GPTConfig(**{
        **dict(vocab_size=32000, d_model=2048, n_layers=16, n_heads=16, seq_len=2048,
               positional="rope", norm="rmsnorm", mlp="swiglu"),
        **overrides,
    })


def bert_base(**overrides) -> GPTConfig:
    """BERT-base-shaped bidirectional encoder (MLM via :func:`make_mlm_loss`):
    vocab 30522 padded to 30592 (a multiple of 128; the last id doubles as
    [MASK] by :func:`make_mlm_loss`'s default)."""
    return GPTConfig(**{
        **dict(vocab_size=30592, d_model=768, n_layers=12, n_heads=12, seq_len=512,
               bidirectional=True),
        **overrides,
    })


def bert_base_hf(**overrides) -> GPTConfig:
    """BERT-base in its original (HF-checkpoint-faithful) form: post-norm
    residuals, the embedding LayerNorm, erf gelu, vocab 30522 unpadded and
    BERT's LayerNorm epsilon 1e-12: the config
    :func:`~tpu_parallel_torch.models.hf.from_hf_bert` imports into."""
    return GPTConfig(**{
        **dict(vocab_size=30522, d_model=768, n_layers=12, n_heads=12, seq_len=512,
               bidirectional=True, prenorm=False, embed_norm=True, mlp="gelu_exact",
               scan_layers=False, norm_eps=1e-12),
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
    the gradient of all chunks at once); otherwise the weight itself (under
    tensor parallelism this rank's vocabulary rows)."""
    del config
    return gather_module_params(model.lm_head)["weight"]


def make_ce_fn(config: GPTConfig, mesh=None):
    """``(lm_weight, hidden, targets, mask) -> (loss_sum, correct_sum)``:
    lm_head, fp32 cross-entropy and accuracy, as the JAX ``make_ce_fn``:
    vocab-parallel (``vocab_parallel_cross_entropy`` on this rank's
    vocabulary shard of the logits) when ``mesh``'s model axis is above 1,
    on full logits otherwise; under ``config.loss_chunk`` one checkpointed
    chunk of ``loss_chunk`` positions at a time (the JAX scan of
    ``jax.checkpoint(body)``): the backward recomputes each chunk's logits,
    so none outlives its chunk."""
    chunk = config.loss_chunk
    parallel = model_axis(mesh, config.model_axis) is not None

    def ce_block(lm_weight, h, targets, mask):
        logits = F.linear(h, lm_weight)
        if parallel:
            ce, pred = vocab_parallel_cross_entropy(logits, targets, config.model_axis, mesh)
        else:
            ce, pred = token_cross_entropy(logits, targets), logits.argmax(-1)
        loss_sum = (ce * mask).sum()
        correct = ((pred == targets) * mask).sum()
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
    (dropout off).  On ``mesh``'s model axis the cross-entropy runs
    vocab-parallel and the full-vocabulary logits never exist; the
    dropout fold over the model axis is JAX's (its ranks then drop
    different elements of the replicated residual stream).  Under a pipe
    axis the loss and its counts are the last rank's (JAX's
    ``last_stage_mask``): elsewhere the loss is a zero joined to the
    pipeline's output, so its backward still runs the reverse schedule,
    and no lm_head or cross-entropy runs.

    Under ``moe_experts`` > 0 the objective adds ``moe_balance_weight``
    times the blocks' summed load-balance values over ``n_layers`` (over
    ``n_layers * num_microbatches`` under a pipeline, where each rank's
    stage adds its own over its real ticks: summed over the ranks, every
    router's term carries the one-device weight), and the metrics report
    ``moe_balance``, the per-layer mean (summed over the pipe axis).
    """
    ce_fn = make_ce_fn(config, mesh)
    fold_axes = (config.data_axis, config.model_axis, config.pipe_axis, config.seq_axis)
    moe = config.moe_experts > 0
    denom = config.n_layers * (config.num_microbatches if config.pipe_size > 1 else 1)

    def loss_fn(model, batch, rng=None):
        if train and config.dropout_rate > 0.0 and rng is not None:
            rng = fold_rng_over_axis(rng, fold_axes, mesh)
        sown = [] if moe else None
        hidden = model(batch.tokens, positions=batch.positions,
                       segment_ids=batch.segment_ids, hidden_only=True, train=train, rng=rng,
                       moe_losses=sown)
        aux = None
        if moe:
            aux = sum(v.sum() for v in sown) / denom if sown else \
                torch.zeros((), device=hidden.device)
        if not getattr(model, "is_last_stage", True):
            zero = hidden.sum() * 0.0
            none = torch.zeros((), device=hidden.device)
            metrics = {"loss": (zero.detach(), none), "accuracy": (none, none)}
            if moe:
                _pipe_sum(aux.detach(), model)
                metrics["moe_balance"] = (none, none)
                return zero + config.moe_balance_weight * aux, metrics
            return zero, metrics
        mask = (batch.loss_mask if batch.loss_mask is not None
                else torch.ones(batch.targets.shape, device=hidden.device))
        n_tok = mask.sum()
        loss_sum, correct = ce_fn(_lm_head_params(config, model), hidden, batch.targets, mask)
        metrics = {"loss": (loss_sum, n_tok), "accuracy": (correct.float(), n_tok)}
        total = loss_sum / n_tok.clamp(min=1.0)
        if moe:
            # the full model's per-layer mean: each pipe rank holds its
            # stage's share
            metrics["moe_balance"] = (_pipe_sum(aux.detach(), model) * n_tok, n_tok)
            total = total + config.moe_balance_weight * aux
        return total, metrics

    return loss_fn


def _pipe_sum(value: torch.Tensor, model) -> torch.Tensor:
    """``value`` summed over the model's pipe axis (JAX's ``psum``; every
    pipe rank calls it), itself without one."""
    bound = getattr(model, "pipe", None)
    if bound is None:
        return value
    value = value.clone()
    torch.distributed.all_reduce(value, group=bound[0])
    return value


def make_gpt_1f1b_grad_fn(config: GPTConfig, train: bool = True, mesh=None):
    """``grad_fn(state, batch, rng) -> (grads, metrics)`` through the
    memory-bounded 1F1B schedule (``pp.pipeline_1f1b_grads``), in place of
    gradients through the GPipe forward when ``config.pipe_schedule ==
    "1f1b"``: in-flight microbatch inputs are bounded at ``2 * pipe_size -
    1`` per rank instead of ``num_microbatches``.  The same math as the
    GPipe step, per microbatch: rank 0 embeds, each rank runs its stage,
    the last rank applies ``norm_final``, the lm_head and the loss.
    ``grads`` are the state's fp32 accumulators (zeroed here), divided by
    the token count summed over the pipe axis; a pipe axis of 1 is the
    degenerate schedule (each microbatch forwarded, then recomputed and
    back-propagated).  JAX's refusals: interleaved virtual stages and
    ``n_layers`` not divisible by ``pipe_size``."""
    if config.pipe_interleave > 1:
        raise NotImplementedError(
            "1F1B with interleaved virtual stages (the circular schedule's "
            "chunk walk and the 1F1B buffer discipline do not compose yet)"
        )
    if config.moe_experts > 0:
        raise NotImplementedError(
            "MoE under 1F1B (sown balance losses need per-tick replay "
            "bookkeeping the schedule does not carry)"
        )
    if config.positional == "relative":
        raise NotImplementedError("relative position bias under pipelines")
    if config.n_layers % config.pipe_size:
        raise ValueError(
            f"n_layers={config.n_layers} not divisible by "
            f"pipe_size={config.pipe_size}"
        )
    ce_fn = make_ce_fn(config, mesh)
    fold_axes = (config.data_axis, config.model_axis, config.pipe_axis, config.seq_axis)
    m = config.num_microbatches

    def grad_fn(state, batch, rng=None):
        model = state.model
        first = model.pipe is None or model.pipe[2] == 0
        last = model.is_last_stage

        def fwd_fn(x_in, mb, gen):
            x = model.embed(mb.tokens, mb.positions) if first else x_in
            y = model.blocks(x, mb.positions, mb.segment_ids, dropout_rng=gen)
            if not last:
                none = torch.zeros((), device=y.device)
                return y, None, {"loss": (none, none), "accuracy": (none, none)}
            h = y if model.norm_final is None else model.norm_final(y).to(config.dtype)
            mask = (mb.loss_mask if mb.loss_mask is not None
                    else torch.ones(mb.targets.shape, device=y.device))
            n_tok = mask.sum()
            loss_sum, correct = ce_fn(_lm_head_params(config, model), h, mb.targets, mask)
            return y, loss_sum, {"loss": (loss_sum, n_tok), "accuracy": (correct.float(), n_tok)}

        if train and config.dropout_rate > 0.0 and rng is not None:
            rng = fold_rng_over_axis(rng, fold_axes, mesh)
        else:
            rng = None
        state.zero_grads()
        rows, seq = batch.tokens.shape
        _, metrics = pp.pipeline_1f1b_grads(
            fwd_fn, list(model.parameters()), batch, rng, num_microbatches=m, mesh=mesh,
            axis_name=config.pipe_axis, act_shape=(rows // m, seq, config.d_model),
            act_dtype=config.dtype, device=model.device)
        return state.grads, metrics

    return grad_fn
