"""Transformer building blocks: the port of ``tpu_parallel/models/layers.py``.

Single-device PyTorch modules with the JAX package's names and math:
matmul weights, biases and embeddings are held in ``config.dtype`` (what the
flax modules cast their fp32 params to at every use), LayerNorm and RMSNorm
compute and hold their params in fp32, softmax runs in fp32.  The Llama
family's pieces are JAX's too: ``positional="rope"`` rotates q and k in
:class:`Attention` (:func:`apply_rope`, interleaved pairs) and drops the
position table, ``norm="rmsnorm"`` and the gated MLPs (``swiglu``,
``geglu``: bias-free ``gate``, ``up`` and ``down``).  The encoder family's
are too: ``bidirectional`` attention (no causal mask; the flash path one
non-causal :func:`flash_chunk_attention` over the sequence, and no
decoding), post-norm blocks (``prenorm=False``) and the embedding
LayerNorm (``embed_norm``).  The T5 family's relative position bias
(``positional="relative"``: :func:`t5_relative_bucket`,
:class:`RelativePositionBias`) is an additive score bias that the xla
and decode attention paths take (``attn_bias``), one table per stack
above its blocks.  Under ``fsdp`` and a mesh,
each block is FSDP-sharded over the data axis (``parallel/fsdp.py``).  On a
mesh whose model axis is above 1 the projections are tensor-parallel
(``parallel/tp.py``): attention's ``qkv`` (or ``q`` and ``kv``) and the
MLP's ``up`` are column-parallel over ``n_heads // tp`` local heads and
``hidden // tp`` local units, ``out`` and ``down`` row-parallel, and the
KV caches hold the local kv heads.  On a mesh that binds the seq axis,
``attn_impl`` ``"ring"`` and ``"ulysses"`` shard the token axis
(``ops/ring_attention.py``, ``ops/ulysses.py``; :func:`seq_parallel_active`)
and a bare :class:`Embedding` call looks up the rank's block of the
position table.  Under ``moe_experts`` > 0 each block's MLP is a
mixture of experts (``models/moe.py``), expert-parallel over the model
axis.  Linear weights are PyTorch's ``[out, in]``;
``models/convert.py`` transposes flax's ``[in, out]`` kernels.

Activation checkpointing (``remat``/``remat_policy``) wraps each block in
``torch.utils.checkpoint``; the save policies keep the values the JAX layers
name with ``checkpoint_name`` (:func:`checkpoint_name` here), or every 2-D
product's output under ``"dots"``.  A row layer's all-reduce runs inside
the ``"proj"`` scope, so ``"proj"`` and ``"proj_attn"`` keep its output and
the recompute launches no forward collective (JAX names ``"proj"`` after
the ``psum``).

Dropout sits where flax puts it (after the attention output projection and
after the MLP down projection) and runs only when training.  Its masks come
from one seed per layer that :class:`BlockStack` draws from the caller's
generator OUTSIDE the checkpointed call: the layer seeds a fresh generator
from it, so a recompute in the backward redraws the same masks.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from tpu_parallel_torch.models.moe import MoEMLP
from tpu_parallel_torch.models.quantize import absmax_int8
from tpu_parallel_torch.ops.flash_attention import (FLASH_FWD_OP, flash_attention,
                                                    flash_chunk_attention)
from tpu_parallel_torch.ops.ring_attention import (RING_FLASH_FWD_OP, ring_attention,
                                                   ring_flash_attention)
from tpu_parallel_torch.ops.ulysses import gather_sequence, ulysses_attention
from tpu_parallel_torch.parallel.fsdp import maybe_shard
from tpu_parallel_torch.parallel.tp import TPDense, model_axis
from tpu_parallel_torch.runtime.mesh import axis_group

_MOE_ROUTERS = ("topk", "expert_choice")
_MOE_DISPATCHES = ("dense", "alltoall")
_MLPS = ("gelu", "gelu_exact", "relu", "swiglu", "geglu")
_GATED = ("swiglu", "geglu")
_POSITIONALS = ("learned", "rope", "relative")
_NORMS = ("layernorm", "rmsnorm")
_KV_CACHE_DTYPES = ("bf16", "int8")
_ATTN_IMPLS = ("xla", "flash", "ring", "ulysses")
# ops whose outputs count as "attn" for the remat policies: the flash forward
# kernel and the flash-composed ring's forward (its exchanges included)
_ATTN_OPS = (FLASH_FWD_OP, RING_FLASH_FWD_OP)
# remat_policy -> the checkpoint names whose values the backward keeps
# ("full": none, so every block recomputes its whole forward; "dots" keeps
# products by op, not by name)
_REMAT_SAVES = {"full": (), "proj": ("proj",), "proj_attn": ("proj", "attn"), "dots": ()}
# the 2-D products without batch dims: what a Linear runs
# (jax.checkpoint_policies.dots_with_no_batch_dims_saveable)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """Architecture knobs, field for field as in the JAX package.

    ``dtype`` is a torch dtype.  ``positional="relative"`` is T5's bucketed
    per-head score bias (:class:`RelativePositionBias`, ``rel_num_buckets``
    and ``rel_max_distance``; no position table, xla attention only).
    ``bidirectional`` drops the
    causal mask (the encoder family: no decoding), ``prenorm=False`` makes
    the blocks post-norm and ``embed_norm`` normalizes the summed
    embedding (BERT's layout).  ``remat`` checkpoints each block
    when gradients are taken; ``remat_policy`` chooses what the backward
    keeps: ``"full"`` nothing (the block's forward is recomputed), ``"proj"``
    the qkv/out/up/down projection outputs, ``"proj_attn"`` those and the
    attention output (the flash kernel's out and lse, or the xla path's
    context), so the backward never re-runs attention's forward, and
    ``"dots"`` the output of every 2-D product (the linear layers), while
    attention's batched products and the flash kernel are recomputed.
    ``dropout_rate`` > 0 drops activations when the model runs with
    ``train=True``.  ``fsdp`` shards the blocks', the embedding's and the
    lm_head's parameters of more than ``fsdp_min_size`` elements over
    ``data_axis`` when the model is built on a mesh (identity without one).
    ``scan_*``,
    the mesh-axis names and ``num_microbatches`` are compile or
    parallelism knobs of the JAX package; they change nothing here.
    ``flash_block_q``/``flash_block_k`` stay for API parity: the CUDA
    kernels' tiles are their own constants.  ``kv_block_tokens`` > 0
    makes :meth:`GPTLM.init_cache` return the block-paged cache
    (:class:`PagedKVCache`, ``kv_pool_blocks`` blocks of
    ``kv_block_tokens`` positions per layer) that the serving engine
    addresses through block tables.  ``kv_cache_dtype="int8"`` stores the
    cache's K/V as int8 with one fp32 scale per (position, kv-head)
    (``"bf16"``, the default, stores them in ``dtype``).  ``beam_width`` > 1
    makes :meth:`GPTLM.init_cache` give each layer's cache a ``beam_src``
    table, so decoding reads it through :func:`beam_decode_attention`
    (lazy beam search; ``models/generate.py:generate_beam``).
    """

    vocab_size: int = 50304
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    n_kv_heads: Optional[int] = None
    seq_len: int = 1024
    mlp_ratio: int = 4
    dropout_rate: float = 0.0
    dtype: torch.dtype = torch.bfloat16
    positional: str = "learned"
    rope_theta: float = 10000.0
    rel_num_buckets: int = 32
    rel_max_distance: int = 128
    norm: str = "layernorm"
    prenorm: bool = True
    embed_norm: bool = False
    norm_eps: float = 1e-5
    mlp: str = "gelu"
    dense_bias: bool = True
    model_axis: str = "model"
    data_axis: str = "data"
    pipe_axis: str = "pipe"
    seq_axis: str = "seq"
    num_microbatches: int = 4
    remat: bool = True
    remat_policy: str = "full"
    scan_layers: bool = True
    scan_unroll: int = 1
    scan_group: int = 1
    scan_split_transpose: bool = False
    fsdp: bool = False
    fsdp_min_size: int = 2**18
    attn_impl: str = "xla"
    flash_block_q: int = 512
    flash_block_k: int = 512
    attn_window: int = 0
    kv_cache_dtype: str = "bf16"
    kv_block_tokens: int = 0
    kv_pool_blocks: int = 0
    beam_width: int = 0
    bidirectional: bool = False
    moe_experts: int = 0
    moe_router: str = "topk"
    moe_top_k: int = 1
    moe_capacity_factor: float = 1.25
    moe_balance_weight: float = 0.01
    moe_dispatch: str = "dense"

    def __post_init__(self):
        if self.positional not in _POSITIONALS:
            raise ValueError(f"unknown positional {self.positional!r}")
        if self.norm not in _NORMS:
            raise ValueError(f"unknown norm {self.norm!r}")
        if self.kv_cache_dtype not in _KV_CACHE_DTYPES:
            raise ValueError(f"kv_cache_dtype={self.kv_cache_dtype!r} (bf16 | int8)")
        if self.mlp not in _MLPS:
            raise NotImplementedError(f"mlp={self.mlp!r}: the port has {_MLPS}")
        if self.attn_impl not in _ATTN_IMPLS:
            raise NotImplementedError(
                f"attn_impl={self.attn_impl!r}: the port has {_ATTN_IMPLS}"
            )
        n_kv = self.n_kv_heads or self.n_heads
        if self.n_heads % n_kv != 0:
            raise ValueError(f"n_kv_heads={n_kv} must divide n_heads={self.n_heads}")
        if self.d_model % self.n_heads != 0:
            raise ValueError(f"n_heads={self.n_heads} must divide d_model={self.d_model}")
        if self.moe_experts > 0:
            # JAX's errors, raised where the JAX module would meet them
            if not 1 <= self.moe_top_k <= self.moe_experts:
                raise ValueError(
                    f"moe_top_k={self.moe_top_k} must be in [1, moe_experts={self.moe_experts}]"
                )
            if self.moe_dispatch not in _MOE_DISPATCHES:
                raise ValueError(f"moe_dispatch={self.moe_dispatch!r} (dense | alltoall)")
            if self.moe_router not in _MOE_ROUTERS:
                raise ValueError(f"moe_router={self.moe_router!r} (topk | expert_choice)")
        if self.kv_block_tokens < 0:
            raise ValueError(f"kv_block_tokens={self.kv_block_tokens} < 0")
        if self.kv_block_tokens and self.seq_len % self.kv_block_tokens:
            raise ValueError(
                f"kv_block_tokens={self.kv_block_tokens} must divide seq_len={self.seq_len}"
            )
        if self.kv_block_tokens and self.kv_pool_blocks < 1:
            raise ValueError(
                f"kv_block_tokens={self.kv_block_tokens} needs kv_pool_blocks >= 1 "
                f"(got {self.kv_pool_blocks})"
            )

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def seq_parallel_active(config: TransformerConfig, mesh) -> bool:
    """True when attention shards the token axis: a seq-parallel impl is
    selected AND ``mesh`` binds the seq axis (JAX: inside ``shard_map``)."""
    return config.attn_impl in ("ring", "ulysses") and axis_group(
        mesh, config.seq_axis) is not None


class LayerNorm(nn.LayerNorm):
    """LayerNorm computed in fp32 with fp32 params; returns fp32 (the caller
    casts back to ``config.dtype``, as the JAX blocks do)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(
            x.float(), self.normalized_shape, self.weight, self.bias, self.eps
        )


class RMSNorm(nn.RMSNorm):
    """flax's ``nn.RMSNorm`` computed in fp32 with an fp32 ``scale``
    (``weight`` here) and no bias; returns fp32."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.rms_norm(x.float(), self.normalized_shape, self.weight, self.eps)


def make_norm(config: TransformerConfig, device=None) -> nn.Module:
    """fp32 norm of width ``d_model`` with ``config.norm_eps``: RMSNorm
    under ``norm="rmsnorm"``, LayerNorm otherwise."""
    cls = RMSNorm if config.norm == "rmsnorm" else LayerNorm
    return cls(config.d_model, eps=config.norm_eps, dtype=torch.float32, device=device)


def rope_tables(positions: torch.Tensor, head_dim: int,
                theta: float = 10000.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 ``(cos, sin)`` [batch, seq, 1, head_dim // 2] of the angles
    ``positions * inv_freq``, ``inv_freq = 1 / theta ** (arange(0, D, 2) /
    D)``: one set for every tensor rotated at ``positions`` [batch, seq]."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=positions.device) / head_dim
    angles = (positions[..., None].float() * (1.0 / (theta ** exponents)))[:, :, None, :]
    return angles.cos(), angles.sin()


def rotate_pairs(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """``x`` [batch, seq, heads, head_dim] with its interleaved pairs
    ``(x[..., ::2], x[..., 1::2])`` rotated by :func:`rope_tables`' angles
    and restacked in place (not the rotate-half layout).  The products run
    in fp32 (JAX promotes a bf16 ``x`` against fp32 cos/sin) and round to
    ``x.dtype`` once."""
    x1, x2 = x[..., ::2].float(), x[..., 1::2].float()
    rotated = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return rotated.reshape(x.shape).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """Rotary position embedding over the last (head_dim) axis, JAX's
    ``apply_rope``: :func:`rotate_pairs` by :func:`rope_tables`.  ``x``
    [batch, seq, heads, head_dim], ``positions`` [batch, seq].  No host
    sync: the engine replays it inside CUDA graphs."""
    return rotate_pairs(x, *rope_tables(positions, x.shape[-1], theta))


class _ActiveName(threading.local):
    """The checkpoint name in force in this thread (None outside a scope)."""

    name: Optional[str] = None


_active = _ActiveName()


@contextlib.contextmanager
def checkpoint_name(name: str):
    """Tag the ops run inside with ``name`` for the remat policies: the
    counterpart of ``jax.ad_checkpoint.checkpoint_name``, as a scope around
    the op that computes the value instead of a mark on the value."""
    outer, _active.name = _active.name, name
    try:
        yield
    finally:
        _active.name = outer


def _save_only_these_names(*names: str):
    """Selective-checkpoint policy: keep the outputs of the ops tagged with
    one of ``names`` (views excepted; the flash forward kernel and the
    flash ring's forward count as "attn"), recompute every other op."""

    def policy(ctx, op, *args, **kwargs):
        if op in _ATTN_OPS:
            name = "attn"
        else:
            name = None if op.is_view else _active.name
        return CheckpointPolicy.MUST_SAVE if name in names else CheckpointPolicy.PREFER_RECOMPUTE

    return policy


def _save_dots(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy: keep every 2-D product's output."""
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def remat_kwargs_for(config: TransformerConfig) -> dict:
    """``torch.utils.checkpoint`` kwargs for a block under
    ``config.remat_policy``."""
    policy = config.remat_policy
    if policy not in _REMAT_SAVES:
        raise ValueError(f"remat_policy={policy!r}: expected one of {sorted(_REMAT_SAVES)}")
    kwargs = dict(use_reentrant=False)
    if policy == "dots":
        save = _save_dots
    elif _REMAT_SAVES[policy]:
        save = _save_only_these_names(*_REMAT_SAVES[policy])
    else:
        return kwargs
    kwargs["context_fn"] = functools.partial(create_selective_checkpoint_contexts, save)
    return kwargs


def dropout(x: torch.Tensor, rate: float, gen: torch.Generator) -> torch.Tensor:
    """flax's ``nn.Dropout`` in training: keep each element with
    probability 1 - rate (one fp32 uniform draw per element from ``gen``)
    and scale the kept ones by 1 / (1 - rate), in ``x``'s dtype."""
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=gen, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))


@functools.lru_cache(maxsize=None)
def _inv_sqrt_head_dim(head_dim: int, dtype: torch.dtype) -> float:
    """1 / sqrt(head_dim) rounded through ``dtype`` as the JAX layers compute
    it; exact in ``dtype``, so ``q * scale`` rounds once."""
    root = torch.sqrt(torch.tensor(float(head_dim), dtype=torch.float32)).to(dtype)
    return (1.0 / root).item()


def causal_attention(q, k, v, *, segment_ids=None, window: int = 0,
                     causal: bool = True, bias=None) -> torch.Tensor:
    """Reference attention on [batch, seq, heads, head_dim]: O(seq^2) scores
    in fp32, matmuls in the input dtype (the ``attn_impl="xla"`` path).
    ``causal=False`` is the bidirectional form; with ``window`` the band is
    then symmetric, |q - k| < window.  ``bias`` [1 | batch, heads, q, k]
    (T5's relative bias) is added to the fp32 scores before the mask."""
    scale = _inv_sqrt_head_dim(q.shape[-1], q.dtype)
    scores = torch.einsum("bqhd,bkhd->bhqk", q * scale, k).float()
    if bias is not None:
        scores = scores + bias.float()
    q_pos = torch.arange(q.shape[1], device=q.device)[:, None]
    k_pos = torch.arange(k.shape[1], device=q.device)[None, :]
    mask = q_pos >= k_pos if causal else None
    if window:
        near = q_pos - k_pos < window
        if not causal:
            near = near & (k_pos - q_pos < window)
        mask = near if mask is None else mask & near
    if segment_ids is not None:
        same = (segment_ids[:, :, None] == segment_ids[:, None, :])[:, None]
        mask = same if mask is None else mask & same
    if mask is not None:
        scores = scores.masked_fill(~mask, torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    # the "proj_attn" policy keeps this context (an O(seq) residual)
    with checkpoint_name("attn"):
        return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def bidirectional_flash_attention(q, k, v, segment_ids=None, *, block_q: int = 512,
                                  block_k: int = 512, window: int = 0) -> torch.Tensor:
    """Full-visibility flash attention, JAX's: ONE non-causal
    :func:`flash_chunk_attention` over the whole sequence (grouped queries
    routed natively, ``segment_ids`` masking padding or packed sequences),
    its lse discarded (a zero lse cotangent in the backward).  ``window``
    restricts it to the symmetric band |q - k| < window.  The encoder's
    flash path and its Ulysses inner attention."""
    out, _ = flash_chunk_attention(q, k, v, causal=False, block_q=block_q, block_k=block_k,
                                   window=window, segment_ids_q=segment_ids,
                                   segment_ids_kv=segment_ids)
    return out


def _grouped_bias(bias: torch.Tensor, h_kv: int) -> torch.Tensor:
    """A score bias [1 | rows, heads, q, k] as [kv_heads, 1 | rows, group,
    q, k], fp32: the grouped layout the decode products' scores take."""
    rows, h = bias.shape[:2]
    return bias.float().view(rows, h_kv, h // h_kv, *bias.shape[2:]).transpose(0, 1)


def decode_attention(q, k_heads, v_heads, positions, window: int = 0,
                     k_positions=None, k_scale=None, v_scale=None, bias=None) -> torch.Tensor:
    """New queries against a whole KV cache, GQA-native.

    ``q`` [batch, new_len, heads, head_dim] at global ``positions``
    [batch, new_len]; ``k_heads``/``v_heads`` [kv_heads, batch, cache_len,
    head_dim], contiguous: the caches' read layout, in which kv_heads and
    batch collapse into the one batch dimension of both batched products,
    so the cache is read as it lies (no relayout copy).  ``k_positions``
    [batch, cache_len] is the global position each slot holds (-1: empty,
    never attended); None means slot j holds position j.  A slot is
    visible when ``0 <= kp <= qp`` (and ``qp - kp < window``).  The math
    is JAX's ``decode_attention``: scaled q in its dtype, fp32 scores and
    softmax, probabilities back in q's dtype.

    ``k_scale``/``v_scale`` [kv_heads, batch, cache_len, 1] switch to the
    int8-native read: ``k_heads``/``v_heads`` are the raw int8 payloads and
    the per-(position, kv-head) scales fold into the surrounding products,
    in JAX's order: the K scales multiply the fp32 scores after the q.k
    product, the V scales the fp32 probabilities before one rounding to q's
    dtype.  ``torch.bmm`` takes no int8 operand, so each payload is cast to
    q's dtype first (exact: |int8| <= 127 fits bf16's significand), a
    transient cache-sized copy per payload that XLA fuses into the product.
    """
    b, nq, h, head_dim = q.shape
    h_kv, _, cache_len, _ = k_heads.shape
    group = h // h_kv
    scale = _inv_sqrt_head_dim(head_dim, q.dtype)
    # queries as [kv_heads, batch, group, new_len, head_dim]: q-sized
    qh = (q.reshape(b, nq, h_kv, group, head_dim).permute(2, 0, 3, 1, 4) * scale).reshape(
        h_kv * b, group * nq, head_dim)
    k = k_heads.view(h_kv * b, cache_len, head_dim)
    v = v_heads.view(h_kv * b, cache_len, head_dim)
    if k_scale is not None:
        k = k.to(q.dtype)
    scores = torch.bmm(qh, k.transpose(1, 2)).float().view(h_kv, b, group, nq, cache_len)
    if k_scale is not None:
        scores = scores * k_scale.view(h_kv, b, 1, 1, cache_len)
    if bias is not None:
        scores = scores + _grouped_bias(bias, h_kv)
    if k_positions is None:
        k_positions = torch.arange(cache_len, device=q.device).expand(b, -1)
    kp = k_positions[None, :, None, None, :]
    qp = positions[None, :, None, :, None]
    mask = (kp >= 0) & (kp <= qp)
    if window:
        mask = mask & (qp - kp < window)
    scores = scores.masked_fill(~mask, torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    if v_scale is not None:
        # fp32 multiply, one rounding back to q's dtype, as JAX folds them
        probs = (probs.float() * v_scale.view(h_kv, b, 1, 1, cache_len)).to(q.dtype)
        v = v.to(q.dtype)
    out = torch.bmm(probs.view(h_kv * b, group * nq, cache_len), v)
    return out.view(h_kv, b, group, nq, head_dim).permute(1, 3, 0, 2, 4).reshape(
        b, nq, h, head_dim)


def beam_decode_attention(q, k_heads, v_heads, positions, beam_src, num_beams: int,
                          window: int = 0, k_positions=None, bias=None) -> torch.Tensor:
    """Decode attention against an UN-reordered beam-search KV cache.

    Rows are beam-major: beam j of prompt i is row ``i * num_beams + j``.
    ``beam_src`` [rows, cache_len] names, per row and cache slot, the row
    (within the same prompt's beam group) whose cache physically holds that
    slot of this beam's history.  Scores are computed all-pairs over the
    group's ``num_beams`` rows and the right pair is selected per slot; on
    the value side each row's probabilities are bucketed by source beam
    (a one-hot over it) and contracted all-pairs.  The cache is read once
    and never gathered.  Shapes as :func:`decode_attention` (``k_heads``/
    ``v_heads`` [kv_heads, rows, cache_len, head_dim]; ``bias`` [1 | rows,
    heads, new_len, cache_len] added to the selected fp32 scores); the math
    is JAX's ``beam_decode_attention``.
    """
    rows, nq, h, head_dim = q.shape
    kb = num_beams
    b = rows // kb
    if b * kb != rows:
        raise ValueError(f"rows={rows} not divisible by num_beams={kb}")
    h_kv, _, cache_len, _ = k_heads.shape
    group = h // h_kv
    scale = _inv_sqrt_head_dim(head_dim, q.dtype)
    # queries as [kv_heads, prompt, (beam, group, new_len), head_dim] against
    # each prompt's whole beam group of keys [(beam', slot)]
    qh = (q.reshape(b, kb, nq, h_kv, group, head_dim).permute(3, 0, 1, 4, 2, 5)
          * scale).reshape(h_kv * b, kb * group * nq, head_dim)
    k = k_heads.reshape(h_kv * b, kb * cache_len, head_dim)
    # all-pairs scores [kv_heads, b, j, group, q, j', slot]
    scores = torch.bmm(qh, k.transpose(1, 2)).float().view(
        h_kv, b, kb, group, nq, kb, cache_len)
    src = (beam_src.reshape(b, kb, cache_len) % kb).long()  # [b, j, slot]
    idx = src[None, :, :, None, None, None, :].expand(h_kv, b, kb, group, nq, 1, cache_len)
    sel = scores.gather(5, idx).squeeze(5)  # [kv_heads, b, j, group, q, slot]
    if bias is not None:
        bb = _grouped_bias(bias, h_kv)  # [kv_heads, 1 | rows, group, q, slot]
        sel = sel + bb.reshape(h_kv, -1, kb, group, nq, cache_len) if bb.shape[1] > 1 \
            else sel + bb[:, :, None]
    if k_positions is None:
        k_positions = torch.arange(cache_len, device=q.device).expand(rows, -1)
    kp = k_positions.reshape(b, kb, cache_len)[None, :, :, None, None, :]
    qp = positions.reshape(b, kb, nq)[None, :, :, None, :, None]
    mask = (kp >= 0) & (kp <= qp)
    if window:
        mask = mask & (qp - kp < window)
    sel = sel.masked_fill(~mask, torch.finfo(torch.float32).min)
    probs = torch.softmax(sel, dim=-1).to(q.dtype)
    onehot = F.one_hot(src, kb).to(q.dtype).permute(0, 1, 3, 2)  # [b, j, j', slot]
    pm = probs[:, :, :, :, :, None, :] * onehot[None, :, :, None, None, :, :]
    out = torch.bmm(pm.reshape(h_kv * b, kb * group * nq, kb * cache_len),
                    v_heads.reshape(h_kv * b, kb * cache_len, head_dim))
    return out.view(h_kv, b, kb, group, nq, head_dim).permute(1, 2, 4, 0, 3, 5).reshape(
        rows, nq, h, head_dim)


def t5_relative_bucket(relative_position: torch.Tensor, bidirectional: bool, num_buckets: int,
                       max_distance: int) -> torch.Tensor:
    """T5's relative-position bucketing, JAX's ``t5_relative_bucket``:
    ``relative_position`` (``k_pos - q_pos``, integers) -> int32 buckets,
    exact below ``max_exact`` and log-spaced beyond it, computed in fp32 as
    JAX and the canonical implementation compute it (the truncation of
    ``log(rp / max_exact) / log(max_distance / max_exact) * ...``).
    Bidirectional stacks split the buckets between past and future; causal
    stacks bucket only the past (future positions land in bucket 0)."""
    rp = relative_position.to(torch.int32)
    bucket = torch.zeros_like(rp)
    if bidirectional:
        num_buckets = num_buckets // 2
        bucket = bucket + (rp > 0).to(torch.int32) * num_buckets
        rp = rp.abs()
    else:
        rp = -rp.clamp(max=0)
    max_exact = num_buckets // 2
    is_small = rp < max_exact
    log_ratio = torch.log(torch.tensor(max_distance / max_exact, dtype=torch.float32))
    scaled = max_exact + (torch.log(rp.clamp(min=1).float() / max_exact) / log_ratio.to(rp.device)
                          * (num_buckets - max_exact)).to(torch.int32)
    scaled = scaled.clamp(max=num_buckets - 1)
    return bucket + torch.where(is_small, rp, scaled)


@functools.lru_cache(maxsize=None)
def _bucket_table(bidirectional: bool, num_buckets: int, max_distance: int) -> torch.Tensor:
    """:func:`t5_relative_bucket` of every relative position in
    ``[-max_distance, max_distance]``, computed on the host (int64 CPU):
    beyond ``max_distance`` every bucket is the saturated one, so the table
    indexed by the clamped position is the function everywhere, and a
    device's own ``log`` never decides a bucket boundary."""
    rel = torch.arange(-max_distance, max_distance + 1)
    return t5_relative_bucket(rel, bidirectional, num_buckets, max_distance).long()


class RelativePositionBias(nn.Module):
    """T5-style bucketed per-head position bias, shared across a stack (JAX's
    ``RelativePositionBias``): ``(q_positions [Q], k_positions [K]) -> bias
    [1, n_heads, Q, K]`` fp32, from one fp32 table ``rel_embedding``
    [rel_num_buckets, n_heads].  The buckets come from the host-computed
    :func:`_bucket_table` (one index per pair, no host sync), so they are
    the same on every device.  Under tensor parallelism each
    :class:`Attention` slices its local heads off the full-width bias."""

    def __init__(self, config: TransformerConfig, bidirectional: bool, device=None):
        super().__init__()
        self.config = config
        self.bidirectional = bidirectional
        self.rel_embedding = nn.Parameter(torch.empty(
            config.rel_num_buckets, config.n_heads, dtype=torch.float32, device=device))
        self._tables = {}

    def _table(self, device) -> torch.Tensor:
        if device not in self._tables:
            cfg = self.config
            self._tables[device] = _bucket_table(self.bidirectional, cfg.rel_num_buckets,
                                                 cfg.rel_max_distance).to(device)
        return self._tables[device]

    def forward(self, q_positions: torch.Tensor, k_positions: torch.Tensor) -> torch.Tensor:
        md = self.config.rel_max_distance
        rel = (k_positions[None, :] - q_positions[:, None]).long().clamp(-md, md)
        bucket = self._table(rel.device)[rel + md]  # [Q, K]
        return self.rel_embedding[bucket].permute(2, 0, 1)[None]  # [1, H, Q, K]

    def for_step(self, positions: Optional[torch.Tensor], q_len: int, cache_len: int,
                 decode: bool) -> torch.Tensor:
        """JAX's recipe shared by ``GPTLM`` and the seq2seq decoder: queries
        at ``positions`` (row 0: callers broadcast uniform positions; packed
        and ragged rows are refused upstream) against themselves, or in
        ``decode`` against every cache slot ``arange(cache_len)`` (the
        slots :func:`decode_attention` reads; the cache's scratch row is
        not one of them)."""
        device = self.rel_embedding.device
        q_pos = positions[0] if positions is not None else torch.arange(q_len, device=device)
        k_pos = torch.arange(cache_len, device=q_pos.device) if decode else q_pos
        return self(q_pos, k_pos)


def _kv_entries(quantized: bool, k, v):
    """What one write stores, in :attr:`KVCache.stores` order: ``[k, v]``,
    or under the int8 cache ``[k_q, v_q, k_scale, v_scale]``
    (:func:`absmax_int8` over head_dim: one fp32 scale per (position,
    kv-head)).  Each [batch, t, kv_heads, head_dim or 1]."""
    if not quantized:
        return [k, v]
    kq, ks = absmax_int8(k, axis=-1)
    vq, vs = absmax_int8(v, axis=-1)
    return [kq, vq, ks, vs]


# the int8 stores' keyword names, in ``stores`` order
_SCALE_FIELDS = ("key_scale_store", "value_scale_store")


class _KVStores:
    """What both cache layouts share: the payload stores and, under the
    int8 cache, their scale stores."""

    key_store: torch.Tensor
    value_store: torch.Tensor
    key_scale_store: Optional[torch.Tensor]
    value_scale_store: Optional[torch.Tensor]
    beam_src: Optional[torch.Tensor] = None

    @property
    def quantized(self) -> bool:
        return self.key_scale_store is not None

    @property
    def stores(self) -> List[torch.Tensor]:
        """Every head-major store: K, V, then the int8 cache's K and V
        scales."""
        out = [self.key_store, self.value_store]
        if self.quantized:
            out += [self.key_scale_store, self.value_scale_store]
        return out


class KVCache(_KVStores):
    """One attention layer's contiguous decode cache (the JAX ``cache``
    collection's ``cached_key``/``cached_value``/``cached_pos``/
    ``cache_index``, and under the int8 cache ``cached_key_scale``/
    ``cached_value_scale``).  :class:`Attention` updates it IN PLACE,
    either at the scalar slot ``index`` (which it then advances) or, under
    ``write_index``, at each row's own column.

    Storage is head-major: ``key_store``/``value_store`` hold
    ``[kv_heads, batch, seq_len, head_dim]`` flattened to rows of
    ``head_dim``, plus one scratch row at the end; ``pos_store`` holds
    ``[batch, seq_len]`` flattened, plus one scratch entry.  The int8 cache
    keeps int8 payloads and ``key_scale_store``/``value_scale_store``, fp32
    rows of width 1 laid out as the payloads (None for the bf16 cache);
    :attr:`stores` lists every head-major store, payloads first.
    :attr:`key_heads`/:attr:`value_heads` are the contiguous
    ``[kv_heads, batch, seq_len, head_dim]`` views :func:`decode_attention`
    reads as they lie; :attr:`key`, :attr:`value` ([batch, seq_len,
    kv_heads, head_dim]) and :attr:`pos` ([batch, seq_len]) are the
    logical views (JAX's layout) the row ops and tests index.  A
    ``write_index`` target outside ``[0, seq_len)`` is redirected to the
    scratch row, which is how the port drops it (JAX's scatter drops
    out-of-range targets; an out-of-range ``index_put_`` would raise, and
    clamping would overwrite a valid boundary column).  Storage never
    moves, so a captured CUDA graph can write it.

    Lazy beam search gives the cache ``beam_src`` [batch, seq_len] int32
    and ``num_beams``: the row whose cache holds each slot of each row's
    beam history (JAX keeps the same table per layer).  Attention then
    reads through :func:`beam_decode_attention`.
    """

    def __init__(self, key_store: torch.Tensor, value_store: torch.Tensor,
                 pos_store: torch.Tensor, batch: int, index: int = 0,
                 key_scale_store: Optional[torch.Tensor] = None,
                 value_scale_store: Optional[torch.Tensor] = None):
        self.key_store = key_store  # [kv_heads * batch * seq_len + 1, head_dim]
        self.value_store = value_store
        self.key_scale_store = key_scale_store  # [kv_heads * batch * seq_len + 1, 1] fp32
        self.value_scale_store = value_scale_store
        self.pos_store = pos_store  # [batch * seq_len + 1] int32; -1 = empty slot
        self.batch = batch
        self.index = index
        self.beam_src: Optional[torch.Tensor] = None
        self.num_beams = 0

    @classmethod
    def empty(cls, config: TransformerConfig, batch: int, device,
              kv_heads: Optional[int] = None) -> "KVCache":
        """A zeroed cache of ``batch`` rows; ``kv_heads`` (default every kv
        head) is the count this rank holds (the local heads under tensor
        parallelism)."""
        n_kv = kv_heads or config.n_kv_heads or config.n_heads
        rows = n_kv * batch * config.seq_len + 1
        int8 = config.kv_cache_dtype == "int8"
        payload = torch.int8 if int8 else config.dtype
        scales = {f: torch.zeros(rows, 1, dtype=torch.float32, device=device)
                  for f in _SCALE_FIELDS} if int8 else {}
        return cls(
            key_store=torch.zeros(rows, config.head_dim, dtype=payload, device=device),
            value_store=torch.zeros(rows, config.head_dim, dtype=payload, device=device),
            pos_store=torch.full((batch * config.seq_len + 1,), -1, dtype=torch.int32,
                                 device=device),
            batch=batch, **scales,
        )

    @classmethod
    def _allocate(cls, like: Sequence[torch.Tensor], n_kv: int, batch: int, seq_len: int,
                  pos_like: torch.Tensor, index: int = 0) -> "KVCache":
        """A zeroed cache of ``batch`` rows (positions -1) whose stores take
        the widths, dtypes and device of ``like`` (K, V, then any scales)."""
        stores = [s.new_zeros(n_kv * batch * seq_len + 1, s.shape[-1]) for s in like]
        return cls(*stores[:2], pos_store=pos_like.new_full((batch * seq_len + 1,), -1),
                   batch=batch, index=index, **dict(zip(_SCALE_FIELDS, stores[2:])))

    @classmethod
    def from_heads(cls, heads: Sequence[torch.Tensor], pos, index: int = 0) -> "KVCache":
        """A new cache holding copies of ``heads`` (the :attr:`stores`'
        head-major views, each [kv_heads, batch, seq_len, width]: K and V,
        then the int8 cache's K and V scales) and ``pos`` [batch,
        seq_len]."""
        n_kv, batch, seq_len, _ = heads[0].shape
        cache = cls._allocate(heads, n_kv, batch, seq_len, pos, index)
        for dst, src in zip(cache.heads(), heads):
            dst.copy_(src)
        cache.pos.copy_(pos)
        return cache

    @property
    def seq_len(self) -> int:
        return (self.pos_store.shape[0] - 1) // self.batch

    def _heads(self, store: torch.Tensor) -> torch.Tensor:
        return store[:-1].view(-1, self.batch, self.seq_len, store.shape[-1])

    def heads(self) -> List[torch.Tensor]:
        """The [kv_heads, batch, seq_len, width] views of :attr:`stores`."""
        return [self._heads(s) for s in self.stores]

    @property
    def key_heads(self) -> torch.Tensor:
        return self._heads(self.key_store)

    @property
    def value_heads(self) -> torch.Tensor:
        return self._heads(self.value_store)

    @property
    def key(self) -> torch.Tensor:
        return self.key_heads.permute(1, 2, 0, 3)

    @property
    def value(self) -> torch.Tensor:
        return self.value_heads.permute(1, 2, 0, 3)

    @property
    def pos(self) -> torch.Tensor:
        return self.pos_store[:-1].view(self.batch, self.seq_len)

    def take_rows(self, rows: torch.Tensor) -> "KVCache":
        """A new cache of ``len(rows)`` rows: row i is a copy of this
        cache's row ``rows[i]`` in every store and the position table (one
        ``index_select`` each, straight into the new storage); the scalar
        index is kept, a ``beam_src`` table is not."""
        new = self._allocate(self.stores, self.key_heads.shape[0], rows.shape[0], self.seq_len,
                             self.pos_store, self.index)
        for dst, src in zip(new.heads(), self.heads()):
            torch.index_select(src, 1, rows, out=dst)
        torch.index_select(self.pos, 0, rows, out=new.pos)
        return new

    def seed_beam_src(self, num_beams: int) -> None:
        """Give the cache an identity ``beam_src`` table (every row holds
        its own slots: right after a prefill replicated to each beam) for
        lazy beam search over ``num_beams`` beams per prompt."""
        rows = torch.arange(self.batch, dtype=torch.int32, device=self.pos_store.device)
        self.beam_src = rows[:, None].repeat(1, self.seq_len)
        self.num_beams = num_beams

    def write_rows(self, write_index, k, v, positions) -> None:
        """Row ``r``'s ``t`` new entries land at columns ``write_index[r] +
        [0..t)`` (quantized first under the int8 cache); targets outside
        ``[0, seq_len)`` go to the scratch row (dropped)."""
        b, t = positions.shape
        seq_len = self.seq_len
        n_kv = k.shape[2]
        cols = write_index.to(torch.long)[:, None] + torch.arange(t, device=k.device)[None, :]
        slots = torch.arange(b, device=k.device)[:, None] * seq_len + cols  # [b, t]
        slots = slots.masked_fill((cols < 0) | (cols >= seq_len), b * seq_len)
        self.pos_store.index_put_((slots,), positions.to(torch.int32))
        heads = torch.arange(n_kv, device=k.device)[:, None, None] * (b * seq_len)
        rows = (heads + slots).masked_fill(slots == b * seq_len, n_kv * b * seq_len)  # [h, b, t]
        for store, new in zip(self.stores, _kv_entries(self.quantized, k, v)):
            store.index_put_((rows,), new.permute(2, 0, 1, 3).to(store.dtype))

    def write_at(self, index: int, k, v, positions) -> None:
        """Every row's ``t`` new entries at columns ``index + [0..t)`` (the
        scalar-index write of a plain decode loop; the caller checks the
        range)."""
        t = positions.shape[1]
        for view, new in zip(self.heads(), _kv_entries(self.quantized, k, v)):
            view[:, :, index:index + t] = new.permute(2, 0, 1, 3)
        self.pos[:, index:index + t] = positions

    def read(self, block_table=None):
        """(key_heads, value_heads, pos, key_scale, value_scale): what
        :func:`decode_attention` reads, views of the storage (no copy);
        the scales are None for the bf16 cache."""
        k, v, *scales = self.heads()
        return (k, v, self.pos, *(scales or (None, None)))


class PagedKVCache(_KVStores):
    """One attention layer's block-paged decode cache (JAX's paged
    ``cached_key``/``cached_value``/``cached_pos`` of
    ``[kv_pool_blocks, kv_block_tokens, ...]``, and the int8 cache's
    ``cached_key_scale``/``cached_value_scale``): a pool of fixed-size
    blocks that rows address through a block table ``[batch,
    seq_len // kv_block_tokens]`` (-1 = unmapped).

    Storage is head-major: ``key_store``/``value_store``
    ``[kv_heads, n_blocks + 1, block_tokens, head_dim]`` (int8 under the
    int8 cache, with fp32 ``key_scale_store``/``value_scale_store`` of
    width 1 beside them), ``pos_store`` ``[n_blocks + 1, block_tokens]``.
    Block ``n_blocks`` is scratch: a write through an unmapped entry, or
    at a column beyond the table, lands there (JAX drops it out of range).
    :meth:`read` gathers each row's blocks along the block axis into a
    contiguous ``[kv_heads, batch, seq_len, width]`` (one copy per store,
    the gather itself) — the same layout the contiguous cache's read views
    have, so both layouts run the same batched products on the same
    strides.  :attr:`key`, :attr:`value` ([n_blocks, block_tokens,
    kv_heads, head_dim]) and :attr:`pos` are logical views without the
    scratch block.
    """

    def __init__(self, key_store: torch.Tensor, value_store: torch.Tensor,
                 pos_store: torch.Tensor, index: int = 0,
                 key_scale_store: Optional[torch.Tensor] = None,
                 value_scale_store: Optional[torch.Tensor] = None):
        self.key_store = key_store
        self.value_store = value_store
        self.key_scale_store = key_scale_store
        self.value_scale_store = value_scale_store
        self.pos_store = pos_store
        self.index = index

    @classmethod
    def empty(cls, config: TransformerConfig, device,
              kv_heads: Optional[int] = None) -> "PagedKVCache":
        n_kv = kv_heads or config.n_kv_heads or config.n_heads
        shape = (n_kv, config.kv_pool_blocks + 1, config.kv_block_tokens, config.head_dim)
        int8 = config.kv_cache_dtype == "int8"
        payload = torch.int8 if int8 else config.dtype
        scales = {f: torch.zeros(shape[:3] + (1,), dtype=torch.float32, device=device)
                  for f in _SCALE_FIELDS} if int8 else {}
        return cls(
            key_store=torch.zeros(shape, dtype=payload, device=device),
            value_store=torch.zeros(shape, dtype=payload, device=device),
            pos_store=torch.full(shape[1:3], -1, dtype=torch.int32, device=device),
            **scales,
        )

    @property
    def n_blocks(self) -> int:
        return self.pos_store.shape[0] - 1

    @property
    def block_tokens(self) -> int:
        return self.pos_store.shape[1]

    @property
    def key(self) -> torch.Tensor:
        return self.key_store[:, :-1].permute(1, 2, 0, 3)

    @property
    def value(self) -> torch.Tensor:
        return self.value_store[:, :-1].permute(1, 2, 0, 3)

    @property
    def pos(self) -> torch.Tensor:
        return self.pos_store[:-1]

    def write_rows(self, block_table, write_index, k, v, positions) -> None:
        """Row ``r``'s ``t`` new entries land at logical columns
        ``write_index[r] + [0..t)``, physically at ``table[r, col // bt] *
        bt + col % bt`` (quantized first under the int8 cache); unmapped
        entries and columns beyond the table go to the scratch block
        (dropped)."""
        t = positions.shape[1]
        bt = self.block_tokens
        cols = write_index.to(torch.long)[:, None] + torch.arange(t, device=k.device)[None, :]
        lblk = cols // bt
        ok = (cols >= 0) & (lblk < block_table.shape[1])
        phys = block_table.to(torch.long).gather(1, lblk.masked_fill(~ok, 0))
        phys = phys.masked_fill(~ok | (phys < 0), self.n_blocks)
        off = cols % bt
        self.pos_store[phys, off] = positions.to(torch.int32)
        for store, new in zip(self.stores, _kv_entries(self.quantized, k, v)):
            store[:, phys, off] = new.permute(2, 0, 1, 3).to(store.dtype)

    def read(self, block_table):
        """(key_heads, value_heads, pos, key_scale, value_scale) of each
        row's logical view: one gather per store along the block axis by
        the flattened table (unmapped entries gather block 0 and read
        position -1); the scales are None for the bf16 cache."""
        b, width = block_table.shape
        bt = self.block_tokens
        flat = block_table.to(torch.long).clamp(min=0).reshape(-1)
        n_kv = self.key_store.shape[0]
        k, v, *scales = [s.index_select(1, flat).view(n_kv, b, width * bt, s.shape[-1])
                         for s in self.stores]
        pos = self.pos_store.index_select(0, flat).view(b, width * bt)
        mapped = (block_table >= 0)[:, :, None].expand(b, width, bt).reshape(b, width * bt)
        return (k, v, pos.masked_fill(~mapped, -1), *(scales or (None, None)))


class Attention(nn.Module):
    """Self-attention, causal unless ``bidirectional`` (then decoding
    raises JAX's error).  MHA uses one fused QKV projection whose output
    holds ``[q | k | v]`` per head; GQA uses separate ``q`` and ``kv``
    projections.  The non-decode forward runs ``flash_attention`` (the
    bidirectional form: :func:`bidirectional_flash_attention`), ring or
    Ulysses attention, or ``causal_attention`` by ``attn_impl``; ``decode=True`` writes K/V into
    the layer's :class:`KVCache` (or, with ``block_table``, its
    :class:`PagedKVCache`) and reads the whole cache through
    ``decode_attention``.

    On ``mesh``'s model axis (size tp > 1) the projections in are
    column-parallel and ``out`` row-parallel: each rank runs
    ``n_heads // tp`` local heads (and ``n_kv // tp`` kv heads), whose rows
    of the dense weights are a contiguous block, the layout being per
    head.

    Under ``positional="rope"`` q and k are rotated after the projection
    and before the cache write and the attention (a cached K holds rope at
    its absolute position, as JAX's), at ``positions``: by default
    ``arange(S)``, offset by the seq coordinate times the local length under
    sequence parallelism, or in decode the cache index plus ``arange(t)``.

    ``attn_bias`` [1, n_heads, q, k] (T5's relative bias, computed once above
    the stack) is added to the scores of the xla and decode paths; on a
    model axis each rank takes its local heads' slice.  The flash, ring and
    Ulysses paths refuse it, in JAX's words."""

    def __init__(self, config: TransformerConfig, device=None, mesh=None):
        super().__init__()
        self.config = config
        cfg = config
        bound = model_axis(mesh, cfg.model_axis)
        tp = 1 if bound is None else bound[1]
        self.n_kv = cfg.n_kv_heads or cfg.n_heads
        if cfg.n_heads % tp != 0:
            raise ValueError(f"n_heads={cfg.n_heads} not divisible by tp={tp}")
        if self.n_kv % tp != 0 or cfg.n_heads % self.n_kv != 0:
            raise ValueError(
                f"n_kv_heads={self.n_kv} must divide n_heads={cfg.n_heads} and be "
                f"divisible by tp={tp}"
            )
        self.local_heads = cfg.n_heads // tp
        self.local_kv = self.n_kv // tp
        self.mesh = mesh

        def dense(i, o, style):
            return TPDense(i, o, style=style, axis_name=cfg.model_axis, use_bias=cfg.dense_bias,
                           dtype=cfg.dtype, device=device, mesh=mesh)

        if self.n_kv == cfg.n_heads:
            self.qkv = dense(cfg.d_model, 3 * cfg.d_model, "column")
        else:
            self.q = dense(cfg.d_model, cfg.n_heads * cfg.head_dim, "column")
            self.kv = dense(cfg.d_model, 2 * self.n_kv * cfg.head_dim, "column")
        self.out = dense(cfg.n_heads * cfg.head_dim, cfg.d_model, "row")

    def forward(self, x, positions=None, segment_ids=None, decode: bool = False,
                cache=None, write_index=None, block_table=None,
                dropout_gen: Optional[torch.Generator] = None, attn_bias=None) -> torch.Tensor:
        cfg = self.config
        if decode and cfg.bidirectional:
            raise NotImplementedError(
                "incremental decoding with bidirectional attention "
                "(encoders do not autoregress)"
            )
        if attn_bias is not None and self.local_heads != cfg.n_heads:
            # the model-level bias covers all heads; keep this rank's slice
            r = model_axis(self.mesh, cfg.model_axis)[2]
            attn_bias = attn_bias[:, r * self.local_heads:(r + 1) * self.local_heads]
        b, t = x.shape[:2]
        dh = cfg.head_dim
        with checkpoint_name("proj"):
            if self.n_kv == cfg.n_heads:
                q, k, v = self.qkv(x).view(b, t, self.local_heads, 3 * dh).split(dh, dim=-1)
            else:
                q = self.q(x).view(b, t, self.local_heads, dh)
                k, v = self.kv(x).view(b, t, self.local_kv, 2 * dh).split(dh, dim=-1)
        if decode and positions is None and cache is not None:
            positions = (cache.index + torch.arange(t, device=x.device)).expand(b, t)
        if cfg.positional == "rope":
            if positions is None:
                positions = torch.arange(t, device=x.device)
                if seq_parallel_active(cfg, self.mesh):
                    # seq-sharded: this rank's block of global positions
                    positions = positions + axis_group(self.mesh, cfg.seq_axis)[2] * t
                positions = positions.expand(b, t)
            # new contiguous q and k (v stays a view of the projection),
            # outside any checkpoint name, so the remat policies recompute
            # them; one set of tables for both
            cos, sin = rope_tables(positions, dh, cfg.rope_theta)
            q, k = rotate_pairs(q, cos, sin), rotate_pairs(k, cos, sin)
        if decode:
            if seq_parallel_active(cfg, self.mesh):
                raise NotImplementedError("incremental decoding under sequence parallelism")
            if segment_ids is not None:
                raise NotImplementedError(
                    "incremental decoding with packed sequences (segment_ids)"
                )
            if cache is None:
                raise ValueError("decode=True needs this layer's KVCache")
            idx = cache.index
            if cache.beam_src is not None and (write_index is not None
                                               or block_table is not None):
                raise NotImplementedError(
                    "lazy beam search writes at the shared scalar cache index of a "
                    "contiguous cache (no write_index, no paged cache)"
                )
            if isinstance(cache, PagedKVCache):
                if block_table is None or write_index is None:
                    raise ValueError(
                        "the paged KV cache needs block_table AND write_index (the "
                        "serving engine's block-allocator path is the only caller)"
                    )
                # logical column -> (physical block, offset) through the
                # row's table; unmapped entries and columns beyond the
                # table land in the scratch block
                cache.write_rows(block_table, write_index, k, v, positions)
            elif block_table is not None:
                raise ValueError("block_table needs the paged KV cache (PagedKVCache)")
            elif write_index is not None:
                # per-row slot writes (continuous batching): row r's tokens
                # land at write_index[r] + [0..t); out-of-range targets (a
                # pool's parked slots, a padded chunk's tail) are dropped
                cache.write_rows(write_index, k, v, positions)
            else:
                if idx + t > cfg.seq_len:
                    raise ValueError(
                        f"cache overflow: writing {t} tokens at slot {idx} of {cfg.seq_len}"
                    )
                cache.write_at(idx, k, v, positions)
            cache.index = idx + t
            # both layouts hand decode_attention a contiguous
            # [kv_heads, batch, seq_len, head_dim]: the contiguous cache's
            # views, or the paged cache's one gather per store
            k_heads, v_heads, k_pos, k_scale, v_scale = cache.read(block_table)
            if cache.beam_src is not None:
                # lazy beam search: every slot this step writes maps to the
                # writing row (the beam loop row-gathers the table by the
                # winners' parents after each top-k)
                cache.beam_src[:, idx:idx + t] = torch.arange(
                    b, dtype=cache.beam_src.dtype, device=x.device)[:, None]
                if k_scale is not None:
                    # the cross-beam read has no scale fold: a transient
                    # dequantized copy, as JAX keeps on this path
                    k_heads = (k_heads.float() * k_scale).to(cfg.dtype)
                    v_heads = (v_heads.float() * v_scale).to(cfg.dtype)
                out = beam_decode_attention(
                    q, k_heads, v_heads, positions, cache.beam_src, cache.num_beams,
                    window=cfg.attn_window, k_positions=k_pos, bias=attn_bias,
                )
            else:
                out = decode_attention(
                    q, k_heads, v_heads, positions, window=cfg.attn_window, k_positions=k_pos,
                    k_scale=k_scale, v_scale=v_scale, bias=attn_bias,
                )
        else:
            out = self._attend(q, k, v, segment_ids, attn_bias)
        with checkpoint_name("proj"):
            out = self.out(out.reshape(b, t, self.local_heads * dh))
        if dropout_gen is not None:
            out = dropout(out, cfg.dropout_rate, dropout_gen)
        return out

    def _attend(self, q, k, v, segment_ids, attn_bias=None):
        cfg = self.config
        if attn_bias is not None and cfg.attn_impl != "xla":
            # the flash, ring and ulysses kernels take no additive score bias
            raise NotImplementedError(
                f"attention score bias (positional='relative') under "
                f"attn_impl={cfg.attn_impl!r} — use attn_impl='xla'"
            )
        # the encoder's flash path is one non-causal chunk over the sequence
        flash = functools.partial(
            bidirectional_flash_attention if cfg.bidirectional else flash_attention,
            block_q=cfg.flash_block_q, block_k=cfg.flash_block_k, window=cfg.attn_window)
        # the flash, ring and ulysses paths route grouped queries natively
        if cfg.attn_impl == "flash":
            return flash(q, k, v, segment_ids=segment_ids)
        if cfg.attn_impl == "ring":
            # JAX's rule: the flash-composed ring on the accelerator, the
            # plain ring elsewhere; segment ids are the local chunk's and
            # rotate with their K/V
            ring = ring_flash_attention if q.is_cuda else ring_attention
            return ring(q, k, v, axis_name=cfg.seq_axis, mesh=self.mesh,
                        window=cfg.attn_window, segment_ids=segment_ids,
                        causal=not cfg.bidirectional)
        if cfg.attn_impl == "ulysses":
            # the inner attention sees the whole sequence: under "proj_attn"
            # the all-to-alls' outputs are kept with the kernel's
            with checkpoint_name("attn"):
                if segment_ids is not None:
                    segment_ids = gather_sequence(segment_ids, cfg.seq_axis, self.mesh)
                return ulysses_attention(q, k, v, axis_name=cfg.seq_axis, mesh=self.mesh,
                                         attn_fn=flash, segment_ids=segment_ids)
        group = q.shape[2] // k.shape[2]
        if group != 1:  # the dense path has no head routing: expand K/V
            k = k.repeat_interleave(group, dim=2)
            v = v.repeat_interleave(group, dim=2)
        return causal_attention(q, k, v, segment_ids=segment_ids, window=cfg.attn_window,
                                causal=not cfg.bidirectional, bias=attn_bias)


class MLP(nn.Module):
    """``down(act(up(x)))`` with act gelu (tanh form), gelu_exact or relu;
    or, gated, ``down(act(gate(x)) * up(x))`` with act silu (``swiglu``,
    Llama) or tanh-gelu (``geglu``), ``gate``, ``up`` and ``down``
    bias-free.  On ``mesh``'s model axis ``up`` (and ``gate``) are column
    layers and ``down`` a row layer (one forward all-reduce)."""

    def __init__(self, config: TransformerConfig, device=None, mesh=None):
        super().__init__()
        self.config = config
        self.gated = config.mlp in _GATED
        hidden = config.mlp_ratio * config.d_model
        kw = dict(axis_name=config.model_axis, use_bias=config.dense_bias and not self.gated,
                  dtype=config.dtype, device=device, mesh=mesh)
        if self.gated:
            self.gate = TPDense(config.d_model, hidden, style="column", **kw)
        self.up = TPDense(config.d_model, hidden, style="column", **kw)
        self.down = TPDense(hidden, config.d_model, style="row", **kw)

    def forward(self, x: torch.Tensor,
                dropout_gen: Optional[torch.Generator] = None) -> torch.Tensor:
        mlp = self.config.mlp
        if self.gated:
            with checkpoint_name("proj"):
                gate = self.gate(x)
                up = self.up(x)
            act = F.silu(gate) if mlp == "swiglu" else F.gelu(gate, approximate="tanh")
            h = act * up
        else:
            with checkpoint_name("proj"):
                h = self.up(x)
            if mlp == "relu":
                h = F.relu(h)
            else:
                h = F.gelu(h, approximate="tanh" if mlp == "gelu" else "none")
        with checkpoint_name("proj"):
            y = self.down(h)
        if dropout_gen is not None:
            y = dropout(y, self.config.dropout_rate, dropout_gen)
        return y


class Block(nn.Module):
    """Pre-norm block: x + attn(norm(x)); x + mlp(norm(x)); under
    ``prenorm=False`` post-norm (original BERT): norm(x + attn(x));
    norm(x + mlp(x)), each norm over the residual sum.  With a
    ``dropout_seed``, dropout runs after both sublayers, its masks drawn in
    that order from a generator on ``x``'s device seeded with it.  Under
    ``moe_experts`` > 0 the MLP is a :class:`~tpu_parallel_torch.models.moe.MoEMLP`
    named ``moe``.  Returns ``(x, balance)``: the MoE layer's load-balance
    value, None for a dense MLP."""

    def __init__(self, config: TransformerConfig, device=None, mesh=None):
        super().__init__()
        self.config = config
        self.norm_attn = make_norm(config, device)
        self.attn = Attention(config, device, mesh)
        self.norm_mlp = make_norm(config, device)
        if config.moe_experts > 0:
            self.moe = MoEMLP(config, device, mesh)
        else:
            self.mlp = MLP(config, device, mesh)

    def forward(self, x, positions=None, segment_ids=None, decode: bool = False,
                cache=None, write_index=None, block_table=None,
                dropout_seed: Optional[int] = None, attn_bias=None):
        cfg = self.config
        if decode and cfg.moe_experts > 0 and cfg.moe_router == "expert_choice":
            # EC routes over the whole token pool; a single-token decode
            # step degenerates to a dense all-expert mixture
            raise NotImplementedError(
                "incremental decoding with expert-choice routing "
                "(the routing pool collapses to one token per row)"
            )
        dtype = cfg.dtype
        gen = None
        if dropout_seed is not None:
            gen = torch.Generator(device=x.device).manual_seed(dropout_seed)
        attn_args = (positions, segment_ids, decode, cache, write_index, block_table)
        if not cfg.prenorm:
            x = self.norm_attn(x + self.attn(x, *attn_args, dropout_gen=gen,
                                             attn_bias=attn_bias)).to(dtype)
            y, balance = self._mlp(x, gen)
            return self.norm_mlp(x + y).to(dtype), balance
        x = x + self.attn(self.norm_attn(x).to(dtype), *attn_args, dropout_gen=gen,
                          attn_bias=attn_bias)
        y, balance = self._mlp(self.norm_mlp(x).to(dtype), gen)
        return x + y, balance

    def _mlp(self, h, gen):
        """(the MLP's output, the MoE balance or None)."""
        if self.config.moe_experts > 0:
            return self.moe(h, dropout_gen=gen)
        return self.mlp(h, dropout_gen=gen), None


class BlockStack(nn.Module):
    """``n_layers`` blocks named ``layer_{i}``, run in a plain loop; each
    block is checkpointed under ``config.remat`` when gradients are taken
    (never when decoding), as the JAX stack wraps it in ``nn.remat``.
    ``dropout_rng`` (a CPU generator; training only) gives each layer one
    dropout seed per call, drawn before any layer runs.  On ``mesh``'s
    model axis each block is tensor-parallel.  Under
    ``config.fsdp`` each block is sharded over the data axis of ``mesh``;
    its gather runs inside the checkpointed call, so the backward gathers
    again and no gathered weight is saved.

    ``layer_ids`` (a pipeline stage's layers) names the blocks by their
    GLOBAL indices, ``layer_{id}`` in the given order, so a pipe rank's
    parameter names are the one-device model's names for the layers it
    owns; ``chunk=j`` in :meth:`forward` runs only the ``j``-th of
    ``chunks`` equal runs of them (an interleaved rank's virtual stage).
    Decode caches are indexed by position in the stack.

    ``attn_bias`` (T5's relative bias, one for the whole stack) reaches
    every block's attention.  MoE blocks return a load-balance value each;
    ``moe_losses`` (a list) receives them in layer order.  The append happens here, outside the
    checkpointed call, so a recompute in the backward never records a
    layer twice."""

    def __init__(self, config: TransformerConfig, n_layers: int, device=None, mesh=None,
                 layer_ids: Optional[Sequence[int]] = None, chunks: int = 1):
        super().__init__()
        self.config = config
        self.layer_ids = list(range(n_layers)) if layer_ids is None else list(layer_ids)
        self.n_layers = len(self.layer_ids)
        if self.n_layers % chunks:
            raise ValueError(f"{self.n_layers} layers not divisible into {chunks} chunks")
        self.chunks = chunks
        for i in self.layer_ids:
            self.add_module(f"layer_{i}", maybe_shard(Block(config, device, mesh), config, mesh))

    def forward(self, x, positions=None, segment_ids=None, decode: bool = False,
                caches: Optional[List[KVCache]] = None, write_index=None,
                block_table=None, dropout_rng: Optional[torch.Generator] = None,
                chunk: Optional[int] = None, moe_losses: Optional[list] = None,
                attn_bias=None) -> torch.Tensor:
        remat = self.config.remat and not decode and torch.is_grad_enabled()
        kwargs = remat_kwargs_for(self.config) if remat else None
        positions_in_stack = range(self.n_layers)
        if chunk is not None:
            per = self.n_layers // self.chunks
            positions_in_stack = range(chunk * per, (chunk + 1) * per)
        seeds = [None] * len(positions_in_stack)
        if dropout_rng is not None:
            seeds = torch.randint(0, 2**62, (len(seeds),), generator=dropout_rng).tolist()
        for k, pos in enumerate(positions_in_stack):
            layer = getattr(self, f"layer_{self.layer_ids[pos]}")
            if remat:
                x, balance = checkpoint(layer, x, positions, segment_ids, False, None, None,
                                        None, seeds[k], attn_bias, **kwargs)
            else:
                cache = caches[pos] if caches is not None else None
                x, balance = layer(x, positions, segment_ids, decode, cache, write_index,
                                   block_table, dropout_seed=seeds[k], attn_bias=attn_bias)
            if balance is not None and moe_losses is not None:
                moe_losses.append(balance)
        return x


class Embedding(nn.Module):
    """Token plus learned positional embedding, in ``config.dtype``; the
    token embedding alone unless ``positional="learned"`` (rope rotates q
    and k inside :class:`Attention`, and there is no ``pos`` table).  Under
    ``embed_norm`` (BERT's embeddings.LayerNorm) the summed embedding goes
    through the fp32 norm ``norm`` and back to ``config.dtype``.

    Both lookups are flax's: a negative index ``i`` reads row ``i + rows``
    (ragged prefill's pad positions, -1, read the table's last row; the
    engine's parked sentinel token, -2, the vocabulary's next to last).
    Pads' outputs are never read as results, but under MoE every row
    claims expert capacity in token order, so a pad's hidden state decides
    which real tokens keep their slots.  The wrap is a ``where``, no host
    sync (the engine replays the lookup inside CUDA graphs).
    Without ``positions`` the local positions count from 0, or, under
    sequence parallelism on ``mesh``, from this rank's seq coordinate
    times the local length (its block of the table).
    """

    def __init__(self, config: TransformerConfig, device=None, mesh=None):
        super().__init__()
        self.config = config
        self.mesh = mesh
        self.tok = nn.Embedding(config.vocab_size, config.d_model,
                                dtype=config.dtype, device=device)
        if config.positional == "learned":
            self.pos = nn.Embedding(config.seq_len, config.d_model,
                                    dtype=config.dtype, device=device)
        if config.embed_norm:
            self.norm = make_norm(config, device)

    def forward(self, tokens, positions=None) -> torch.Tensor:
        cfg = self.config
        emb = self.tok(_wrap(tokens, cfg.vocab_size))
        if cfg.positional == "learned":
            if positions is None:
                positions = torch.arange(tokens.shape[1], device=tokens.device)
                if seq_parallel_active(cfg, self.mesh):
                    positions = positions + axis_group(self.mesh, cfg.seq_axis)[2] * \
                        tokens.shape[1]
                positions = positions.expand_as(tokens)
            emb = emb + self.pos(_wrap(positions, cfg.seq_len))
        if cfg.embed_norm:
            emb = self.norm(emb).to(cfg.dtype)
        return emb


def _wrap(index: torch.Tensor, size: int) -> torch.Tensor:
    """flax's lookup of a negative index: ``index + size``."""
    return torch.where(index < 0, index + size, index)

