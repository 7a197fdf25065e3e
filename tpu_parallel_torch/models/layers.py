"""Transformer building blocks: the port of ``tpu_parallel/models/layers.py``.

Single-device PyTorch modules with the JAX package's names and math:
matmul weights, biases and embeddings are held in ``config.dtype`` (what the
flax modules cast their fp32 params to at every use), LayerNorm computes and
holds its params in fp32, softmax runs in fp32.  Tensor, pipeline and
sequence parallelism are not in this slice.  Linear weights are PyTorch's
``[out, in]``; ``models/convert.py`` transposes flax's ``[in, out]`` kernels.

Activation checkpointing (``remat``/``remat_policy``) wraps each block in
``torch.utils.checkpoint``; the save policies keep the values the JAX layers
name with ``checkpoint_name`` (:func:`checkpoint_name` here).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from tpu_parallel_torch.ops.flash_attention import FLASH_FWD_OP, flash_attention

# (field, default, what setting it would need) — fields this slice does not
# implement; a config that sets one raises instead of silently ignoring it
_UNSUPPORTED = (
    ("positional", "learned", "rope / relative positions"),
    ("norm", "layernorm", "RMSNorm"),
    ("prenorm", True, "post-norm blocks"),
    ("embed_norm", False, "an embedding LayerNorm"),
    ("kv_cache_dtype", "bf16", "the int8 KV cache"),
    ("kv_block_tokens", 0, "the paged KV cache"),
    ("kv_pool_blocks", 0, "the paged KV cache"),
    ("beam_width", 0, "lazy beam search"),
    ("bidirectional", False, "bidirectional attention"),
    ("moe_experts", 0, "mixture of experts"),
    ("dropout_rate", 0.0, "dropout (training)"),
    ("fsdp", False, "FSDP"),
)
_MLPS = ("gelu", "gelu_exact", "relu")
_ATTN_IMPLS = ("xla", "flash")
# remat_policy -> the checkpoint names whose values the backward keeps
# ("full": none, so every block recomputes its whole forward)
_REMAT_SAVES = {"full": (), "proj": ("proj",), "proj_attn": ("proj", "attn")}


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """Architecture knobs, field for field as in the JAX package.

    ``dtype`` is a torch dtype.  Fields this slice does not implement raise
    when set to anything but their default.  ``remat`` checkpoints each block
    when gradients are taken; ``remat_policy`` chooses what the backward
    keeps: ``"full"`` nothing (the block's forward is recomputed), ``"proj"``
    the qkv/out/up/down projection outputs, ``"proj_attn"`` those and the
    attention output (the flash kernel's out and lse, or the xla path's
    context), so the backward never re-runs attention's forward.  ``"dots"``
    is not ported and raises when a checkpointed forward runs.  ``scan_*``,
    the mesh-axis names and ``num_microbatches`` are compile or
    parallelism knobs of the JAX package; they change nothing here.
    ``flash_block_q``/``flash_block_k`` stay for API parity: the CUDA
    kernels' tiles are their own constants.
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
        for field, default, needs in _UNSUPPORTED:
            if getattr(self, field) != default:
                raise NotImplementedError(
                    f"{field}={getattr(self, field)!r} needs {needs}, which the "
                    "PyTorch port does not have yet"
                )
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

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


class LayerNorm(nn.LayerNorm):
    """LayerNorm computed in fp32 with fp32 params; returns fp32 (the caller
    casts back to ``config.dtype``, as the JAX blocks do)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(
            x.float(), self.normalized_shape, self.weight, self.bias, self.eps
        )


def make_norm(config: TransformerConfig, device=None) -> LayerNorm:
    """fp32 LayerNorm of width ``d_model`` with ``config.norm_eps``."""
    return LayerNorm(
        config.d_model, eps=config.norm_eps, dtype=torch.float32, device=device
    )


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
    one of ``names`` (views excepted; the flash forward kernel counts as
    "attn"), recompute every other op."""

    def policy(ctx, op, *args, **kwargs):
        if op is FLASH_FWD_OP:
            name = "attn"
        else:
            name = None if op.is_view else _active.name
        return CheckpointPolicy.MUST_SAVE if name in names else CheckpointPolicy.PREFER_RECOMPUTE

    return policy


def remat_kwargs_for(config: TransformerConfig) -> dict:
    """``torch.utils.checkpoint`` kwargs for a block under
    ``config.remat_policy``."""
    policy = config.remat_policy
    if policy == "dots":
        raise NotImplementedError(
            "remat_policy='dots' (save every matmul output) is not in the port yet"
        )
    if policy not in _REMAT_SAVES:
        raise ValueError(f"remat_policy={policy!r}: expected one of {sorted(_REMAT_SAVES)}")
    kwargs = dict(use_reentrant=False)
    if _REMAT_SAVES[policy]:
        kwargs["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_only_these_names(*_REMAT_SAVES[policy])
        )
    return kwargs


@functools.lru_cache(maxsize=None)
def _inv_sqrt_head_dim(head_dim: int, dtype: torch.dtype) -> float:
    """1 / sqrt(head_dim) rounded through ``dtype`` as the JAX layers compute
    it; exact in ``dtype``, so ``q * scale`` rounds once."""
    root = torch.sqrt(torch.tensor(float(head_dim), dtype=torch.float32)).to(dtype)
    return (1.0 / root).item()


def causal_attention(q, k, v, *, segment_ids=None, window: int = 0,
                     causal: bool = True) -> torch.Tensor:
    """Reference attention on [batch, seq, heads, head_dim]: O(seq^2) scores
    in fp32, matmuls in the input dtype (the ``attn_impl="xla"`` path).
    ``causal=False`` is the bidirectional form; with ``window`` the band is
    then symmetric, |q - k| < window."""
    scale = _inv_sqrt_head_dim(q.shape[-1], q.dtype)
    scores = torch.einsum("bqhd,bkhd->bhqk", q * scale, k).float()
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


def decode_attention(q, k_all, v_all, positions, window: int = 0,
                     k_positions=None) -> torch.Tensor:
    """New queries against a whole KV cache, GQA-native.

    ``q`` [batch, new_len, heads, head_dim] at global ``positions``
    [batch, new_len]; ``k_all``/``v_all`` [batch, cache_len, kv_heads,
    head_dim].  ``k_positions`` [batch, cache_len] is the global position each
    slot holds (-1: empty, never attended); None means slot j holds position
    j.  A slot is visible when ``0 <= kp <= qp`` (and ``qp - kp < window``).
    """
    b, nq, h, head_dim = q.shape
    h_kv = k_all.shape[2]
    group = h // h_kv
    scale = _inv_sqrt_head_dim(head_dim, q.dtype)
    qg = (q * scale).reshape(b, nq, h_kv, group, head_dim)
    scores = torch.einsum("bqngd,bknd->bngqk", qg, k_all).float()
    if k_positions is None:
        k_positions = torch.arange(k_all.shape[1], device=q.device).expand(b, -1)
    kp = k_positions[:, None, None, None, :]
    qp = positions[:, None, None, :, None]
    mask = (kp >= 0) & (kp <= qp)
    if window:
        mask = mask & (qp - kp < window)
    scores = scores.masked_fill(~mask, torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bngqk,bknd->bqngd", probs, v_all)
    return out.reshape(b, nq, h, head_dim)


class KVCache:
    """One attention layer's contiguous decode cache (the JAX ``cache``
    collection's ``cached_key``/``cached_value``/``cached_pos``/
    ``cache_index``).  :class:`Attention` updates it IN PLACE, either at
    the scalar slot ``index`` (which it then advances) or, under
    ``write_index``, at each row's own column.

    Each buffer holds ``seq_len + 1`` columns.  The last one is a scratch
    column that no read sees: ``key``, ``value`` and ``pos`` are views of
    the first ``seq_len``.  A ``write_index`` target outside
    ``[0, seq_len)`` is redirected there, which is how the port drops it
    (JAX's scatter drops out-of-range targets; an out-of-range
    ``index_put_`` would raise, and clamping would overwrite a valid
    boundary column).  Buffers never move, so a captured CUDA graph can
    write them.
    """

    def __init__(self, key_buf: torch.Tensor, value_buf: torch.Tensor,
                 pos_buf: torch.Tensor, index: int = 0):
        self.key_buf = key_buf  # [batch, seq_len + 1, kv_heads, head_dim]
        self.value_buf = value_buf
        self.pos_buf = pos_buf  # [batch, seq_len + 1] int32; -1 = empty slot
        self.index = index

    @property
    def seq_len(self) -> int:
        return self.pos_buf.shape[1] - 1

    @property
    def key(self) -> torch.Tensor:
        return self.key_buf[:, :-1]

    @property
    def value(self) -> torch.Tensor:
        return self.value_buf[:, :-1]

    @property
    def pos(self) -> torch.Tensor:
        return self.pos_buf[:, :-1]

    @classmethod
    def empty(cls, config: TransformerConfig, batch: int, device) -> "KVCache":
        n_kv = config.n_kv_heads or config.n_heads
        shape = (batch, config.seq_len + 1, n_kv, config.head_dim)
        return cls(
            key_buf=torch.zeros(shape, dtype=config.dtype, device=device),
            value_buf=torch.zeros(shape, dtype=config.dtype, device=device),
            pos_buf=torch.full((batch, config.seq_len + 1), -1, dtype=torch.int32,
                               device=device),
        )

    def write_rows(self, write_index, k, v, positions) -> None:
        """Row ``r``'s ``t`` new entries land at columns ``write_index[r] +
        [0..t)``; targets outside ``[0, seq_len)`` go to the scratch
        column (dropped)."""
        b, t = positions.shape
        seq_len = self.seq_len
        cols = write_index.to(torch.long)[:, None] + torch.arange(t, device=k.device)[None, :]
        cols = cols.masked_fill((cols < 0) | (cols >= seq_len), seq_len)
        rows = torch.arange(b, device=k.device)[:, None].expand(b, t)
        self.key_buf.index_put_((rows, cols), k.to(self.key_buf.dtype))
        self.value_buf.index_put_((rows, cols), v.to(self.value_buf.dtype))
        self.pos_buf.index_put_((rows, cols), positions.to(torch.int32))


class Attention(nn.Module):
    """Causal self-attention.  MHA uses one fused QKV projection whose output
    holds ``[q | k | v]`` per head; GQA uses separate ``q`` and ``kv``
    projections.  The non-decode forward runs ``flash_attention`` or
    ``causal_attention`` by ``attn_impl``; ``decode=True`` writes K/V into
    the layer's :class:`KVCache` and reads the whole cache through
    ``decode_attention``."""

    def __init__(self, config: TransformerConfig, device=None):
        super().__init__()
        self.config = config
        cfg = config
        self.n_kv = cfg.n_kv_heads or cfg.n_heads
        linear = lambda i, o: nn.Linear(
            i, o, bias=cfg.dense_bias, dtype=cfg.dtype, device=device
        )
        if self.n_kv == cfg.n_heads:
            self.qkv = linear(cfg.d_model, 3 * cfg.d_model)
        else:
            self.q = linear(cfg.d_model, cfg.n_heads * cfg.head_dim)
            self.kv = linear(cfg.d_model, 2 * self.n_kv * cfg.head_dim)
        self.out = linear(cfg.n_heads * cfg.head_dim, cfg.d_model)

    def forward(self, x, positions=None, segment_ids=None, decode: bool = False,
                cache: Optional[KVCache] = None, write_index=None) -> torch.Tensor:
        cfg = self.config
        b, t = x.shape[:2]
        dh = cfg.head_dim
        with checkpoint_name("proj"):
            if self.n_kv == cfg.n_heads:
                q, k, v = self.qkv(x).view(b, t, cfg.n_heads, 3 * dh).split(dh, dim=-1)
            else:
                q = self.q(x).view(b, t, cfg.n_heads, dh)
                k, v = self.kv(x).view(b, t, self.n_kv, 2 * dh).split(dh, dim=-1)
        if decode:
            if segment_ids is not None:
                raise NotImplementedError(
                    "incremental decoding with packed sequences (segment_ids)"
                )
            if cache is None:
                raise ValueError("decode=True needs this layer's KVCache")
            idx = cache.index
            if positions is None:
                positions = (idx + torch.arange(t, device=x.device)).expand(b, t)
            if write_index is not None:
                # per-row slot writes (continuous batching): row r's tokens
                # land at write_index[r] + [0..t); out-of-range targets (a
                # pool's parked slots, a padded chunk's tail) are dropped
                cache.write_rows(write_index, k, v, positions)
            else:
                if idx + t > cfg.seq_len:
                    raise ValueError(
                        f"cache overflow: writing {t} tokens at slot {idx} of {cfg.seq_len}"
                    )
                cache.key[:, idx:idx + t] = k
                cache.value[:, idx:idx + t] = v
                cache.pos[:, idx:idx + t] = positions
            cache.index = idx + t
            out = decode_attention(
                q, cache.key, cache.value, positions, window=cfg.attn_window,
                k_positions=cache.pos,
            )
        else:
            out = self._attend(q, k, v, segment_ids)
        with checkpoint_name("proj"):
            return self.out(out.reshape(b, t, cfg.n_heads * dh))

    def _attend(self, q, k, v, segment_ids):
        cfg = self.config
        if cfg.attn_impl == "flash":
            return flash_attention(
                q, k, v, segment_ids=segment_ids, block_q=cfg.flash_block_q,
                block_k=cfg.flash_block_k, window=cfg.attn_window,
            )
        group = q.shape[2] // k.shape[2]
        if group != 1:  # the dense path has no head routing: expand K/V
            k = k.repeat_interleave(group, dim=2)
            v = v.repeat_interleave(group, dim=2)
        return causal_attention(q, k, v, segment_ids=segment_ids, window=cfg.attn_window)


class MLP(nn.Module):
    """``down(act(up(x)))`` with act gelu (tanh form), gelu_exact or relu."""

    def __init__(self, config: TransformerConfig, device=None):
        super().__init__()
        self.config = config
        hidden = config.mlp_ratio * config.d_model
        self.up = nn.Linear(config.d_model, hidden, bias=config.dense_bias,
                            dtype=config.dtype, device=device)
        self.down = nn.Linear(hidden, config.d_model, bias=config.dense_bias,
                              dtype=config.dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with checkpoint_name("proj"):
            h = self.up(x)
        if self.config.mlp == "relu":
            h = F.relu(h)
        else:
            h = F.gelu(h, approximate="tanh" if self.config.mlp == "gelu" else "none")
        with checkpoint_name("proj"):
            return self.down(h)


class Block(nn.Module):
    """Pre-norm block: x + attn(norm(x)); x + mlp(norm(x))."""

    def __init__(self, config: TransformerConfig, device=None):
        super().__init__()
        self.config = config
        self.norm_attn = make_norm(config, device)
        self.attn = Attention(config, device)
        self.norm_mlp = make_norm(config, device)
        self.mlp = MLP(config, device)

    def forward(self, x, positions=None, segment_ids=None, decode: bool = False,
                cache: Optional[KVCache] = None, write_index=None) -> torch.Tensor:
        dtype = self.config.dtype
        h = self.norm_attn(x).to(dtype)
        x = x + self.attn(h, positions, segment_ids, decode, cache, write_index)
        h = self.norm_mlp(x).to(dtype)
        return x + self.mlp(h)


class BlockStack(nn.Module):
    """``n_layers`` blocks named ``layer_{i}``, run in a plain loop; each
    block is checkpointed under ``config.remat`` when gradients are taken
    (never when decoding), as the JAX stack wraps it in ``nn.remat``."""

    def __init__(self, config: TransformerConfig, n_layers: int, device=None):
        super().__init__()
        self.config = config
        self.n_layers = n_layers
        for i in range(n_layers):
            self.add_module(f"layer_{i}", Block(config, device))

    def forward(self, x, positions=None, segment_ids=None, decode: bool = False,
                caches: Optional[List[KVCache]] = None, write_index=None) -> torch.Tensor:
        remat = self.config.remat and not decode and torch.is_grad_enabled()
        kwargs = remat_kwargs_for(self.config) if remat else None
        for i in range(self.n_layers):
            layer = getattr(self, f"layer_{i}")
            if remat:
                x = checkpoint(layer, x, positions, segment_ids, **kwargs)
            else:
                cache = caches[i] if caches is not None else None
                x = layer(x, positions, segment_ids, decode, cache, write_index)
        return x


class Embedding(nn.Module):
    """Token plus learned positional embedding, in ``config.dtype``.

    Pad positions are -1 in ragged prefill; they are clamped to row 0 (the
    flax lookup wraps them instead).  Their outputs are never read.
    """

    def __init__(self, config: TransformerConfig, device=None):
        super().__init__()
        self.tok = nn.Embedding(config.vocab_size, config.d_model,
                                dtype=config.dtype, device=device)
        self.pos = nn.Embedding(config.seq_len, config.d_model,
                                dtype=config.dtype, device=device)

    def forward(self, tokens, positions=None) -> torch.Tensor:
        if positions is None:
            positions = torch.arange(tokens.shape[1], device=tokens.device).expand_as(tokens)
        return self.tok(tokens) + self.pos(positions.clamp(min=0))

