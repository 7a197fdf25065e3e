"""Weights for the port: a seeded init, and the bridge from a JAX tree.

:func:`params_from_jax` turns the parameter tree that the JAX package's
``GPTLM.init`` gives (nested dicts of arrays; scanned ``blocks/layers/block``
with a leading ``[n_layers]`` axis, or unrolled ``blocks/layer_{i}``) into
the port's state dict.  Flax kernels are ``[in, out]``; PyTorch ``Linear``
weights are ``[out, in]``.  A tree initialized under a mesh with a model
axis holds each tensor-parallel leaf under ``.../shard/sharded/...``,
stacked ``[tp, ...]`` (after the ``[n_layers]`` axis when scanned; the
``nn.Partitioned`` boxes unwrapped to their global arrays): the function
returns rank r's slice (``model_rank=r``) or the full weights.  It raises
on a missing leaf, an extra leaf or a shape that does not match.
A tree initialized over a pipe axis holds the blocks under
``pipeline/stage/sharded/`` (``chunk{j}/`` per virtual stage under
interleave), stacked ``[pipe, ...]`` (then ``[layers per chunk]`` when
scanned); rank ``r``'s virtual stage ``j`` is global chunk ``j * pipe + r``.
``pipe_rank=r`` returns that rank's layers under their global names, the
default every layer.  An MoE block's router and expert stacks come
across as ``moe.router.weight`` and ``moe.experts.{up,down}.{kernel,bias}``
(flax's ``[E, in, out]`` layout kept), from the one-device
``moe/experts/...`` or expert parallelism's ``moe/experts/sharded/...``
stacked ``[ep, E / ep, ...]`` (``model_rank`` as for tensor-parallel
leaves).  The Llama family's trees come across as JAX holds them: an
RMSNorm's ``scale`` without a bias, the gated MLP's bias-free
``mlp/{gate,up,down}`` (swiglu experts: ``moe/experts/{gate,up}``
without biases), and no ``embed/pos`` under rope.  The encoder family's
too: ``embed/norm`` under ``embed_norm``, no ``norm_final`` in a post-norm
stack, and ``EncoderClassifier``'s tree (``encoder/...`` without an
lm_head, ``pooler``, ``classifier``).  A ``GPTLM`` with the relative bias
has ``rel_bias/rel_embedding``.  An ``EncoderDecoder``'s tree (a
``Seq2SeqConfig``) has ``embed``, the two stacks ``encoder/`` (blocks as
the LM's) and ``decoder/`` (``self_attn``, ``cross_attn`` with its
``q`` and per-head interleaved ``kv``, ``norm_self``, ``norm_cross``,
``norm_mlp``, the MLP or the experts), ``enc_norm``, ``dec_norm``, the
lm_head and, under the relative bias, ``enc_rel_bias`` / ``dec_rel_bias``;
each stack scanned or unrolled, its mesh layout stacked as the LM's and
its pipe layout under ``encoder/stage/sharded/`` and
``decoder/stage/sharded/``.  Nothing here imports
JAX: leaves are read with ``numpy.asarray`` (torch leaves, bf16 ones
too, through fp32).
:func:`params_to_jax` is its exact inverse (from one state dict, or from
every model rank's for the stacked mesh layout), so the port builds the
JAX layout's tree (for ``models/quantize.py`` and its ``.npz`` files)
without JAX.

:func:`init_params` draws the port's own weights from a seed, with flax's
default distributions, so the model runs realistic activations without JAX.

Both bridges also take the MLP classifier's tree (``hidden_{i}/kernel|bias``
and ``head/kernel|bias``) when ``config`` is an ``MLPConfig``.
"""

from __future__ import annotations

import dataclasses
import math
import zlib
from typing import Dict, Iterator, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

# leaf of one block: (JAX path inside the block, port key inside the block,
# transposed?)
_MHA = (("attn/qkv/shard/kernel", "attn.qkv.weight", True),
        ("attn/qkv/shard/bias", "attn.qkv.bias", False))
_GQA = (("attn/q/shard/kernel", "attn.q.weight", True),
        ("attn/q/shard/bias", "attn.q.bias", False),
        ("attn/kv/shard/kernel", "attn.kv.weight", True),
        ("attn/kv/shard/bias", "attn.kv.bias", False))
_ATTN_OUT = (
    ("attn/out/shard/kernel", "attn.out.weight", True),
    ("attn/out/bias", "attn.out.bias", False),
)
_MLP = (
    ("mlp/up/shard/kernel", "mlp.up.weight", True),
    ("mlp/up/shard/bias", "mlp.up.bias", False),
    ("mlp/down/shard/kernel", "mlp.down.weight", True),
    ("mlp/down/bias", "mlp.down.bias", False),
)
# the gated MLP (swiglu, geglu): three bias-free products
_GATED_MLP = (
    ("mlp/gate/shard/kernel", "mlp.gate.weight", True),
    ("mlp/up/shard/kernel", "mlp.up.weight", True),
    ("mlp/down/shard/kernel", "mlp.down.weight", True),
)
# an MoE block's MLP: the fp32 router (a Linear) and the expert stacks,
# kept in flax's [E, in, out] layout (biases whatever dense_bias says, as
# JAX's ExpertFFN); under expert parallelism the stacks stand under
# experts/sharded, [ep, E / ep, ...]
_MOE = (
    ("moe/router/kernel", "moe.router.weight", True),
    ("moe/experts/up/kernel", "moe.experts.up.kernel", False),
    ("moe/experts/up/bias", "moe.experts.up.bias", False),
    ("moe/experts/down/kernel", "moe.experts.down.kernel", False),
    ("moe/experts/down/bias", "moe.experts.down.bias", False),
)
# swiglu experts: bias-free gate and up, down with its bias (JAX's ExpertFFN)
_SWIGLU_MOE = (
    ("moe/router/kernel", "moe.router.weight", True),
    ("moe/experts/gate/kernel", "moe.experts.gate.kernel", False),
    ("moe/experts/up/kernel", "moe.experts.up.kernel", False),
    ("moe/experts/down/kernel", "moe.experts.down.kernel", False),
    ("moe/experts/down/bias", "moe.experts.down.bias", False),
)
_NORMS = (
    ("norm_attn/scale", "norm_attn.weight", False),
    ("norm_attn/bias", "norm_attn.bias", False),
    ("norm_mlp/scale", "norm_mlp.weight", False),
    ("norm_mlp/bias", "norm_mlp.bias", False),
)
_TOP = (
    ("embed/tok/embedding", "embed.tok.weight", False),
    ("embed/pos/embedding", "embed.pos.weight", False),
    ("embed/norm/scale", "embed.norm.weight", False),
    ("embed/norm/bias", "embed.norm.bias", False),
    ("rel_bias/rel_embedding", "rel_bias.rel_embedding", False),
    ("norm_final/scale", "norm_final.weight", False),
    ("norm_final/bias", "norm_final.bias", False),
    ("lm_head/shard/kernel", "lm_head.weight", True),
)
# a scanned GPTLM's block leaves (a _Stack's jax prefix + "layers/block/")
_SCANNED = "blocks/layers/block/"
# an EncoderClassifier: its trunk's keys under "encoder." (JAX's
# "encoder/" subtree, a GPTLM without an lm_head), then its own leaves
_ENCODER = "encoder."
_CLASSIFIER = (
    ("pooler/kernel", "pooler.weight", True),
    ("pooler/bias", "pooler.bias", False),
    ("classifier/kernel", "classifier.weight", True),
    ("classifier/bias", "classifier.bias", False),
)
# ModuleShard's scope: a tensor-parallel leaf's per-rank stack, and the
# expert stacks' under expert parallelism
_SHARD, _STACKED = "/shard/", "/shard/sharded/"
_EXPERTS, _EXPERTS_STACKED = "moe/experts/", "moe/experts/sharded/"
# stacked leaves split along flax's axis 0: row-parallel Linear weights
# (their input) and the expert stacks (the experts); every other stacked
# leaf splits its output
_ROW = ("attn.out.weight", "mlp.down.weight")
_AXIS0 = _ROW + tuple(key for _, key, _ in _MOE[1:]) + ("moe.experts.gate.kernel",)


def _stacked_path(path: str) -> str:
    """A leaf's path in the mesh layout (its per-rank stack)."""
    if _EXPERTS in path:
        return path.replace(_EXPERTS, _EXPERTS_STACKED)
    return path.replace(_SHARD, _STACKED)
# PipelineModule's scope: a pipe rank's stage, stacked over the pipe axis
_PIPE = "pipeline/stage/sharded/"


def _chunk_layers(config) -> int:
    return config.n_layers // (config.pipe_size * config.pipe_interleave)


def _global_layer(config, rank: int, chunk: int, k: int) -> int:
    """Rank ``rank``'s virtual stage ``chunk``'s ``k``-th layer: global
    chunk ``chunk * pipe_size + rank``."""
    return (chunk * config.pipe_size + rank) * _chunk_layers(config) + k


def _unpipe(flat: Dict[str, object], config, pipe_prefix: str = _PIPE,
            out_prefix: str = "blocks/") -> Dict[str, object]:
    """A flat pipe-layout tree as the unrolled one-stage layout
    (``out_prefix + layer_{i}/...``, the pipe and scan axes taken off) for
    the stack under ``pipe_prefix`` of ``config.n_layers`` layers.  The
    pipe degree and the virtual stages are read off the tree, so a
    one-stage ``config`` takes a pipeline tree's full weights."""
    piped = {p: v for p, v in flat.items() if p.startswith(pipe_prefix)}
    if not piped:
        return flat
    chunks = {p[len(pipe_prefix):].split("/", 1)[0] for p in piped}
    interleave = len(chunks) if all(c.startswith("chunk") for c in chunks) else 1
    n = _as_float32(next(iter(piped.values()))).shape[0]
    if config.pipe_size > 1 and (n, interleave) != (config.pipe_size, config.pipe_interleave):
        raise ValueError(f"a pipeline tree of {n} stages x {interleave} chunks, the config's "
                         f"is {config.pipe_size} x {config.pipe_interleave}")
    if config.n_layers % (n * interleave):
        raise ValueError(f"n_layers={config.n_layers} not divisible by the tree's "
                         f"{n} x {interleave} chunks")
    layout = dataclasses.replace(config, pipe_size=n, pipe_interleave=interleave)
    per = _chunk_layers(layout)
    out = {p: v for p, v in flat.items() if p not in piped}
    for path, leaf in piped.items():
        rest, chunk = path[len(pipe_prefix):], 0
        if interleave > 1:
            head, rest = rest.split("/", 1)
            chunk = int(head[len("chunk"):])
        arr = _as_float32(leaf)
        if arr.shape[0] != n:
            raise ValueError(f"{path}: leaf {arr.shape} lacks the [pipe={n}] axis")
        for r in range(n):
            if rest.startswith("layers/block/"):
                if arr.shape[1] != per:
                    raise ValueError(f"{path}: scanned leaf {arr.shape} lacks the "
                                     f"[{per} layers] axis")
                for k in range(per):
                    out[f"{out_prefix}layer_{_global_layer(layout, r, chunk, k)}/"
                        f"{rest[len('layers/block/'):]}"] = arr[r, k]
            else:
                head, block_path = rest.split("/", 1)
                k = int(head[len("layer_"):])
                out[f"{out_prefix}layer_{_global_layer(layout, r, chunk, k)}/{block_path}"] = \
                    arr[r]
    return out


def _rmsnorm(config) -> bool:
    return getattr(config, "norm", "layernorm") == "rmsnorm"


def _top_leaves(config, head: bool = True) -> Tuple[Tuple[str, str, bool], ...]:
    """The leaves outside the blocks: no ``pos`` table unless the positions
    are learned, an embedding norm only under ``embed_norm``, no
    ``norm_final`` in a post-norm stack, no norm bias under RMSNorm, no
    lm_head in an ``EncoderClassifier``'s trunk (``head=False``)."""
    def kept(key):
        if key == "embed.pos.weight":
            return getattr(config, "positional", "learned") == "learned"
        if key == "rel_bias.rel_embedding":
            return getattr(config, "positional", "learned") == "relative"
        if key.startswith("embed.norm."):
            return getattr(config, "embed_norm", False) and not (
                key.endswith(".bias") and _rmsnorm(config))
        if key.startswith("norm_final."):
            return getattr(config, "prenorm", True) and not (
                key.endswith(".bias") and _rmsnorm(config))
        return head or key != "lm_head.weight"

    return tuple(leaf for leaf in _TOP if kept(leaf[1]))


def _block_leaves(config) -> Tuple[Tuple[str, str, bool], ...]:
    n_kv = config.n_kv_heads or config.n_heads
    swiglu = config.mlp == "swiglu"
    if getattr(config, "moe_experts", 0) > 0:
        mlp = _SWIGLU_MOE if swiglu else _MOE
    else:
        mlp = _GATED_MLP if config.mlp in ("swiglu", "geglu") else _MLP
    norms = tuple(leaf for leaf in _NORMS if not (_rmsnorm(config) and leaf[1].endswith(".bias")))
    leaves = (_MHA if n_kv == config.n_heads else _GQA) + _ATTN_OUT + mlp + norms
    if not config.dense_bias:
        leaves = tuple(leaf for leaf in leaves if leaf[1].endswith(".weight")
                       or leaf[0].startswith(("norm_", "moe/")))
    return leaves


# the encoder-decoder's leaves outside its stacks
_S2S_TOP = (
    ("embed/tok/embedding", "embed.tok.weight", False),
    ("embed/pos/embedding", "embed.pos.weight", False),
    ("enc_rel_bias/rel_embedding", "enc_rel_bias.rel_embedding", False),
    ("dec_rel_bias/rel_embedding", "dec_rel_bias.rel_embedding", False),
    ("enc_norm/scale", "enc_norm.weight", False),
    ("enc_norm/bias", "enc_norm.bias", False),
    ("dec_norm/scale", "dec_norm.weight", False),
    ("dec_norm/bias", "dec_norm.bias", False),
    ("lm_head/shard/kernel", "lm_head.weight", True),
)
# a decoder block's cross-attention and its norm
_CROSS = (
    ("cross_attn/q/shard/kernel", "cross_attn.q.weight", True),
    ("cross_attn/q/shard/bias", "cross_attn.q.bias", False),
    ("cross_attn/kv/shard/kernel", "cross_attn.kv.weight", True),
    ("cross_attn/kv/shard/bias", "cross_attn.kv.bias", False),
    ("cross_attn/out/shard/kernel", "cross_attn.out.weight", True),
    ("cross_attn/out/bias", "cross_attn.out.bias", False),
    ("norm_cross/scale", "norm_cross.weight", False),
    ("norm_cross/bias", "norm_cross.bias", False),
)


def _is_seq2seq(config) -> bool:
    return hasattr(config, "encoder_layers")


def _s2s_top_leaves(config) -> Tuple[Tuple[str, str, bool], ...]:
    """The encoder-decoder's leaves outside its stacks: the position table
    under learned positions, the two bias tables under relative ones, no
    norm bias under RMSNorm."""
    positional = config.positional

    def kept(key):
        if key == "embed.pos.weight":
            return positional == "learned"
        if key.endswith("rel_embedding"):
            return positional == "relative"
        return not (key.endswith("norm.bias") and _rmsnorm(config))

    return tuple(leaf for leaf in _S2S_TOP if kept(leaf[1]))


def _decoder_leaves(config) -> Tuple[Tuple[str, str, bool], ...]:
    """A decoder block's leaves: the encoder block's with ``attn`` named
    ``self_attn`` and ``norm_attn`` named ``norm_self``, then the
    cross-attention's and ``norm_cross``."""
    def rename(path, key):
        if path.startswith("attn/"):
            return "self_" + path, "self_" + key
        if path.startswith("norm_attn/"):
            return path.replace("norm_attn", "norm_self"), key.replace("norm_attn", "norm_self")
        return path, key

    cross = tuple(leaf for leaf in _CROSS
                  if not (_rmsnorm(config) and leaf[0].startswith("norm_")
                          and leaf[1].endswith(".bias"))
                  and (config.dense_bias or leaf[1].endswith(".weight")
                       or leaf[0].startswith("norm_")))
    return tuple((*rename(p, k), t) for p, k, t in _block_leaves(config)) + cross


@dataclasses.dataclass(frozen=True)
class _Stack:
    """One stack of a model's tree: its JAX prefix (``blocks/``,
    ``encoder/``), its pipe-layout prefix, its port prefix, its block
    leaves and the config whose ``n_layers`` is its depth."""

    jax: str
    pipe: str
    port: str
    leaves: Tuple[Tuple[str, str, bool], ...]
    config: object


def _stacks(config) -> Tuple[_Stack, ...]:
    if not _is_seq2seq(config):
        return (_Stack("blocks/", _PIPE, "blocks.", _block_leaves(config), config),)
    enc = dataclasses.replace(config, n_layers=config.encoder_layers)
    return (_Stack("encoder/", "encoder/stage/sharded/", "encoder.", _block_leaves(enc), enc),
            _Stack("decoder/", "decoder/stage/sharded/", "decoder.", _decoder_leaves(config),
                   config))


def _block_shapes(config) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """``{key inside a block: (shape, dtype)}`` of every leaf a block may
    hold (an encoder-decoder's decoder blocks' too)."""
    d, dh, h = config.d_model, config.head_dim, config.n_heads
    n_kv = config.n_kv_heads or h
    hidden = config.mlp_ratio * d
    dt, f32 = config.dtype, torch.float32
    attn = {
        "attn.qkv.weight": ((3 * d, d), dt), "attn.qkv.bias": ((3 * d,), dt),
        "attn.q.weight": ((h * dh, d), dt), "attn.q.bias": ((h * dh,), dt),
        "attn.kv.weight": ((2 * n_kv * dh, d), dt), "attn.kv.bias": ((2 * n_kv * dh,), dt),
        "attn.out.weight": ((d, h * dh), dt), "attn.out.bias": ((d,), dt),
    }
    block = dict(attn)
    block.update({"self_" + k: v for k, v in attn.items()})
    block.update({"cross_" + k: v for k, v in attn.items()})
    block.update({
        "mlp.gate.weight": ((hidden, d), dt),
        "mlp.up.weight": ((hidden, d), dt), "mlp.up.bias": ((hidden,), dt),
        "mlp.down.weight": ((d, hidden), dt), "mlp.down.bias": ((d,), dt),
    })
    for norm in ("norm_attn", "norm_mlp", "norm_self", "norm_cross"):
        block.update({f"{norm}.weight": ((d,), f32), f"{norm}.bias": ((d,), f32)})
    e = getattr(config, "moe_experts", 0)
    block.update({
        "moe.router.weight": ((e, d), f32),
        "moe.experts.gate.kernel": ((e, d, hidden), dt),
        "moe.experts.up.kernel": ((e, d, hidden), dt), "moe.experts.up.bias": ((e, hidden), dt),
        "moe.experts.down.kernel": ((e, hidden, d), dt), "moe.experts.down.bias": ((e, d), dt),
    })
    return block


def state_shapes(config, head: bool = True) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """``{port key: (shape, dtype)}`` of the port's GPTLM (or
    ``EncoderDecoder``) state dict (``head=False``: without the lm_head)."""
    d, dt, f32 = config.d_model, config.dtype, torch.float32
    rows = config.seq_len
    if _is_seq2seq(config):
        rows = max(config.seq_len, config.source_len)
    top = {
        "embed.tok.weight": ((config.vocab_size, d), dt),
        "embed.pos.weight": ((rows, d), dt),
        "embed.norm.weight": ((d,), f32),
        "embed.norm.bias": ((d,), f32),
        "lm_head.weight": ((config.vocab_size, d), dt),
    }
    for name in ("rel_bias", "enc_rel_bias", "dec_rel_bias"):
        top[f"{name}.rel_embedding"] = ((config.rel_num_buckets, config.n_heads), f32)
    for name in ("norm_final", "enc_norm", "dec_norm"):
        top.update({f"{name}.weight": ((d,), f32), f"{name}.bias": ((d,), f32)})
    leaves = _s2s_top_leaves(config) if _is_seq2seq(config) else _top_leaves(config, head)
    kept = [key for _, key, _ in leaves]
    shapes = {k: top[k] for k in kept if k.startswith(("embed.", "rel_bias.", "enc_rel_bias.",
                                                         "dec_rel_bias."))}
    block = _block_shapes(config)
    for stack in _stacks(config):
        for i in range(stack.config.n_layers):
            for _, key, _ in stack.leaves:
                shapes[f"{stack.port}layer_{i}.{key}"] = block[key]
    shapes.update({k: top[k] for k in kept if k not in shapes})
    return shapes


def _flatten(tree: Mapping, prefix: str = "") -> Iterator[Tuple[str, object]]:
    for name, value in tree.items():
        path = f"{prefix}{name}"
        if isinstance(value, Mapping):
            yield from _flatten(value, path + "/")
        else:
            yield path, value


def _as_float32(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().float().numpy()
    return np.asarray(leaf, dtype=np.float32)


def _is_mlp(config) -> bool:
    return hasattr(config, "num_classes") and hasattr(config, "num_hidden_layers")


def _mlp_from_jax(tree: Mapping, config, dtype=None) -> Dict[str, torch.Tensor]:
    """The ``MLPClassifier`` state dict from a JAX ``MLPClassifier`` tree;
    the input width is read from ``hidden_0/kernel`` (flax infers it)."""
    flat = dict(_flatten(tree))
    layers = [f"hidden_{i}" for i in range(config.num_hidden_layers)] + ["head"]
    wanted = [f"{name}/{leaf}" for name in layers for leaf in ("kernel", "bias")]
    missing = sorted(set(wanted) - set(flat))
    if missing:
        raise KeyError(f"JAX parameter tree lacks {missing}")
    extra = sorted(set(flat) - set(wanted))
    if extra:
        raise ValueError(f"JAX parameter tree has leaves the port does not: {extra}")
    width = _as_float32(flat[wanted[0]]).shape[0]
    state = {}
    for name in layers:
        out = config.num_classes if name == "head" else config.hidden_size
        kernel, bias = _as_float32(flat[f"{name}/kernel"]), _as_float32(flat[f"{name}/bias"])
        if kernel.shape != (width, out) or bias.shape != (out,):
            raise ValueError(f"{name}: kernel {kernel.shape} and bias {bias.shape} do not fit "
                             f"[{width}, {out}] and [{out}]")
        state[f"{name}.weight"] = torch.tensor(kernel.T, dtype=dtype or config.dtype)
        state[f"{name}.bias"] = torch.tensor(bias, dtype=dtype or config.dtype)
        width = out
    return state


def _tp_axis(key: str) -> int:
    """The flax axis of a stacked leaf's per-rank slices: the kernel's
    input (0) for a row-parallel weight, the experts (0) for an expert
    stack, the output (-1) otherwise."""
    return 0 if key.endswith(_AXIS0) else -1


def _classifier_from_jax(tree: Mapping, config, dtype, **ranks) -> Dict[str, torch.Tensor]:
    """The ``EncoderClassifier`` state dict from JAX's tree: the trunk under
    ``encoder/`` (no lm_head), the pooler (``config.dtype``) and the fp32
    classifier, whose class count is read from its kernel."""
    flat = dict(_flatten({k: v for k, v in tree.items() if k != "encoder"}))
    wanted = [path for path, _, _ in _CLASSIFIER]
    missing = sorted(set(wanted) - set(flat))
    if missing:
        raise KeyError(f"JAX parameter tree lacks {missing}")
    extra = sorted(set(flat) - set(wanted))
    if extra:
        raise ValueError(f"JAX parameter tree has leaves the port does not: {extra}")
    state = {_ENCODER + k: v for k, v in
             params_from_jax(tree["encoder"], config, dtype, head=False, **ranks).items()}
    d, classes = config.d_model, _as_float32(flat["classifier/kernel"]).shape[-1]
    shapes = {"pooler.weight": ((d, d), config.dtype), "pooler.bias": ((d,), config.dtype),
              "classifier.weight": ((classes, d), torch.float32),
              "classifier.bias": ((classes,), torch.float32)}
    for path, key, transpose in _CLASSIFIER:
        arr = _as_float32(flat[path])
        arr = arr.T if transpose else arr
        shape, module_dtype = shapes[key]
        if arr.shape != shape:
            raise ValueError(f"{path}: shape {arr.shape} does not fit {key} {shape}")
        state[key] = torch.tensor(arr, dtype=dtype or module_dtype)
    return state


def params_from_jax(tree: Mapping, config, dtype=None, *,
                    model_rank: Optional[int] = None,
                    pipe_rank: Optional[int] = None,
                    head: bool = True) -> Dict[str, torch.Tensor]:
    """The port's state dict from a JAX ``GPTLM`` (or ``MLPClassifier``)
    parameter tree.

    Works for both layer layouts of the JAX package, initialized without a
    mesh or under one.  Each tensor comes back on the CPU in the dtype of
    the port's module (``config.dtype`` for matmul weights, biases and
    embeddings; fp32 for LayerNorm), ready for ``GPTLM.load_state_dict``,
    or in ``dtype`` when given: ``dtype=torch.float32`` keeps the tree's
    own fp32 values, the master weights of training
    (``TrainState.create``).  A tensor-parallel leaf (stacked under
    ``shard/sharded``) gives rank ``model_rank``'s slice, or with
    ``model_rank=None`` the full weight, its ranks' slices side by side.
    A pipeline tree gives pipe rank ``pipe_rank``'s layers (the replicated
    leaves with them), or with ``pipe_rank=None`` every layer.  A tree
    without an lm_head (``head=False``) is a trunk's.  An
    ``EncoderClassifier``'s tree (``encoder/...``, ``pooler``,
    ``classifier``) gives its state dict, the trunk's keys under
    ``encoder.``.  A post-norm tree has no ``norm_final``; ``embed_norm``
    adds ``embed/norm``.
    """
    if _is_mlp(config):
        return _mlp_from_jax(tree, config, dtype)
    seq2seq = _is_seq2seq(config)
    if "encoder" in tree and not seq2seq:
        return _classifier_from_jax(tree, config, dtype, model_rank=model_rank,
                                    pipe_rank=pipe_rank)
    flat = dict(_flatten(tree))
    stacks = _stacks(config)
    wanted = [(path, key, t, None, 0) for path, key, t in
              (_s2s_top_leaves(config) if seq2seq else _top_leaves(config, head))]
    for stack in stacks:
        flat = _unpipe(flat, stack.config, stack.pipe, stack.jax)
        scanned = any(p.startswith(stack.jax + "layers/block/") for p in flat)
        unrolled = any(p.startswith(stack.jax + "layer_") for p in flat)
        if scanned == unrolled:
            raise ValueError(
                f"expected exactly one JAX layer layout, scanned '{stack.jax}layers/block/...' "
                f"or unrolled '{stack.jax}layer_{{i}}/...'"
            )
        n = stack.config.n_layers
        for i in range(n):
            for path, key, t in stack.leaves:
                port_key = f"{stack.port}layer_{i}.{key}"
                if scanned:
                    wanted.append((f"{stack.jax}layers/block/{path}", port_key, t, i, n))
                else:
                    wanted.append((f"{stack.jax}layer_{i}/{path}", port_key, t, None, n))
    # a leaf of the mesh layout stands under ModuleShard's per-rank stack
    wanted = [(_stacked_path(p) if p not in flat and _stacked_path(p) in flat else p, k, t, i, n)
              for p, k, t, i, n in wanted]
    missing = sorted({p for p, *_ in wanted if p not in flat})
    if missing:
        raise KeyError(f"JAX parameter tree lacks {missing}")
    extra = sorted(set(flat) - {p for p, *_ in wanted})
    if extra:
        raise ValueError(f"JAX parameter tree has leaves the port does not: {extra}")
    shapes = state_shapes(config, head)
    state = {}
    for path, key, transpose, layer, n_layers in wanted:
        arr = _as_float32(flat[path])
        if layer is not None:
            if arr.ndim == 0 or arr.shape[0] != n_layers:
                raise ValueError(
                    f"{path}: scanned leaf {arr.shape} lacks the [n_layers="
                    f"{n_layers}] axis"
                )
            arr = arr[layer]
        shape, module_dtype = shapes[key]
        if _STACKED in path or _EXPERTS_STACKED in path:
            tp = arr.shape[0]
            axis = _tp_axis(key)
            full = np.concatenate(list(arr), axis=axis)
            if (full.T if transpose else full).shape != shape:
                raise ValueError(f"{path}: stacked shape {arr.shape} does not fit {key} {shape}")
            if model_rank is not None:
                if not 0 <= model_rank < tp:
                    raise ValueError(f"model_rank={model_rank} of {tp} shards")
                full = arr[model_rank]
            arr = full
            shape = (arr.T if transpose else arr).shape
        if transpose:
            arr = arr.T
        if arr.shape != shape:
            raise ValueError(f"{path}: shape {arr.shape} does not fit {key} {shape}")
        state[key] = torch.tensor(arr, dtype=dtype or module_dtype)
    if pipe_rank is not None:
        from tpu_parallel_torch.models.gpt import stage_layers

        if not 0 <= pipe_rank < config.pipe_size:
            raise ValueError(f"pipe_rank={pipe_rank} of {config.pipe_size} stages")
        own = {f"{stack.port}layer_{i}." for stack in stacks
               for i in stage_layers(stack.config, pipe_rank)}
        ports = tuple(stack.port for stack in stacks)
        state = {k: v for k, v in state.items()
                 if not k.startswith(ports) or k[:k.index(".", k.index(".") + 1) + 1] in own}
    return state


def _pipe_tree(tree: Dict, config, stack: Optional[_Stack] = None) -> Dict:
    """An unrolled one-stage tree's stack (``blocks/layer_{i}``, or the
    given stack's) in the pipe layout: each block leaf stacked
    ``[pipe, ...]`` under its pipe prefix (``pipeline/stage/sharded/``;
    ``chunk{j}/`` per virtual stage under interleave), after ``[layers per
    chunk]`` under ``layers/block`` when ``scan_layers``.  ``config``'s
    ``n_layers`` is the stack's depth."""
    stack = stack or _stacks(config)[0]
    blocks = tree.pop(stack.jax[:-1])
    stage: Dict = {}
    per, n = _chunk_layers(config), config.pipe_size
    leaf_paths = [p for p, _ in _flatten(blocks["layer_0"])]

    def put(node: Dict, path: str, value: torch.Tensor):
        *parents, leaf = path.split("/")
        for name in parents:
            node = node.setdefault(name, {})
        node[leaf] = value.contiguous()

    def get(i: int, path: str) -> torch.Tensor:
        node = blocks[f"layer_{i}"]
        for name in path.split("/"):
            node = node[name]
        return node

    for j in range(config.pipe_interleave):
        node = stage.setdefault(f"chunk{j}", {}) if config.pipe_interleave > 1 else stage
        for path in leaf_paths:
            per_rank = [[get(_global_layer(config, r, j, k), path) for k in range(per)]
                        for r in range(n)]
            if config.scan_layers:
                put(node, f"layers/block/{path}",
                    torch.stack([torch.stack(layers) for layers in per_rank]))
            else:
                for k in range(per):
                    put(node, f"layer_{k}/{path}", torch.stack([layers[k] for layers in per_rank]))
    node = tree
    for name in stack.pipe.split("/")[:-3]:
        node = node.setdefault(name, {})
    node["stage"] = {"sharded": stage}
    return tree


def params_to_jax(state_dict: Union[Mapping[str, torch.Tensor],
                                    Sequence[Mapping[str, torch.Tensor]]], config, *,
                  head: bool = True, _mesh_layout: bool = False) -> Dict:
    """The JAX ``GPTLM`` parameter tree of a port state dict: the exact
    inverse of :func:`params_from_jax`.  ``Linear`` weights go back to
    flax's ``[in, out]``; ``config.scan_layers`` stacks every block leaf
    under ``blocks/layers/block`` with a leading ``[n_layers]`` axis, else
    each layer sits under ``blocks/layer_{i}``.  Given every model rank's
    state dict (a list in axis order, each holding that rank's slices,
    ``params_from_jax(..., model_rank=r)``'s inverse), the tree is the
    mesh layout: each tensor-parallel leaf (one whose slices differ in
    shape from the full weight) stacked ``[tp, ...]`` under
    ``shard/sharded``.  Under ``config.pipe_size`` > 1 the list holds every
    rank's state dict in (pipe, model) order, pipe-major, and the tree is
    the pipe layout (``pipeline/stage/sharded/...``, the inverse of
    :func:`params_from_jax`'s), every tensor-parallel leaf stacked even at
    one model rank, as JAX's mesh init stacks it.  Leaves are new
    contiguous CPU tensors in the state dict's dtypes.  An ``MLPConfig``
    gives the MLP classifier's tree; its state dict must hold exactly its
    layers.  ``head=False``: a trunk without an lm_head.  An
    ``EncoderClassifier``'s state dict (one, keys under ``encoder.``) gives
    JAX's ``encoder`` / ``pooler`` / ``classifier`` tree."""
    seq2seq = _is_seq2seq(config)
    if isinstance(state_dict, Mapping) and not seq2seq and any(
            k.startswith(_ENCODER) for k in state_dict):
        own = {key for _, key, _ in _CLASSIFIER}
        extra = sorted(k for k in state_dict if not k.startswith(_ENCODER) and k not in own)
        if extra:
            raise ValueError(f"EncoderClassifier state dict has keys the tree does not: {extra}")
        tree = {"encoder": params_to_jax({k[len(_ENCODER):]: v for k, v in state_dict.items()
                                          if k.startswith(_ENCODER)}, config, head=False)}
        for path, key, transpose in _CLASSIFIER:
            value = state_dict[key].detach().cpu()
            name, leaf = path.split("/")
            tree.setdefault(name, {})[leaf] = (value.T if transpose else value).contiguous()
        return tree
    tree: Dict = {}
    ranks = None
    if not isinstance(state_dict, Mapping):
        ranks = list(state_dict)
        state_dict = ranks[0]
    if getattr(config, "pipe_size", 1) > 1:
        if ranks is None or len(ranks) % config.pipe_size:
            raise ValueError(f"a pipeline tree needs every rank's state dict: a list of a "
                             f"multiple of pipe_size={config.pipe_size}")
        tp = len(ranks) // config.pipe_size
        merged = [{k: v for p in range(config.pipe_size) for k, v in ranks[p * tp + m].items()}
                  for m in range(tp)]
        flat_config = dataclasses.replace(config, pipe_size=1, pipe_interleave=1,
                                          scan_layers=False)
        tree = params_to_jax(merged, flat_config, _mesh_layout=True)
        for stack in _stacks(config):
            tree = _pipe_tree(tree, stack.config, stack)
        return tree
    if _is_mlp(config):
        layers = [f"hidden_{i}" for i in range(config.num_hidden_layers)] + ["head"]
        wanted = {f"{name}.{leaf}" for name in layers for leaf in ("weight", "bias")}
        if set(state_dict) != wanted:
            raise KeyError(f"MLP state dict keys {sorted(state_dict)}, expected {sorted(wanted)}")
        return {name: {"kernel": state_dict[f"{name}.weight"].detach().cpu().T.contiguous(),
                       "bias": state_dict[f"{name}.bias"].detach().cpu().contiguous()}
                for name in layers}
    shapes = state_shapes(config, head)
    top = _s2s_top_leaves(config) if seq2seq else _top_leaves(config, head)
    stacks = _stacks(config)
    # the leaves JAX's ModuleShard stacks over the model axis, by port key
    split = {k for p, k, _ in top + tuple(leaf for st in stacks for leaf in st.leaves)
             if _SHARD in p or _EXPERTS in p}

    def put(path: str, value: torch.Tensor):
        node = tree
        *parents, leaf = path.split("/")
        for name in parents:
            node = node.setdefault(name, {})
        node[leaf] = value.contiguous()

    def leaf(key: str, transpose: bool):
        """(value in flax's layout, stacked?) of one port key."""
        def flax(v):
            v = v.detach().cpu()
            return v.transpose(-1, -2) if transpose else v
        if ranks is not None and (tuple(state_dict[key].shape) != shapes[key][0]
                                  or (_mesh_layout and (key in split
                                                        or key.split(".", 2)[-1] in split))):
            return torch.stack([flax(r[key]) for r in ranks]), True
        return flax(state_dict[key]), False

    for path, key, t in top:
        value, stacked = leaf(key, t)
        put(_stacked_path(path) if stacked else path, value)
    for stack in stacks:
        for path, key, t in stack.leaves:
            values = [leaf(f"{stack.port}layer_{i}.{key}", t)
                      for i in range(stack.config.n_layers)]
            stacked = values[0][1]
            if stacked:
                path = _stacked_path(path)
            if config.scan_layers:
                put(f"{stack.jax}layers/block/{path}", torch.stack([v for v, _ in values]))
            else:
                for i, (value, _) in enumerate(values):
                    put(f"{stack.jax}layer_{i}/{path}", value)
    return tree


def _trunc_normal_(value: torch.Tensor, std: float, generator: torch.Generator) -> None:
    """A normal of mean 0 and ``std`` truncated at two ``std``, by the
    inverse CDF (a uniform draw between the bounds' CDF values through
    ``erfinv``): one pass over the tensor, where ``nn.init.trunc_normal_``
    may redraw all of it until no value falls outside."""
    bound = math.erf(2.0 / math.sqrt(2.0))  # 2 * CDF(2) - 1
    value.uniform_(-bound, bound, generator=generator)
    value.erfinv_().mul_(std * math.sqrt(2.0)).clamp_(-2 * std, 2 * std)


def _param_generator(seed: int, name: str) -> torch.Generator:
    """The CPU generator of parameter ``name`` under ``seed``."""
    from tpu_parallel_torch.core.rng import _mix

    return torch.Generator().manual_seed(
        _mix((seed * 0x9E3779B97F4A7C15 + zlib.crc32(name.encode())) & ((1 << 64) - 1))
        & (2**63 - 1))


def init_params(model: torch.nn.Module, seed: int = 0) -> Dict[str, torch.Tensor]:
    """Fill ``model``'s weights in place from ``seed``, with flax's defaults:
    Dense kernels lecun-normal (truncated normal, std sqrt(1/fan_in) / .8796,
    cut at two std), biases 0, embeddings normal with std sqrt(1/d_model),
    LayerNorm scale 1 and bias 0.  Each parameter is drawn in fp32 on the
    CPU from its own generator, seeded from ``seed`` and the parameter's
    name, so a seed gives the same weights on every device and in every
    layout: an FSDP- or TP-sharded parameter is drawn at its full shape and
    takes this rank's slice, and a pipeline stage draws only its own layers
    (their names are the one-device model's).  The draws run on as many
    threads as torch's intra-op setting (each from its own generator: the
    same values as in turn).  Returns the fp32 draws by parameter name, at
    full shape (the master weights of training).  An ``EncoderClassifier``'s
    trunk (``encoder.*``) is drawn by the same rules, its pooler and
    classifier as Dense layers."""
    from concurrent.futures import ThreadPoolExecutor

    from tpu_parallel_torch.parallel.fsdp import shard_info

    params = list(model.named_parameters())

    def draw(item) -> torch.Tensor:
        name, param = item
        info = shard_info(param)
        shape = param.shape if info is None else info.global_shape
        value = torch.empty(shape, dtype=torch.float32)
        gen = _param_generator(seed, name)
        # an EncoderClassifier's trunk: the LM's names under "encoder."
        local = name[len(_ENCODER):] if name.startswith(_ENCODER) else name
        if name.endswith(".bias"):
            value.zero_()
        elif name.endswith("rel_embedding"):
            # the T5 bias table: flax's normal(stddev=1)
            value.normal_(0.0, 1.0, generator=gen)
        elif ".norm_" in f".{local}" or local.startswith(("embed.norm.", "enc_norm.",
                                                          "dec_norm.")):
            value.fill_(1.0)
        elif local.startswith("embed."):
            value.normal_(0.0, 1.0 / math.sqrt(shape[1]), generator=gen)
        else:
            std = math.sqrt(1.0 / shape[1]) / 0.87962566103423978
            _trunc_normal_(value, std, gen)
        return value

    with ThreadPoolExecutor(max(1, torch.get_num_threads())) as pool:
        values = list(pool.map(draw, params))
    draws = {}
    with torch.no_grad():
        for (name, param), value in zip(params, values):
            info = shard_info(param)
            param.copy_(value if info is None else info.local(value))
            draws[name] = value
    return draws
