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
without biases), and no ``embed/pos`` under rope.  Nothing here imports
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
    ("norm_final/scale", "norm_final.weight", False),
    ("norm_final/bias", "norm_final.bias", False),
    ("lm_head/shard/kernel", "lm_head.weight", True),
)
_SCANNED = "blocks/layers/block/"
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


def _unpipe(flat: Dict[str, object], config) -> Dict[str, object]:
    """A flat pipe-layout tree as the unrolled one-stage layout
    (``blocks/layer_{i}/...``, the pipe and scan axes taken off).  The pipe
    degree and the virtual stages are read off the tree, so a one-stage
    ``config`` takes a pipeline tree's full weights."""
    piped = {p: v for p, v in flat.items() if p.startswith(_PIPE)}
    if not piped:
        return flat
    chunks = {p[len(_PIPE):].split("/", 1)[0] for p in piped}
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
        rest, chunk = path[len(_PIPE):], 0
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
                    out[f"blocks/layer_{_global_layer(layout, r, chunk, k)}/"
                        f"{rest[len('layers/block/'):]}"] = arr[r, k]
            else:
                head, block_path = rest.split("/", 1)
                k = int(head[len("layer_"):])
                out[f"blocks/layer_{_global_layer(layout, r, chunk, k)}/{block_path}"] = arr[r]
    return out


def _rmsnorm(config) -> bool:
    return getattr(config, "norm", "layernorm") == "rmsnorm"


def _top_leaves(config) -> Tuple[Tuple[str, str, bool], ...]:
    """The leaves outside the blocks: no ``pos`` table unless the positions
    are learned, no norm bias under RMSNorm."""
    return tuple(leaf for leaf in _TOP
                 if not (leaf[1] == "embed.pos.weight"
                         and getattr(config, "positional", "learned") != "learned")
                 and not (leaf[1] == "norm_final.bias" and _rmsnorm(config)))


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


def state_shapes(config) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """``{port key: (shape, dtype)}`` of the port's GPTLM state dict."""
    d, dh, h = config.d_model, config.head_dim, config.n_heads
    n_kv = config.n_kv_heads or h
    hidden = config.mlp_ratio * d
    dt, f32 = config.dtype, torch.float32
    block = {
        "attn.qkv.weight": ((3 * d, d), dt), "attn.qkv.bias": ((3 * d,), dt),
        "attn.q.weight": ((h * dh, d), dt), "attn.q.bias": ((h * dh,), dt),
        "attn.kv.weight": ((2 * n_kv * dh, d), dt), "attn.kv.bias": ((2 * n_kv * dh,), dt),
        "attn.out.weight": ((d, h * dh), dt), "attn.out.bias": ((d,), dt),
        "mlp.gate.weight": ((hidden, d), dt),
        "mlp.up.weight": ((hidden, d), dt), "mlp.up.bias": ((hidden,), dt),
        "mlp.down.weight": ((d, hidden), dt), "mlp.down.bias": ((d,), dt),
        "norm_attn.weight": ((d,), f32), "norm_attn.bias": ((d,), f32),
        "norm_mlp.weight": ((d,), f32), "norm_mlp.bias": ((d,), f32),
    }
    e = getattr(config, "moe_experts", 0)
    block.update({
        "moe.router.weight": ((e, d), f32),
        "moe.experts.gate.kernel": ((e, d, hidden), dt),
        "moe.experts.up.kernel": ((e, d, hidden), dt), "moe.experts.up.bias": ((e, hidden), dt),
        "moe.experts.down.kernel": ((e, hidden, d), dt), "moe.experts.down.bias": ((e, d), dt),
    })
    top = {
        "embed.tok.weight": ((config.vocab_size, d), dt),
        "embed.pos.weight": ((config.seq_len, d), dt),
        "norm_final.weight": ((d,), f32),
        "norm_final.bias": ((d,), f32),
        "lm_head.weight": ((config.vocab_size, d), dt),
    }
    kept = {key for _, key, _ in _top_leaves(config)}
    shapes = {k: v for k, v in top.items() if k.startswith("embed.") and k in kept}
    for i in range(config.n_layers):
        for _, key, _ in _block_leaves(config):
            shapes[f"blocks.layer_{i}.{key}"] = block[key]
    shapes.update({k: v for k, v in top.items() if not k.startswith("embed.") and k in kept})
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


def params_from_jax(tree: Mapping, config, dtype=None, *,
                    model_rank: Optional[int] = None,
                    pipe_rank: Optional[int] = None) -> Dict[str, torch.Tensor]:
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
    leaves with them), or with ``pipe_rank=None`` every layer.
    """
    if _is_mlp(config):
        return _mlp_from_jax(tree, config, dtype)
    flat = _unpipe(dict(_flatten(tree)), config)
    scanned = any(p.startswith(_SCANNED) for p in flat)
    unrolled = any(p.startswith("blocks/layer_") for p in flat)
    if scanned == unrolled:
        raise ValueError(
            "expected exactly one JAX layer layout, scanned 'blocks/layers/block/...' "
            "or unrolled 'blocks/layer_{i}/...'"
        )
    wanted = [(path, key, t, None) for path, key, t in _top_leaves(config)]
    for i in range(config.n_layers):
        for path, key, t in _block_leaves(config):
            port_key = f"blocks.layer_{i}.{key}"
            if scanned:
                wanted.append((_SCANNED + path, port_key, t, i))
            else:
                wanted.append((f"blocks/layer_{i}/{path}", port_key, t, None))
    # a leaf of the mesh layout stands under ModuleShard's per-rank stack
    wanted = [(_stacked_path(p) if p not in flat and _stacked_path(p) in flat else p, k, t, i)
              for p, k, t, i in wanted]
    missing = sorted({p for p, _, _, _ in wanted if p not in flat})
    if missing:
        raise KeyError(f"JAX parameter tree lacks {missing}")
    extra = sorted(set(flat) - {p for p, _, _, _ in wanted})
    if extra:
        raise ValueError(f"JAX parameter tree has leaves the port does not: {extra}")
    shapes = state_shapes(config)
    state = {}
    for path, key, transpose, layer in wanted:
        arr = _as_float32(flat[path])
        if layer is not None:
            if arr.ndim == 0 or arr.shape[0] != config.n_layers:
                raise ValueError(
                    f"{path}: scanned leaf {arr.shape} lacks the [n_layers="
                    f"{config.n_layers}] axis"
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
        own = {f"blocks.layer_{i}." for i in stage_layers(config, pipe_rank)}
        state = {k: v for k, v in state.items()
                 if not k.startswith("blocks.") or k[:k.index(".", 7) + 1] in own}
    return state


def _pipe_tree(tree: Dict, config) -> Dict:
    """An unrolled one-stage tree (``blocks/layer_{i}``) in the pipe
    layout: each block leaf stacked ``[pipe, ...]`` under
    ``pipeline/stage/sharded/`` (``chunk{j}/`` under interleave), after
    ``[layers per chunk]`` under ``layers/block`` when ``scan_layers``."""
    blocks = tree.pop("blocks")
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
    tree["pipeline"] = {"stage": {"sharded": stage}}
    return tree


def params_to_jax(state_dict: Union[Mapping[str, torch.Tensor],
                                    Sequence[Mapping[str, torch.Tensor]]], config, *,
                  _mesh_layout: bool = False) -> Dict:
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
    layers."""
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
        return _pipe_tree(params_to_jax(merged, flat_config, _mesh_layout=True), config)
    if _is_mlp(config):
        layers = [f"hidden_{i}" for i in range(config.num_hidden_layers)] + ["head"]
        wanted = {f"{name}.{leaf}" for name in layers for leaf in ("weight", "bias")}
        if set(state_dict) != wanted:
            raise KeyError(f"MLP state dict keys {sorted(state_dict)}, expected {sorted(wanted)}")
        return {name: {"kernel": state_dict[f"{name}.weight"].detach().cpu().T.contiguous(),
                       "bias": state_dict[f"{name}.bias"].detach().cpu().contiguous()}
                for name in layers}
    shapes = state_shapes(config)
    # the leaves JAX's ModuleShard stacks over the model axis, by port key
    split = {k for p, k, _ in _top_leaves(config) + _block_leaves(config)
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

    for path, key, t in _top_leaves(config):
        value, stacked = leaf(key, t)
        put(_stacked_path(path) if stacked else path, value)
    for path, key, t in _block_leaves(config):
        values = [leaf(f"blocks.layer_{i}.{key}", t) for i in range(config.n_layers)]
        stacked = values[0][1]
        if stacked:
            path = _stacked_path(path)
        if config.scan_layers:
            put(_SCANNED + path, torch.stack([v for v, _ in values]))
        else:
            for i, (value, _) in enumerate(values):
                put(f"blocks/layer_{i}/{path}", value)
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
    full shape (the master weights of training)."""
    from concurrent.futures import ThreadPoolExecutor

    from tpu_parallel_torch.parallel.fsdp import shard_info

    params = list(model.named_parameters())

    def draw(item) -> torch.Tensor:
        name, param = item
        info = shard_info(param)
        shape = param.shape if info is None else info.global_shape
        value = torch.empty(shape, dtype=torch.float32)
        gen = _param_generator(seed, name)
        if name.endswith(".bias"):
            value.zero_()
        elif ".norm_" in f".{name}":
            value.fill_(1.0)
        elif name.startswith("embed."):
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
