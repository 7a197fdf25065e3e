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
Nothing here imports JAX: leaves are read with
``numpy.asarray`` (torch leaves, bf16 ones too, through fp32).
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

import math
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
_BLOCK_REST = (
    ("attn/out/shard/kernel", "attn.out.weight", True),
    ("attn/out/bias", "attn.out.bias", False),
    ("mlp/up/shard/kernel", "mlp.up.weight", True),
    ("mlp/up/shard/bias", "mlp.up.bias", False),
    ("mlp/down/shard/kernel", "mlp.down.weight", True),
    ("mlp/down/bias", "mlp.down.bias", False),
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
# ModuleShard's scope: a tensor-parallel leaf's per-rank stack
_SHARD, _STACKED = "/shard/", "/shard/sharded/"
# Linear weights split along their input (row-parallel); every other
# stacked leaf splits its output
_ROW = ("attn.out.weight", "mlp.down.weight")


def _block_leaves(config) -> Tuple[Tuple[str, str, bool], ...]:
    n_kv = config.n_kv_heads or config.n_heads
    leaves = (_MHA if n_kv == config.n_heads else _GQA) + _BLOCK_REST
    if not config.dense_bias:
        leaves = tuple(leaf for leaf in leaves if leaf[1].endswith(".weight")
                       or leaf[0].startswith("norm_"))
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
        "mlp.up.weight": ((hidden, d), dt), "mlp.up.bias": ((hidden,), dt),
        "mlp.down.weight": ((d, hidden), dt), "mlp.down.bias": ((d,), dt),
        "norm_attn.weight": ((d,), f32), "norm_attn.bias": ((d,), f32),
        "norm_mlp.weight": ((d,), f32), "norm_mlp.bias": ((d,), f32),
    }
    shapes = {
        "embed.tok.weight": ((config.vocab_size, d), dt),
        "embed.pos.weight": ((config.seq_len, d), dt),
    }
    for i in range(config.n_layers):
        for _, key, _ in _block_leaves(config):
            shapes[f"blocks.layer_{i}.{key}"] = block[key]
    shapes["norm_final.weight"] = ((d,), f32)
    shapes["norm_final.bias"] = ((d,), f32)
    shapes["lm_head.weight"] = ((config.vocab_size, d), dt)
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
    input (0) for a row-parallel weight, its output (-1) otherwise."""
    return 0 if key.endswith(_ROW) else -1


def params_from_jax(tree: Mapping, config, dtype=None, *,
                    model_rank: Optional[int] = None) -> Dict[str, torch.Tensor]:
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
    """
    if _is_mlp(config):
        return _mlp_from_jax(tree, config, dtype)
    flat = dict(_flatten(tree))
    scanned = any(p.startswith(_SCANNED) for p in flat)
    unrolled = any(p.startswith("blocks/layer_") for p in flat)
    if scanned == unrolled:
        raise ValueError(
            "expected exactly one JAX layer layout, scanned 'blocks/layers/block/...' "
            "or unrolled 'blocks/layer_{i}/...'"
        )
    wanted = [(path, key, t, None) for path, key, t in _TOP]
    for i in range(config.n_layers):
        for path, key, t in _block_leaves(config):
            port_key = f"blocks.layer_{i}.{key}"
            if scanned:
                wanted.append((_SCANNED + path, port_key, t, i))
            else:
                wanted.append((f"blocks/layer_{i}/{path}", port_key, t, None))
    # a leaf of the mesh layout stands under ModuleShard's per-rank stack
    wanted = [(p.replace(_SHARD, _STACKED) if p not in flat and p.replace(_SHARD, _STACKED)
               in flat else p, k, t, i) for p, k, t, i in wanted]
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
        if _STACKED in path:
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
    return state


def params_to_jax(state_dict: Union[Mapping[str, torch.Tensor],
                                    Sequence[Mapping[str, torch.Tensor]]], config) -> Dict:
    """The JAX ``GPTLM`` parameter tree of a port state dict: the exact
    inverse of :func:`params_from_jax`.  ``Linear`` weights go back to
    flax's ``[in, out]``; ``config.scan_layers`` stacks every block leaf
    under ``blocks/layers/block`` with a leading ``[n_layers]`` axis, else
    each layer sits under ``blocks/layer_{i}``.  Given every model rank's
    state dict (a list in axis order, each holding that rank's slices,
    ``params_from_jax(..., model_rank=r)``'s inverse), the tree is the
    mesh layout: each tensor-parallel leaf (one whose slices differ in
    shape from the full weight) stacked ``[tp, ...]`` under
    ``shard/sharded``.  Leaves are new contiguous CPU tensors in the state
    dict's dtypes.  An ``MLPConfig`` gives the MLP classifier's tree; its
    state dict must hold exactly its layers."""
    tree: Dict = {}
    ranks = None
    if not isinstance(state_dict, Mapping):
        ranks = list(state_dict)
        state_dict = ranks[0]
    if _is_mlp(config):
        layers = [f"hidden_{i}" for i in range(config.num_hidden_layers)] + ["head"]
        wanted = {f"{name}.{leaf}" for name in layers for leaf in ("weight", "bias")}
        if set(state_dict) != wanted:
            raise KeyError(f"MLP state dict keys {sorted(state_dict)}, expected {sorted(wanted)}")
        return {name: {"kernel": state_dict[f"{name}.weight"].detach().cpu().T.contiguous(),
                       "bias": state_dict[f"{name}.bias"].detach().cpu().contiguous()}
                for name in layers}
    shapes = state_shapes(config)

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
        if ranks is not None and tuple(state_dict[key].shape) != shapes[key][0]:
            return torch.stack([flax(r[key]) for r in ranks]), True
        return flax(state_dict[key]), False

    for path, key, t in _TOP:
        value, stacked = leaf(key, t)
        put(path.replace(_SHARD, _STACKED) if stacked else path, value)
    for path, key, t in _block_leaves(config):
        values = [leaf(f"blocks.layer_{i}.{key}", t) for i in range(config.n_layers)]
        stacked = values[0][1]
        if stacked:
            path = path.replace(_SHARD, _STACKED)
        if config.scan_layers:
            put(_SCANNED + path, torch.stack([v for v, _ in values]))
        else:
            for i, (value, _) in enumerate(values):
                put(f"blocks/layer_{i}/{path}", value)
    return tree


def init_params(model: torch.nn.Module, seed: int = 0) -> Dict[str, torch.Tensor]:
    """Fill ``model``'s weights in place from ``seed``, with flax's defaults:
    Dense kernels lecun-normal (truncated normal, std sqrt(1/fan_in) / .8796,
    cut at two std), biases 0, embeddings normal with std sqrt(1/d_model),
    LayerNorm scale 1 and bias 0.  Drawn in fp32 on the CPU in parameter
    order, so a seed gives the same weights on every device.  An
    FSDP-sharded parameter is drawn at its full shape and takes this rank's
    slice, so every rank draws the same full weights.  Returns the fp32
    draws by parameter name, at full shape (the master weights of
    training)."""
    from tpu_parallel_torch.parallel.fsdp import shard_info

    gen = torch.Generator(device="cpu").manual_seed(seed)
    draws = {}
    with torch.no_grad():
        for name, param in model.named_parameters():
            info = shard_info(param)
            shape = param.shape if info is None else info.full_shape
            value = torch.empty(shape, dtype=torch.float32)
            if name.endswith(".bias"):
                value.zero_()
            elif ".norm_" in f".{name}":
                value.fill_(1.0)
            elif name.startswith("embed."):
                value.normal_(0.0, 1.0 / math.sqrt(shape[1]), generator=gen)
            else:
                std = math.sqrt(1.0 / shape[1]) / 0.87962566103423978
                torch.nn.init.trunc_normal_(value, 0.0, std, -2 * std, 2 * std, generator=gen)
            param.copy_(value if info is None else info.local(value))
            draws[name] = value
    return draws
