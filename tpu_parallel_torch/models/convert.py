"""Weights for the port: a seeded init, and the bridge from a JAX tree.

:func:`params_from_jax` turns the parameter tree that the JAX package's
``GPTLM.init`` gives (nested dicts of arrays; scanned ``blocks/layers/block``
with a leading ``[n_layers]`` axis, or unrolled ``blocks/layer_{i}``) into
the port's state dict.  Flax kernels are ``[in, out]``; PyTorch ``Linear``
weights are ``[out, in]``.  It raises on a missing leaf, an extra leaf or a
shape that does not match.  Nothing here imports JAX: leaves are read with
``numpy.asarray``.

:func:`init_params` draws the port's own weights from a seed, with flax's
default distributions, so the model runs realistic activations without JAX.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, Mapping, Tuple

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


def params_from_jax(tree: Mapping, config, dtype=None) -> Dict[str, torch.Tensor]:
    """The port's state dict from a JAX ``GPTLM`` parameter tree.

    Works for both layer layouts of the JAX package.  Each tensor comes back
    on the CPU in the dtype of the port's module (``config.dtype`` for
    matmul weights, biases and embeddings; fp32 for LayerNorm), ready for
    ``GPTLM.load_state_dict``, or in ``dtype`` when given:
    ``dtype=torch.float32`` keeps the tree's own fp32 values, the master
    weights of training (``TrainState.create``).
    """
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
    missing = sorted({p for p, _, _, _ in wanted if p not in flat})
    if missing:
        raise KeyError(f"JAX parameter tree lacks {missing}")
    extra = sorted(set(flat) - {p for p, _, _, _ in wanted})
    if extra:
        raise ValueError(f"JAX parameter tree has leaves the port does not: {extra}")
    shapes = state_shapes(config)
    state = {}
    for path, key, transpose, layer in wanted:
        arr = np.asarray(flat[path], dtype=np.float32)
        if layer is not None:
            if arr.ndim == 0 or arr.shape[0] != config.n_layers:
                raise ValueError(
                    f"{path}: scanned leaf {arr.shape} lacks the [n_layers="
                    f"{config.n_layers}] axis"
                )
            arr = arr[layer]
        if transpose:
            arr = arr.T
        shape, module_dtype = shapes[key]
        if arr.shape != shape:
            raise ValueError(f"{path}: shape {arr.shape} does not fit {key} {shape}")
        state[key] = torch.tensor(arr, dtype=dtype or module_dtype)
    return state


def init_params(model: torch.nn.Module, seed: int = 0) -> Dict[str, torch.Tensor]:
    """Fill ``model``'s weights in place from ``seed``, with flax's defaults:
    Dense kernels lecun-normal (truncated normal, std sqrt(1/fan_in) / .8796,
    cut at two std), biases 0, embeddings normal with std sqrt(1/d_model),
    LayerNorm scale 1 and bias 0.  Drawn in fp32 on the CPU in parameter
    order, so a seed gives the same weights on every device.  Returns the
    fp32 draws by parameter name (the master weights of training)."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    draws = {}
    with torch.no_grad():
        for name, param in model.named_parameters():
            value = torch.empty(param.shape, dtype=torch.float32)
            if name.endswith(".bias"):
                value.zero_()
            elif ".norm_" in f".{name}":
                value.fill_(1.0)
            elif name.startswith("embed."):
                value.normal_(0.0, 1.0 / math.sqrt(param.shape[1]), generator=gen)
            else:
                std = math.sqrt(1.0 / param.shape[1]) / 0.87962566103423978
                torch.nn.init.trunc_normal_(value, 0.0, std, -2 * std, 2 * std, generator=gen)
            param.copy_(value)
            draws[name] = value
    return draws
