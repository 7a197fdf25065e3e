"""Weight-only int8 quantization for exported (serving) parameters: the
port of ``tpu_parallel/models/quantize.py``.

Storage/transfer compression for single-device inference params: matrix
leaves become int8 with one fp32 scale per output channel (last dim), ~4x
smaller than fp32 and ~2x smaller than bf16 on disk and over the wire.
The functions work on a nested dict of tensors in the JAX package's layout
(``convert.params_to_jax`` of a state dict, or the tree a ``.npz`` of
either package holds); :func:`dequantize_params` followed by
``convert.params_from_jax`` feeds ``GPTLM``.

:func:`absmax_int8` is also the KV cache's quantizer under
``kv_cache_dtype="int8"`` (``models/layers.py``), so the numerical recipe
cannot drift between the two.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import numpy as np
import torch

Pytree = Any


@dataclasses.dataclass
class QuantizedTensor:
    """int8 payload + fp32 per-output-channel (last dim) scales."""

    q: torch.Tensor  # int8, original shape
    scale: torch.Tensor  # fp32, shape (1, ..., 1, last) broadcast over the rest

    @property
    def shape(self):
        return self.q.shape

    def dequantize(self, dtype=torch.bfloat16) -> torch.Tensor:
        return (self.q.float() * self.scale).to(dtype)


def absmax_int8(x: torch.Tensor, axis) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric absmax int8 quantization: ``(int8, fp32 scale)``.

    ``scale = max|x| / 127`` over ``axis`` (kept); the payload is
    ``round(x / max(scale, 1e-30))`` in fp32, rounding half to even as
    ``jnp.round`` does; all-zero groups give zero payloads and a zero scale.
    """
    a = x.float()
    scale = a.abs().amax(dim=axis, keepdim=True) / 127.0
    q = torch.where(scale > 0, a / scale.clamp(min=1e-30), torch.zeros_like(a))
    return torch.round(q).to(torch.int8), scale


def _quantize_one(w: torch.Tensor) -> QuantizedTensor:
    # per-output-channel: reduce over every dim except the last (features)
    q, scale = absmax_int8(w, axis=tuple(range(w.ndim - 1)))
    return QuantizedTensor(q=q, scale=scale)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, QuantizedTensor):
        yield tree.q
        yield tree.scale
    else:
        yield tree


def quantize_params(params: Pytree, min_size: int = 4096) -> Pytree:
    """Quantize every float tensor leaf with ``ndim >= 2`` and at least
    ``min_size`` elements; biases, norm scales and other small vectors stay
    as they are (tiny and precision-critical).  Returns a tree of the same
    structure with :class:`QuantizedTensor` nodes in place of the big
    matrices."""

    def maybe_quantize(x):
        if (isinstance(x, torch.Tensor) and x.is_floating_point() and x.ndim >= 2
                and x.numel() >= min_size):
            return _quantize_one(x)
        return x

    return _map(maybe_quantize, params)


def dequantize_params(qparams: Pytree, dtype=torch.bfloat16) -> Pytree:
    """Restore a :func:`quantize_params` tree to dense ``dtype`` tensors."""
    return _map(lambda x: x.dequantize(dtype) if isinstance(x, QuantizedTensor) else x,
                qparams)


def _to_numpy(x) -> np.ndarray:
    """A host numpy array of a leaf; bf16 (which numpy lacks) widens to fp32,
    exactly."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def save_int8_npz(path: str, qparams: Pytree) -> None:
    """Serialize a :func:`quantize_params` tree to one ``.npz`` file, in the
    JAX package's key scheme: quantized leaves store ``<path>::q`` (int8)
    and ``<path>::scale`` (fp32), plain leaves one entry, paths joined with
    ``/``.  Either package's :func:`load_int8_npz` reads it."""
    flat = {}

    def walk(prefix, node):
        if isinstance(node, QuantizedTensor):
            flat[prefix + "::q"] = _to_numpy(node.q)
            flat[prefix + "::scale"] = _to_numpy(node.scale)
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}/{k}" if prefix else str(k), v)
        else:
            flat[prefix] = _to_numpy(node)

    walk("", qparams)
    np.savez(path, **flat)


def load_int8_npz(path: str) -> Pytree:
    """Rebuild the :func:`quantize_params` tree (CPU tensors) a
    :func:`save_int8_npz` file of either package holds; pass the result to
    :func:`dequantize_params`."""
    data = np.load(path)

    def set_at(tree, keys, value):
        for k in keys[:-1]:
            tree = tree.setdefault(k, {})
        tree[keys[-1]] = value

    tree: dict = {}
    qparts: dict = {}
    for key in data.files:
        if key.endswith(("::q", "::scale")):
            base, part = key.rsplit("::", 1)
            qparts.setdefault(base, {})[part] = data[key]
        else:
            set_at(tree, key.split("/"), torch.from_numpy(data[key]))
    for base, parts in qparts.items():
        set_at(tree, base.split("/"), QuantizedTensor(
            q=torch.from_numpy(parts["q"]), scale=torch.from_numpy(parts["scale"])))
    return tree


def quantized_nbytes(tree: Pytree) -> int:
    """Total serialized bytes of a (possibly quantized) param tree."""
    return sum(x.numel() * x.element_size() if isinstance(x, torch.Tensor) else np.asarray(x).nbytes
               for x in _leaves(tree))
