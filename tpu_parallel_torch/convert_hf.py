"""Convert a local HuggingFace checkpoint into the port's formats: the
counterpart of ``scripts/convert_hf.py``.

    python -m tpu_parallel_torch.convert_hf /path/to/hf_model /path/to/out \\
        [--format torch|int8] [--seq-len N]

Reads a ``save_pretrained`` directory of the GPT-2 or Llama family
(``config.json`` says which) without ``transformers``: the weights come
from ``model.safetensors`` (or its sharded index), read here, or from
``pytorch_model.bin``.  Converts them with ``models/hf.py`` and writes

- ``--format torch`` (default): ``params.pt``, the bare parameters (a
  state dict, fp32) that ``GPTLM(build_config(hf_dir)[0]).load_state_dict``
  takes: the counterpart of the JAX script's bare-params orbax output;
- ``--format int8``: ``params_int8.npz``, the weight-only int8 export of
  ``models/quantize.py`` over the JAX package's parameter layout, the file
  the JAX script's ``--format int8`` writes for the same directory
  (``load_int8_npz`` + ``dequantize_params`` + ``params_from_jax`` read
  it back).
"""

from __future__ import annotations

import argparse
import json
import os
import types
from typing import Dict, Tuple

import numpy as np
import torch

from tpu_parallel_torch.models import tiny_test
from tpu_parallel_torch.models.convert import params_to_jax
from tpu_parallel_torch.models.hf import from_hf_gpt2, from_hf_llama
from tpu_parallel_torch.models.quantize import quantize_params, quantized_nbytes, save_int8_npz

# safetensors dtype names -> torch dtypes (the floating ones checkpoints hold)
_SAFETENSORS_DTYPES = {"F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
                       "BF16": torch.bfloat16}


def build_config(hf_dir: str, seq_len: int = 0):
    """``(config, family)`` for the checkpoint in ``hf_dir``: the port's
    GPT config (fp32, unrolled layers, no remat or dropout) and ``"gpt2"``
    or ``"llama"``, from its ``config.json`` as the JAX script builds it,
    with its refusals."""
    with open(os.path.join(hf_dir, "config.json")) as fh:
        hc = json.load(fh)
    model_type = hc.get("model_type")
    common = dict(scan_layers=False, remat=False, dropout_rate=0.0)
    if model_type == "gpt2":
        n_inner = hc.get("n_inner") or 4 * hc["n_embd"]
        if n_inner != 4 * hc["n_embd"]:
            raise SystemExit(
                f"n_inner={n_inner} != 4*n_embd={4 * hc['n_embd']} — "
                "TransformerConfig.mlp_ratio is an integer multiple of "
                "d_model, so this checkpoint's MLP width cannot be "
                "represented"
            )
        return tiny_test(vocab_size=hc["vocab_size"], d_model=hc["n_embd"],
                         n_layers=hc["n_layer"], n_heads=hc["n_head"],
                         seq_len=seq_len or hc["n_positions"], positional="learned",
                         norm="layernorm", mlp="gelu",
                         norm_eps=hc.get("layer_norm_epsilon", 1e-5), **common), "gpt2"
    if model_type == "llama":
        if hc.get("rope_scaling"):
            raise SystemExit(
                f"rope_scaling={hc['rope_scaling']} is not supported — the "
                "framework implements plain RoPE (rope_theta only); "
                "converting would produce silently wrong positions"
            )
        if hc["intermediate_size"] % hc["hidden_size"]:
            raise SystemExit(
                f"intermediate_size={hc['intermediate_size']} is not a "
                f"multiple of hidden_size={hc['hidden_size']} — "
                "TransformerConfig.mlp_ratio is an integer, so this "
                "checkpoint's MLP width cannot be represented"
            )
        heads = hc["num_attention_heads"]
        kv = hc.get("num_key_value_heads", heads)
        return tiny_test(vocab_size=hc["vocab_size"], d_model=hc["hidden_size"],
                         n_layers=hc["num_hidden_layers"], n_heads=heads,
                         n_kv_heads=None if kv == heads else kv,
                         mlp_ratio=hc["intermediate_size"] // hc["hidden_size"],
                         seq_len=seq_len or hc["max_position_embeddings"], positional="rope",
                         norm="rmsnorm", mlp="swiglu", norm_eps=hc.get("rms_norm_eps", 1e-5),
                         rope_theta=hc.get("rope_theta", 10000.0), **common), "llama"
    raise SystemExit(f"unsupported model_type {model_type!r} (gpt2 | llama)")


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of one ``.safetensors`` file (an 8-byte little-endian
    header length, a JSON header of ``dtype``, ``shape`` and
    ``data_offsets`` per tensor, then the raw bytes), as CPU tensors."""
    with open(path, "rb") as fh:
        size = int.from_bytes(fh.read(8), "little")
        header = json.loads(fh.read(size))
        payload = fh.read()
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in _SAFETENSORS_DTYPES:
            raise ValueError(f"{path}: tensor {name} has dtype {info['dtype']} "
                             f"(expected one of {sorted(_SAFETENSORS_DTYPES)})")
        start, end = info["data_offsets"]
        flat = torch.frombuffer(bytearray(payload[start:end]),
                                dtype=_SAFETENSORS_DTYPES[info["dtype"]])
        out[name] = flat.reshape(info["shape"])
    return out


def read_checkpoint(hf_dir: str) -> Dict[str, torch.Tensor]:
    """The state dict a ``save_pretrained`` directory holds: one
    ``model.safetensors``, the shards its ``model.safetensors.index.json``
    names, or ``pytorch_model.bin``."""
    single = os.path.join(hf_dir, "model.safetensors")
    index = single + ".index.json"
    if os.path.exists(single):
        return read_safetensors(single)
    if os.path.exists(index):
        with open(index) as fh:
            shards = sorted(set(json.load(fh)["weight_map"].values()))
        out = {}
        for shard in shards:
            out.update(read_safetensors(os.path.join(hf_dir, shard)))
        return out
    binary = os.path.join(hf_dir, "pytorch_model.bin")
    if os.path.exists(binary):
        return torch.load(binary, map_location="cpu", weights_only=True)
    raise FileNotFoundError(f"{hf_dir}: no model.safetensors, its index, or pytorch_model.bin")


class _Checkpoint:
    """A checkpoint as ``models/hf.py`` takes a ``transformers`` model: its
    ``config`` (config.json's fields as attributes, for the structural
    checks) and ``state_dict()``."""

    def __init__(self, hf_dir: str):
        with open(os.path.join(hf_dir, "config.json")) as fh:
            self.config = types.SimpleNamespace(**json.load(fh))
        self._tensors = read_checkpoint(hf_dir)

    def state_dict(self) -> Dict[str, torch.Tensor]:
        return self._tensors


def convert(hf_dir: str, seq_len: int = 0) -> Tuple[Dict[str, torch.Tensor], object, str]:
    """``(state dict, config, family)``: the checkpoint in ``hf_dir`` as the
    port's fp32 parameters."""
    config, family = build_config(hf_dir, seq_len)
    load = from_hf_gpt2 if family == "gpt2" else from_hf_llama
    return load(_Checkpoint(hf_dir), config, dtype=torch.float32), config, family


def _sorted_tree(tree):
    """``tree`` with every dict's keys in sorted order (the order JAX's
    tree functions give the tree, and so its ``.npz`` entries)."""
    if isinstance(tree, dict):
        return {k: _sorted_tree(tree[k]) for k in sorted(tree)}
    return tree


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m tpu_parallel_torch.convert_hf")
    ap.add_argument("hf_dir", help="local save_pretrained directory")
    ap.add_argument("out_dir", help="output directory")
    ap.add_argument("--format", choices=("torch", "int8"), default="torch")
    ap.add_argument("--seq-len", type=int, default=0, help="override seq_len")
    args = ap.parse_args(argv)

    params, config, family = convert(args.hf_dir, args.seq_len)
    print(f"{family}: {sum(v.numel() for v in params.values()) / 1e6:.1f}M params converted")
    os.makedirs(args.out_dir, exist_ok=True)
    if args.format == "torch":
        out = os.path.join(args.out_dir, "params.pt")
        torch.save(params, out)
        print(f"parameters written to {out} — load with GPTLM(config).load_state_dict("
              "torch.load(...)), config from tpu_parallel_torch.convert_hf.build_config")
        return 0
    tree = _sorted_tree(params_to_jax(params, config))
    q = quantize_params(tree)
    out = os.path.join(args.out_dir, "params_int8.npz")
    save_int8_npz(out, q)
    dense = sum(np.asarray(v).nbytes for v in params.values())
    print(f"int8 artifact written to {out} ({quantized_nbytes(q) / 1e6:.1f} MB vs "
          f"{dense / 1e6:.1f} MB dense)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
