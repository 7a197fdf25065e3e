"""HuggingFace weight interop: the port of ``tpu_parallel/models/hf.py``
for the GPT-2, Llama, BERT and T5 families.

``from_hf_*`` take a ``transformers`` model or its state dict (anything
with ``state_dict()``, or a mapping of names to tensors or arrays) and
return the port's own parameters: a state dict ``GPTLM.load_state_dict``
takes (in the module's dtypes, or ``dtype`` when given).  ``to_hf_*`` take
the port's state dict (or a module) and return an HF state dict of fp32
CPU tensors that the ``transformers`` model's ``load_state_dict`` takes.
Nothing here imports ``transformers``: the mapping is on names and
shapes, so a checkpoint read from disk (``tpu_parallel_torch.convert_hf``)
converts without it.  The conversions go through the JAX package's
parameter layout (``models/convert.py``), so each result is bitwise the
JAX function's bridged with ``params_from_jax`` / ``params_to_jax``.

Layout notes (as JAX's):
- HF GPT-2's ``Conv1D`` weights are [in, out] (flax's layout); ``c_attn``
  packs [q(all heads) | k | v] columns, the model fuses q, k, v per head
  (``[head, 3 * head_dim]`` blocks): ``_qkv_to_ours`` / ``_qkv_to_hf``.
- GPT-2 ties ``lm_head`` to ``wte``; the model keeps its own lm_head, set
  to ``wte`` on import; ``to_hf_gpt2`` refuses one that has drifted.
- HF Llama rotates pairs ``(j, j + head_dim / 2)`` (rotate_half), the
  model's ``apply_rope`` interleaved pairs ``(2j, 2j + 1)``: q's and k's
  output dims are permuted per head (``_rope_perm``).  Llama has no
  attention biases: they import as zeros, and ``to_hf_llama`` refuses
  non-zero ones.
- BERT: token-type row 0 is folded into the position table (exact for
  ``token_type_ids == 0``); the pooler comes back beside the trunk;
  ``norm_eps`` must be the checkpoint's (BERT's 1e-12).
- T5 (``EncoderDecoder`` of ``t5_small_hf``): T5's unscaled attention is
  folded into the q weights (times ``sqrt(head_dim)``), cross-attention's
  k|v interleave per head, one relative table per stack comes from block
  0, and a tied head takes T5's ``d_model**-0.5`` rescale.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from tpu_parallel_torch.models.convert import params_from_jax, params_to_jax

Tree = Dict[str, Any]


def _to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def _qkv_to_ours(w: np.ndarray, n_heads: int) -> np.ndarray:
    """[*, 3*D] HF (q|k|v blocks) -> [*, H, 3, dh] fused-per-head, flattened."""
    lead, d3 = w.shape[:-1], w.shape[-1]
    dh = d3 // 3 // n_heads
    w = np.moveaxis(w.reshape(*lead, 3, n_heads, dh), -3, -2)
    return w.reshape(*lead, d3)


def _qkv_to_hf(w: np.ndarray, n_heads: int) -> np.ndarray:
    lead, d3 = w.shape[:-1], w.shape[-1]
    dh = d3 // 3 // n_heads
    w = np.moveaxis(w.reshape(*lead, n_heads, 3, dh), -2, -3)
    return w.reshape(*lead, d3)


def _state_dict(hf_model_or_dict) -> Dict[str, np.ndarray]:
    sd = (hf_model_or_dict.state_dict() if hasattr(hf_model_or_dict, "state_dict")
          else hf_model_or_dict)
    return {k.removeprefix("transformer."): _to_np(v) for k, v in sd.items()}


def _port_tree(params, config, head: Optional[bool] = None) -> Tree:
    """The JAX package's unrolled parameter tree (fp32 numpy leaves) of a
    port state dict or module; ``head`` None: whether it holds an lm_head."""
    sd = params.state_dict() if hasattr(params, "state_dict") else params
    if head is None:
        head = "lm_head.weight" in sd
    tree = params_to_jax(dict(sd), dataclasses.replace(config, scan_layers=False), head=head)
    return _numpy_tree(tree)


def _numpy_tree(tree) -> Tree:
    if isinstance(tree, Mapping):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return _to_np(tree).astype(np.float32)


def _port_params(tree: Tree, config, dtype) -> Dict[str, torch.Tensor]:
    return params_from_jax(tree, dataclasses.replace(config, scan_layers=False), dtype)


def _dig(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _hf(sd: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32)) for k, v in sd.items()}


# --- GPT-2 ---------------------------------------------------------------------


def from_hf_gpt2(hf_model_or_dict, config, dtype=None) -> Dict[str, torch.Tensor]:
    """HF GPT-2 weights -> the port's state dict for ``GPTLM(config)``.

    ``config`` must match the checkpoint's structure (layers, heads, width,
    vocabulary; learned positions, gelu MLP, LayerNorm), checked as JAX's
    ``from_hf_gpt2`` checks it, in its words; the unrolled layout
    (``scan_layers=False``) as JAX asks for.  The position table keeps its
    first ``seq_len`` rows."""
    if config.positional != "learned" or config.mlp != "gelu" or config.norm != "layernorm":
        raise ValueError(
            "GPT-2 interop needs positional='learned', mlp='gelu', "
            "norm='layernorm'"
        )
    if config.scan_layers:
        raise ValueError(
            "from_hf_gpt2 emits the unrolled layout; build the config with "
            "scan_layers=False (stack leaves yourself for a scanned model)"
        )
    hf_config = getattr(hf_model_or_dict, "config", None)
    if hf_config is not None and getattr(hf_config, "n_head", None) not in (None, config.n_heads):
        # n_heads is not derivable from any tensor shape: a mismatch would
        # permute the qkv columns into garbage
        raise ValueError(
            f"checkpoint has n_head={hf_config.n_head}, config.n_heads="
            f"{config.n_heads}"
        )
    sd = _state_dict(hf_model_or_dict)
    ckpt_layers = 1 + max(int(k.split(".")[1]) for k in sd if k.startswith("h."))
    if ckpt_layers != config.n_layers:
        raise ValueError(
            f"checkpoint has {ckpt_layers} layers, config.n_layers="
            f"{config.n_layers} — refusing to silently truncate/underfill"
        )
    if sd["wpe.weight"].shape[0] < config.seq_len:
        raise ValueError(
            f"checkpoint position table covers {sd['wpe.weight'].shape[0]} "
            f"positions < config.seq_len={config.seq_len} (longer sequences "
            "would silently reuse clipped rows under jit)"
        )
    h = config.n_heads
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731

    def norm(prefix):
        return {"scale": f32(sd[f"{prefix}.weight"]), "bias": f32(sd[f"{prefix}.bias"])}

    wte = sd["wte.weight"]
    if wte.shape != (config.vocab_size, config.d_model):
        raise ValueError(f"wte {wte.shape} != (vocab={config.vocab_size}, d={config.d_model})")
    tree: Tree = {
        "embed": {"tok": {"embedding": f32(wte)},
                  "pos": {"embedding": f32(sd["wpe.weight"][:config.seq_len])}},
        "norm_final": norm("ln_f"),
        # GPT-2 ties the lm_head to wte
        "lm_head": {"shard": {"kernel": f32(wte.T)}},
        "blocks": {},
    }
    for i in range(config.n_layers):
        p = f"h.{i}"
        tree["blocks"][f"layer_{i}"] = {
            "norm_attn": norm(f"{p}.ln_1"),
            "norm_mlp": norm(f"{p}.ln_2"),
            "attn": {
                "qkv": {"shard": {"kernel": f32(_qkv_to_ours(sd[f"{p}.attn.c_attn.weight"], h)),
                                  "bias": f32(_qkv_to_ours(sd[f"{p}.attn.c_attn.bias"], h))}},
                "out": {"shard": {"kernel": f32(sd[f"{p}.attn.c_proj.weight"])},
                        "bias": f32(sd[f"{p}.attn.c_proj.bias"])},
            },
            "mlp": {
                "up": {"shard": {"kernel": f32(sd[f"{p}.mlp.c_fc.weight"]),
                                 "bias": f32(sd[f"{p}.mlp.c_fc.bias"])}},
                "down": {"shard": {"kernel": f32(sd[f"{p}.mlp.c_proj.weight"])},
                         "bias": f32(sd[f"{p}.mlp.c_proj.bias"])},
            },
        }
    return _port_params(tree, config, dtype)


def to_hf_gpt2(params, config, n_positions: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """The port's GPT-2 state dict (or ``GPTLM``) -> an HF GPT-2 state dict
    (``transformer.``-prefixed keys and ``lm_head.weight``) for
    ``GPT2LMHeadModel.load_state_dict``.  Refuses an lm_head that has
    drifted from the token table (GPT-2 ties them).  ``n_positions``: the
    HF model's position-table length; a shorter table (an import at a
    smaller ``seq_len``) is zero-padded out to it."""
    tree = _port_tree(params, config)
    h = config.n_heads
    g = lambda *path: np.asarray(_dig(tree, path), np.float32)  # noqa: E731
    wte = g("embed", "tok", "embedding")
    head = g("lm_head", "shard", "kernel").T
    if not np.allclose(wte, head, atol=1e-6):
        raise ValueError(
            "lm_head and wte have drifted apart (untied fine-tune?) — "
            "GPT-2's format ties them; refusing to drop one silently"
        )
    wpe = g("embed", "pos", "embedding")
    if n_positions is not None:
        if n_positions < wpe.shape[0]:
            raise ValueError(
                f"n_positions={n_positions} < trained position table "
                f"{wpe.shape[0]} — refusing to truncate trained rows"
            )
        if n_positions > wpe.shape[0]:
            wpe = np.concatenate([wpe, np.zeros((n_positions - wpe.shape[0], wpe.shape[1]),
                                                wpe.dtype)])
    sd: Dict[str, np.ndarray] = {
        "transformer.wte.weight": wte,
        "transformer.wpe.weight": wpe,
        "transformer.ln_f.weight": g("norm_final", "scale"),
        "transformer.ln_f.bias": g("norm_final", "bias"),
        "lm_head.weight": wte,
    }
    for i in range(config.n_layers):
        b = ("blocks", f"layer_{i}")
        p = f"transformer.h.{i}"
        sd[f"{p}.ln_1.weight"] = g(*b, "norm_attn", "scale")
        sd[f"{p}.ln_1.bias"] = g(*b, "norm_attn", "bias")
        sd[f"{p}.ln_2.weight"] = g(*b, "norm_mlp", "scale")
        sd[f"{p}.ln_2.bias"] = g(*b, "norm_mlp", "bias")
        sd[f"{p}.attn.c_attn.weight"] = _qkv_to_hf(g(*b, "attn", "qkv", "shard", "kernel"), h)
        sd[f"{p}.attn.c_attn.bias"] = _qkv_to_hf(g(*b, "attn", "qkv", "shard", "bias"), h)
        sd[f"{p}.attn.c_proj.weight"] = g(*b, "attn", "out", "shard", "kernel")
        sd[f"{p}.attn.c_proj.bias"] = g(*b, "attn", "out", "bias")
        sd[f"{p}.mlp.c_fc.weight"] = g(*b, "mlp", "up", "shard", "kernel")
        sd[f"{p}.mlp.c_fc.bias"] = g(*b, "mlp", "up", "shard", "bias")
        sd[f"{p}.mlp.c_proj.weight"] = g(*b, "mlp", "down", "shard", "kernel")
        sd[f"{p}.mlp.c_proj.bias"] = g(*b, "mlp", "down", "bias")
    return _hf(sd)


# --- Llama ---------------------------------------------------------------------


def _rope_perm(head_dim: int) -> np.ndarray:
    """HF-Llama -> the model's rope dimension order: ``perm[2j] = j``,
    ``perm[2j + 1] = j + head_dim / 2`` makes HF's rotate-half pairs the
    model's interleaved ones (same per-pair frequency); V and the output
    projection are untouched."""
    half = head_dim // 2
    perm = np.empty(head_dim, np.int64)
    perm[0::2] = np.arange(half)
    perm[1::2] = np.arange(half) + half
    return perm


def _check_llama(config) -> None:
    if config.positional != "rope" or config.mlp != "swiglu" or config.norm != "rmsnorm":
        raise ValueError(
            "Llama interop needs positional='rope', mlp='swiglu', "
            "norm='rmsnorm'"
        )


def from_hf_llama(hf_model_or_dict, config, dtype=None) -> Dict[str, torch.Tensor]:
    """HF Llama weights -> the port's state dict for ``GPTLM(config)``: MHA
    (fused qkv) or GQA (q and a fused per-kv-head kv), the rope
    permutation of q and k, RMSNorm scales, the bias-free swiglu MLP; the
    attention biases Llama lacks import as zeros.  A tied checkpoint
    without ``lm_head.weight`` takes the token table.  JAX's structural
    checks, in its words."""
    _check_llama(config)
    if config.scan_layers:
        raise ValueError("from_hf_llama emits the unrolled layout")
    hf_config = getattr(hf_model_or_dict, "config", None)
    if hf_config is not None:
        if getattr(hf_config, "num_attention_heads", config.n_heads) != config.n_heads:
            raise ValueError(
                f"checkpoint heads {hf_config.num_attention_heads} != "
                f"config.n_heads {config.n_heads}"
            )
        ckpt_kv = getattr(hf_config, "num_key_value_heads", None)
        ours_kv = config.n_kv_heads or config.n_heads
        if ckpt_kv is not None and ckpt_kv != ours_kv:
            raise ValueError(f"checkpoint kv heads {ckpt_kv} != config {ours_kv}")
        ckpt_eps = getattr(hf_config, "rms_norm_eps", None)
        if ckpt_eps is not None and abs(ckpt_eps - config.norm_eps) > 1e-12:
            raise ValueError(
                f"checkpoint rms_norm_eps={ckpt_eps} != config.norm_eps="
                f"{config.norm_eps} — logits would drift by ~1e-3; set "
                "norm_eps to match"
            )
        ckpt_theta = getattr(hf_config, "rope_theta", None)
        if ckpt_theta is not None and abs(ckpt_theta - config.rope_theta) > 1e-6:
            raise ValueError(f"checkpoint rope_theta={ckpt_theta} != config {config.rope_theta}")
    sd = {k.removeprefix("model."): v for k, v in _state_dict(hf_model_or_dict).items()}
    ckpt_layers = 1 + max(int(k.split(".")[1]) for k in sd if k.startswith("layers."))
    if ckpt_layers != config.n_layers:
        raise ValueError(
            f"checkpoint has {ckpt_layers} layers, config.n_layers="
            f"{config.n_layers}"
        )
    wte = sd["embed_tokens.weight"]
    if wte.shape != (config.vocab_size, config.d_model):
        raise ValueError(
            f"embed_tokens {wte.shape} != (vocab={config.vocab_size}, "
            f"d={config.d_model})"
        )
    if "lm_head.weight" not in sd:
        # tied-embedding checkpoints omit lm_head (it aliases embed_tokens)
        sd["lm_head.weight"] = wte
    d, h, dh = config.d_model, config.n_heads, config.head_dim
    kv = config.n_kv_heads or config.n_heads
    perm = _rope_perm(dh)
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731

    def heads_t(w, n):  # HF [n * dh, D] -> [D, n, dh]
        return w.T.reshape(d, n, dh)

    tree: Tree = {
        "embed": {"tok": {"embedding": f32(wte)}},
        "norm_final": {"scale": f32(sd["norm.weight"])},
        "lm_head": {"shard": {"kernel": f32(sd["lm_head.weight"].T)}},
        "blocks": {},
    }
    for i in range(config.n_layers):
        p = f"layers.{i}"
        q = heads_t(sd[f"{p}.self_attn.q_proj.weight"], h)[:, :, perm]
        k = heads_t(sd[f"{p}.self_attn.k_proj.weight"], kv)[:, :, perm]
        v = heads_t(sd[f"{p}.self_attn.v_proj.weight"], kv)
        if kv == h:
            # MHA: fused qkv, per-head [q | k | v] blocks
            attn = {"qkv": {"shard": {
                "kernel": f32(np.concatenate([q, k, v], axis=-1).reshape(d, 3 * d)),
                "bias": np.zeros((3 * d,), np.float32)}}}
        else:
            # GQA: q, and a fused per-kv-head [k | v]
            attn = {
                "q": {"shard": {"kernel": f32(q.reshape(d, h * dh)),
                                "bias": np.zeros((h * dh,), np.float32)}},
                "kv": {"shard": {
                    "kernel": f32(np.concatenate([k, v], axis=-1).reshape(d, kv * 2 * dh)),
                    "bias": np.zeros((kv * 2 * dh,), np.float32)}},
            }
        attn["out"] = {"shard": {"kernel": f32(sd[f"{p}.self_attn.o_proj.weight"].T)},
                       "bias": np.zeros((d,), np.float32)}
        tree["blocks"][f"layer_{i}"] = {
            "norm_attn": {"scale": f32(sd[f"{p}.input_layernorm.weight"])},
            "norm_mlp": {"scale": f32(sd[f"{p}.post_attention_layernorm.weight"])},
            "attn": attn,
            "mlp": {name: {"shard": {"kernel": f32(sd[f"{p}.mlp.{hf}.weight"].T)}}
                    for name, hf in (("gate", "gate_proj"), ("up", "up_proj"),
                                     ("down", "down_proj"))},
        }
    return _port_params(tree, config, dtype)


def to_hf_llama(params, config) -> Dict[str, torch.Tensor]:
    """The port's Llama state dict (or ``GPTLM``) -> an HF Llama state dict
    (``model.``-prefixed keys and ``lm_head.weight``) for
    ``LlamaForCausalLM.load_state_dict``: the inverse of
    :func:`from_hf_llama`.  Refuses a non-Llama architecture and non-zero
    attention biases (Llama has no slot for them), in JAX's words."""
    _check_llama(config)
    tree = _port_tree(params, config)
    d, h, dh = config.d_model, config.n_heads, config.head_dim
    kv = config.n_kv_heads or config.n_heads
    perm = _rope_perm(dh)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(dh)
    g = lambda *path: np.asarray(_dig(tree, path), np.float32)  # noqa: E731

    def check_zero_bias(node, path, name):
        try:
            b = np.asarray(_dig(node, path))
        except (KeyError, TypeError):
            return  # dense_bias=False: no bias param, nothing to drop
        if np.abs(b).max() > 1e-6:
            raise ValueError(
                f"{name} bias is nonzero (max |b| = {np.abs(b).max():.2e}); "
                "Llama has no bias slots — exporting would drop it. Zero "
                "the biases (or retrain without them: dense_bias=False)"
            )

    sd: Dict[str, np.ndarray] = {
        "model.embed_tokens.weight": g("embed", "tok", "embedding"),
        "model.norm.weight": g("norm_final", "scale"),
        "lm_head.weight": g("lm_head", "shard", "kernel").T,
    }
    for i in range(config.n_layers):
        ours = tree["blocks"][f"layer_{i}"]
        gl = lambda *path: np.asarray(_dig(ours, path), np.float32)  # noqa: E731
        p = f"model.layers.{i}"
        sd[f"{p}.input_layernorm.weight"] = gl("norm_attn", "scale")
        sd[f"{p}.post_attention_layernorm.weight"] = gl("norm_mlp", "scale")
        attn = ours["attn"]
        if kv == h:
            check_zero_bias(attn, ("qkv", "shard", "bias"), f"layer {i} qkv")
            qkv = gl("attn", "qkv", "shard", "kernel").reshape(d, h, 3 * dh)
            q, k, v = qkv[..., :dh], qkv[..., dh:2 * dh], qkv[..., 2 * dh:]
        else:
            check_zero_bias(attn, ("q", "shard", "bias"), f"layer {i} q")
            check_zero_bias(attn, ("kv", "shard", "bias"), f"layer {i} kv")
            q = gl("attn", "q", "shard", "kernel").reshape(d, h, dh)
            kvw = gl("attn", "kv", "shard", "kernel").reshape(d, kv, 2 * dh)
            k, v = kvw[..., :dh], kvw[..., dh:]
        check_zero_bias(attn, ("out", "bias"), f"layer {i} out")
        # undo the interleaved rope permutation of q and k (v untouched)
        sd[f"{p}.self_attn.q_proj.weight"] = q[:, :, inv].reshape(d, h * dh).T
        sd[f"{p}.self_attn.k_proj.weight"] = k[:, :, inv].reshape(d, kv * dh).T
        sd[f"{p}.self_attn.v_proj.weight"] = v.reshape(d, kv * dh).T
        sd[f"{p}.self_attn.o_proj.weight"] = gl("attn", "out", "shard", "kernel").T
        for hf_name, name in (("gate_proj", "gate"), ("up_proj", "up"), ("down_proj", "down")):
            sd[f"{p}.mlp.{hf_name}.weight"] = gl("mlp", name, "shard", "kernel").T
    return _hf(sd)


# --- BERT ----------------------------------------------------------------------


def _check_bert(config, export: bool = False) -> None:
    if config.prenorm or not config.embed_norm:
        raise ValueError(
            "BERT interop needs the post-norm variant: prenorm=False, "
            "embed_norm=True (see bert_base_hf)"
        )
    if export:
        if (config.positional != "learned" or config.mlp != "gelu_exact"
                or config.norm != "layernorm" or not config.bidirectional
                or (config.n_kv_heads or config.n_heads) != config.n_heads):
            raise ValueError(
                "BERT interop needs positional='learned', mlp='gelu_exact', "
                "norm='layernorm', bidirectional=True, no GQA"
            )
        return
    if (config.positional != "learned" or config.mlp != "gelu_exact"
            or config.norm != "layernorm" or not config.bidirectional):
        raise ValueError(
            "BERT interop needs positional='learned', mlp='gelu_exact', "
            "norm='layernorm', bidirectional=True"
        )
    if (config.n_kv_heads or config.n_heads) != config.n_heads:
        raise ValueError("BERT has no GQA: n_kv_heads must be None/n_heads")


def from_hf_bert(hf_model_or_dict, config, dtype=None
                 ) -> Tuple[Dict[str, torch.Tensor], Optional[Dict[str, torch.Tensor]]]:
    """HF BERT trunk weights -> ``(params, pooler)``: ``params`` the port's
    state dict for ``GPTLM(config)`` of a post-norm bidirectional config
    (``bert_base_hf``), its lm_head the tied word embedding (the MLM
    head's transform is not imported); ``pooler`` the
    ``EncoderClassifier``'s ``{"pooler.weight", "pooler.bias"}``, or None
    when the checkpoint has none (a ``BertForMaskedLM``'s, whose ``bert.``
    prefix is stripped).  Token-type row 0 is folded into the position
    table: exact for single-segment inputs (``token_type_ids == 0``).
    JAX's structural checks, in its words (BERT's 1e-12 LayerNorm epsilon
    among them)."""
    _check_bert(config)
    if config.scan_layers:
        raise ValueError(
            "from_hf_bert emits the unrolled layout; build the config with "
            "scan_layers=False"
        )
    sd = {k.removeprefix("bert."): v for k, v in _state_dict(hf_model_or_dict).items()}
    hf_config = getattr(hf_model_or_dict, "config", None)
    if hf_config is not None and getattr(
            hf_config, "num_attention_heads", config.n_heads) != config.n_heads:
        raise ValueError(
            f"checkpoint has num_attention_heads="
            f"{hf_config.num_attention_heads}, config.n_heads={config.n_heads}"
        )
    if hf_config is not None:
        hf_eps = getattr(hf_config, "layer_norm_eps", None)
        if hf_eps is not None and abs(hf_eps - config.norm_eps) > 1e-15:
            raise ValueError(
                f"checkpoint layer_norm_eps={hf_eps}, config.norm_eps="
                f"{config.norm_eps} (bert_base_hf sets 1e-12)"
            )
    ckpt_layers = 1 + max(int(k.split(".")[2]) for k in sd if k.startswith("encoder.layer."))
    if ckpt_layers != config.n_layers:
        raise ValueError(
            f"checkpoint has {ckpt_layers} layers, config.n_layers="
            f"{config.n_layers} — refusing to silently truncate/underfill"
        )
    wte = sd["embeddings.word_embeddings.weight"]
    if wte.shape != (config.vocab_size, config.d_model):
        raise ValueError(
            f"word_embeddings {wte.shape} != (vocab={config.vocab_size}, "
            f"d={config.d_model})"
        )
    wpe = sd["embeddings.position_embeddings.weight"]
    if wpe.shape[0] < config.seq_len:
        raise ValueError(
            f"checkpoint position table covers {wpe.shape[0]} positions < "
            f"config.seq_len={config.seq_len}"
        )
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    # token-type row 0 folded into the position table (see the docstring)
    tt0 = sd["embeddings.token_type_embeddings.weight"][0]
    tree: Tree = {
        "embed": {
            "tok": {"embedding": f32(wte)},
            "pos": {"embedding": f32(wpe[:config.seq_len] + tt0[None, :])},
            "norm": {"scale": f32(sd["embeddings.LayerNorm.weight"]),
                     "bias": f32(sd["embeddings.LayerNorm.bias"])},
        },
        # the tied word embedding as a serviceable lm_head
        "lm_head": {"shard": {"kernel": f32(wte.T)}},
        "blocks": {},
    }
    h = config.n_heads
    for i in range(config.n_layers):
        p = f"encoder.layer.{i}"
        # torch Linear weights are [out, in]: fuse q | k | v, then regroup
        # per head as the GPT-2 path does
        qkv_w = np.concatenate([sd[f"{p}.attention.self.{n}.weight"].T
                                for n in ("query", "key", "value")], axis=1)
        qkv_b = np.concatenate([sd[f"{p}.attention.self.{n}.bias"]
                                for n in ("query", "key", "value")])
        tree["blocks"][f"layer_{i}"] = {
            # post-norm: norm_attn / norm_mlp normalize the residual sums,
            # HF's attention.output.LayerNorm / output.LayerNorm
            "norm_attn": {"scale": f32(sd[f"{p}.attention.output.LayerNorm.weight"]),
                          "bias": f32(sd[f"{p}.attention.output.LayerNorm.bias"])},
            "norm_mlp": {"scale": f32(sd[f"{p}.output.LayerNorm.weight"]),
                         "bias": f32(sd[f"{p}.output.LayerNorm.bias"])},
            "attn": {
                "qkv": {"shard": {"kernel": f32(_qkv_to_ours(qkv_w, h)),
                                  "bias": f32(_qkv_to_ours(qkv_b, h))}},
                "out": {"shard": {"kernel": f32(sd[f"{p}.attention.output.dense.weight"].T)},
                        "bias": f32(sd[f"{p}.attention.output.dense.bias"])},
            },
            "mlp": {
                "up": {"shard": {"kernel": f32(sd[f"{p}.intermediate.dense.weight"].T),
                                 "bias": f32(sd[f"{p}.intermediate.dense.bias"])}},
                "down": {"shard": {"kernel": f32(sd[f"{p}.output.dense.weight"].T)},
                         "bias": f32(sd[f"{p}.output.dense.bias"])},
            },
        }
    pooler = None
    if "pooler.dense.weight" in sd:
        pooler = {"pooler.weight": torch.tensor(f32(sd["pooler.dense.weight"]),
                                                dtype=dtype or config.dtype),
                  "pooler.bias": torch.tensor(f32(sd["pooler.dense.bias"]),
                                              dtype=dtype or config.dtype)}
    return _port_params(tree, config, dtype), pooler


def to_hf_bert(params, config, pooler: Optional[Mapping[str, torch.Tensor]] = None,
               n_positions: Optional[int] = None,
               type_vocab_size: int = 2) -> Dict[str, torch.Tensor]:
    """The port's post-norm BERT parameters -> an HF ``BertModel`` state
    dict, the inverse of :func:`from_hf_bert`.  ``params``: a ``GPTLM``
    state dict (its lm_head, if any, is not exported) or an
    ``EncoderClassifier``'s (or either module); ``pooler``: the
    ``{"pooler.weight", "pooler.bias"}`` to export as ``pooler.dense``,
    by default an ``EncoderClassifier``'s own, none for a bare trunk.  The
    folded position table exports whole as ``position_embeddings`` with
    zero ``token_type_embeddings`` (the same function for
    ``token_type_ids == 0``); ``n_positions`` zero-pads it out."""
    _check_bert(config, export=True)
    sd_in = params.state_dict() if hasattr(params, "state_dict") else dict(params)
    if any(k.startswith("encoder.") for k in sd_in):
        if pooler is None:
            pooler = {k: sd_in[k] for k in ("pooler.weight", "pooler.bias")}
        sd_in = {k[len("encoder."):]: v for k, v in sd_in.items() if k.startswith("encoder.")}
    tree = _port_tree(sd_in, config)
    h, d = config.n_heads, config.d_model
    g = lambda *path: np.asarray(_dig(tree, path), np.float32)  # noqa: E731
    pos = g("embed", "pos", "embedding")
    if n_positions is not None:
        if n_positions < pos.shape[0]:
            raise ValueError(
                f"n_positions={n_positions} < trained position table "
                f"{pos.shape[0]} — refusing to silently truncate"
            )
        if n_positions > pos.shape[0]:
            pos = np.concatenate([pos, np.zeros((n_positions - pos.shape[0], pos.shape[1]),
                                                np.float32)])
    sd: Dict[str, np.ndarray] = {
        "embeddings.word_embeddings.weight": g("embed", "tok", "embedding"),
        "embeddings.position_embeddings.weight": pos,
        "embeddings.token_type_embeddings.weight": np.zeros((type_vocab_size, d), np.float32),
        "embeddings.LayerNorm.weight": g("embed", "norm", "scale"),
        "embeddings.LayerNorm.bias": g("embed", "norm", "bias"),
    }
    for i in range(config.n_layers):
        b = ("blocks", f"layer_{i}")
        p = f"encoder.layer.{i}"
        qkv_w = _qkv_to_hf(g(*b, "attn", "qkv", "shard", "kernel"), h)
        qkv_b = _qkv_to_hf(g(*b, "attn", "qkv", "shard", "bias"), h)
        for j, name in enumerate(("query", "key", "value")):
            sd[f"{p}.attention.self.{name}.weight"] = qkv_w[:, j * d:(j + 1) * d].T
            sd[f"{p}.attention.self.{name}.bias"] = qkv_b[j * d:(j + 1) * d]
        sd[f"{p}.attention.output.dense.weight"] = g(*b, "attn", "out", "shard", "kernel").T
        sd[f"{p}.attention.output.dense.bias"] = g(*b, "attn", "out", "bias")
        sd[f"{p}.attention.output.LayerNorm.weight"] = g(*b, "norm_attn", "scale")
        sd[f"{p}.attention.output.LayerNorm.bias"] = g(*b, "norm_attn", "bias")
        sd[f"{p}.intermediate.dense.weight"] = g(*b, "mlp", "up", "shard", "kernel").T
        sd[f"{p}.intermediate.dense.bias"] = g(*b, "mlp", "up", "shard", "bias")
        sd[f"{p}.output.dense.weight"] = g(*b, "mlp", "down", "shard", "kernel").T
        sd[f"{p}.output.dense.bias"] = g(*b, "mlp", "down", "bias")
        sd[f"{p}.output.LayerNorm.weight"] = g(*b, "norm_mlp", "scale")
        sd[f"{p}.output.LayerNorm.bias"] = g(*b, "norm_mlp", "bias")
    if pooler is not None:
        sd["pooler.dense.weight"] = _to_np(pooler["pooler.weight"]).astype(np.float32)
        sd["pooler.dense.bias"] = _to_np(pooler["pooler.bias"]).astype(np.float32)
    return _hf(sd)


# --- T5 ------------------------------------------------------------------------


def _check_t5(config, direction: str) -> None:
    """JAX's structural refusals of the T5 interop, in its words."""
    if config.positional != "relative" or config.norm != "rmsnorm":
        raise ValueError(
            "T5 interop needs positional='relative', norm='rmsnorm' "
            "(see t5_small_hf)"
        )
    if config.dense_bias or config.mlp not in ("relu", "geglu"):
        raise ValueError(
            "T5 interop needs dense_bias=False and mlp='relu' (original) "
            "or 'geglu' (v1.1)" if direction == "from" else
            "T5 interop needs dense_bias=False and mlp='relu' or 'geglu'"
        )
    if (config.n_kv_heads or config.n_heads) != config.n_heads:
        raise ValueError("T5 has no GQA: n_kv_heads must be None/n_heads")
    if config.scan_layers:
        raise ValueError(
            "from_hf_t5 emits the unrolled layout; build the config with "
            "scan_layers=False" if direction == "from" else
            "to_hf_t5 reads the unrolled layout; build the config with "
            "scan_layers=False"
        )


def from_hf_t5(hf_model_or_dict, config, dtype=None) -> Dict[str, torch.Tensor]:
    """HF T5 weights -> the port's state dict for ``EncoderDecoder(config)``
    of the T5-faithful variant (``t5_small_hf``: the relative bias, RMSNorm
    at the checkpoint's epsilon, bias-free projections, ``mlp="relu"`` or
    v1.1's ``"geglu"`` from ``wi_0``/``wi_1``), as JAX's ``from_hf_t5``:

    - the attention-scale fold: T5's scores are unscaled, the model scales q
      by ``1 / sqrt(head_dim)``, so the imported q weights (self and cross)
      are multiplied by ``sqrt(head_dim)``;
    - self-attention's q|k|v fused to the per-head layout, cross-attention's
      k|v interleaved per head (``CrossAttention.kv``);
    - one relative table per stack, read from block 0;
    - a tied checkpoint (no ``lm_head.weight``, or one equal to ``shared``,
      or ``tie_word_embeddings``): the head is ``shared.T * d_model**-0.5``,
      T5's tied-head rescale folded into the weight.

    The checks on the checkpoint's config are JAX's, in its words."""
    _check_t5(config, "from")
    sd = _state_dict(hf_model_or_dict)
    hf_config = getattr(hf_model_or_dict, "config", None)
    if hf_config is not None:
        for hf_name, ours in (
            ("num_heads", config.n_heads),
            ("num_layers", config.encoder_layers),
            ("num_decoder_layers", config.n_layers),
            ("relative_attention_num_buckets", config.rel_num_buckets),
            ("relative_attention_max_distance", config.rel_max_distance),
            # head_dim is d_model // n_heads here; T5 decouples d_kv
            ("d_kv", config.head_dim),
            ("d_ff", config.mlp_ratio * config.d_model),
        ):
            have = getattr(hf_config, hf_name, None)
            if have is not None and have != ours:
                raise ValueError(f"checkpoint {hf_name}={have} != config's {ours}")
        eps = getattr(hf_config, "layer_norm_epsilon", None)
        if eps is not None and abs(eps - config.norm_eps) > 1e-12:
            raise ValueError(
                f"checkpoint layer_norm_epsilon={eps}, config.norm_eps="
                f"{config.norm_eps} (t5_small_hf sets 1e-6)"
            )
    shared = sd["shared.weight"]
    if shared.shape != (config.vocab_size, config.d_model):
        raise ValueError(
            f"shared embedding {shared.shape} != (vocab={config.vocab_size},"
            f" d={config.d_model})"
        )
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    d, h, dh = config.d_model, config.n_heads, config.head_dim
    qscale = np.sqrt(dh).astype(np.float32)

    def rms(key):
        return {"scale": f32(sd[key])}

    def self_attn(p):
        qkv = np.concatenate([sd[f"{p}.q.weight"].T * qscale, sd[f"{p}.k.weight"].T,
                              sd[f"{p}.v.weight"].T], axis=1)
        return {"qkv": {"shard": {"kernel": f32(_qkv_to_ours(qkv, h))}},
                "out": {"shard": {"kernel": f32(sd[f"{p}.o.weight"].T)}}}

    def cross_attn(p):
        # k|v interleaved per head: [d, H, 2 dh] -> [d, 2 H dh]
        k = sd[f"{p}.k.weight"].T.reshape(d, h, dh)
        v = sd[f"{p}.v.weight"].T.reshape(d, h, dh)
        kv = np.concatenate([k, v], axis=-1).reshape(d, 2 * h * dh)
        return {"q": {"shard": {"kernel": f32(sd[f"{p}.q.weight"].T * qscale)}},
                "kv": {"shard": {"kernel": f32(kv)}},
                "out": {"shard": {"kernel": f32(sd[f"{p}.o.weight"].T)}}}

    def mlp(p):
        if config.mlp == "geglu":
            return {"gate": {"shard": {"kernel": f32(sd[f"{p}.wi_0.weight"].T)}},
                    "up": {"shard": {"kernel": f32(sd[f"{p}.wi_1.weight"].T)}},
                    "down": {"shard": {"kernel": f32(sd[f"{p}.wo.weight"].T)}}}
        return {"up": {"shard": {"kernel": f32(sd[f"{p}.wi.weight"].T)}},
                "down": {"shard": {"kernel": f32(sd[f"{p}.wo.weight"].T)}}}

    # T5 rescales the decoder output by d_model**-0.5 iff the head is tied (a
    # forward-pass behavior): folded into the head's weight
    tied = getattr(hf_config, "tie_word_embeddings", None)
    if "lm_head.weight" in sd:
        head = sd["lm_head.weight"].T
        if tied is None:
            tied = np.array_equal(sd["lm_head.weight"], shared)
        if tied:
            head = head * (config.d_model ** -0.5)
    else:
        head = shared.T * (config.d_model ** -0.5)
    bias = "layer.0.SelfAttention.relative_attention_bias.weight"
    tree: Tree = {
        "embed": {"tok": {"embedding": f32(shared)}},
        "enc_rel_bias": {"rel_embedding": f32(sd[f"encoder.block.0.{bias}"])},
        "dec_rel_bias": {"rel_embedding": f32(sd[f"decoder.block.0.{bias}"])},
        "enc_norm": rms("encoder.final_layer_norm.weight"),
        "dec_norm": rms("decoder.final_layer_norm.weight"),
        "lm_head": {"shard": {"kernel": f32(head)}},
        "encoder": {},
        "decoder": {},
    }
    for i in range(config.encoder_layers):
        p = f"encoder.block.{i}"
        tree["encoder"][f"layer_{i}"] = {
            "norm_attn": rms(f"{p}.layer.0.layer_norm.weight"),
            "norm_mlp": rms(f"{p}.layer.1.layer_norm.weight"),
            "attn": self_attn(f"{p}.layer.0.SelfAttention"),
            "mlp": mlp(f"{p}.layer.1.DenseReluDense"),
        }
    for i in range(config.n_layers):
        p = f"decoder.block.{i}"
        tree["decoder"][f"layer_{i}"] = {
            "norm_self": rms(f"{p}.layer.0.layer_norm.weight"),
            "norm_cross": rms(f"{p}.layer.1.layer_norm.weight"),
            "norm_mlp": rms(f"{p}.layer.2.layer_norm.weight"),
            "self_attn": self_attn(f"{p}.layer.0.SelfAttention"),
            "cross_attn": cross_attn(f"{p}.layer.1.EncDecAttention"),
            "mlp": mlp(f"{p}.layer.2.DenseReluDense"),
        }
    return _port_params(tree, config, dtype)


def to_hf_t5(params, config) -> Dict[str, torch.Tensor]:
    """The port's T5-faithful ``EncoderDecoder`` state dict (or module) -> an
    HF T5 state dict, the inverse of :func:`from_hf_t5`: the
    ``sqrt(head_dim)`` fold comes off the q weights, and the lm_head
    exports untied as it is (load it with ``tie_word_embeddings=False``, or
    compare against a tied model through the shared embedding).  Emits
    ``shared``, the per-stack ``embed_tokens`` aliases, the relative tables
    on block 0 and every block's self- and cross-attention, norms and MLP."""
    _check_t5(config, "to")
    tree = _port_tree(params, config, head=True)
    d, h, dh = config.d_model, config.n_heads, config.head_dim
    qscale = np.float32(1.0 / np.sqrt(dh))
    g = lambda *path: np.asarray(_dig(tree, path), np.float32)  # noqa: E731
    shared = g("embed", "tok", "embedding")
    bias = "layer.0.SelfAttention.relative_attention_bias.weight"
    sd: Dict[str, np.ndarray] = {
        "shared.weight": shared,
        "encoder.embed_tokens.weight": shared,
        "decoder.embed_tokens.weight": shared,
        f"encoder.block.0.{bias}": g("enc_rel_bias", "rel_embedding"),
        f"decoder.block.0.{bias}": g("dec_rel_bias", "rel_embedding"),
        "encoder.final_layer_norm.weight": g("enc_norm", "scale"),
        "decoder.final_layer_norm.weight": g("dec_norm", "scale"),
        "lm_head.weight": g("lm_head", "shard", "kernel").T,
    }

    def sub(node):
        return lambda *path: np.asarray(_dig(node, path), np.float32)

    def split_self(attn):
        qkv = _qkv_to_hf(sub(attn)("qkv", "shard", "kernel"), h)
        q, k, v = (qkv[:, j * d:(j + 1) * d] for j in range(3))
        return (q * qscale).T, k.T, v.T

    def split_cross(attn):
        q = sub(attn)("q", "shard", "kernel")
        kvw = sub(attn)("kv", "shard", "kernel").reshape(d, h, 2 * dh)
        k, v = kvw[..., :dh].reshape(d, h * dh), kvw[..., dh:].reshape(d, h * dh)
        return (q * qscale).T, k.T, v.T

    def mlp_keys(node, p):
        gm = sub(node)
        out = {}
        if config.mlp == "geglu":
            out[f"{p}.wi_0.weight"] = gm("gate", "shard", "kernel").T
            out[f"{p}.wi_1.weight"] = gm("up", "shard", "kernel").T
        else:
            out[f"{p}.wi.weight"] = gm("up", "shard", "kernel").T
        out[f"{p}.wo.weight"] = gm("down", "shard", "kernel").T
        return out

    for i in range(config.encoder_layers):
        ours = tree["encoder"][f"layer_{i}"]
        p = f"encoder.block.{i}"
        q, k, v = split_self(ours["attn"])
        go = sub(ours)
        sd.update({f"{p}.layer.0.SelfAttention.q.weight": q,
                   f"{p}.layer.0.SelfAttention.k.weight": k,
                   f"{p}.layer.0.SelfAttention.v.weight": v,
                   f"{p}.layer.0.SelfAttention.o.weight": go("attn", "out", "shard", "kernel").T,
                   f"{p}.layer.0.layer_norm.weight": go("norm_attn", "scale"),
                   f"{p}.layer.1.layer_norm.weight": go("norm_mlp", "scale")})
        sd.update(mlp_keys(ours["mlp"], f"{p}.layer.1.DenseReluDense"))
    for i in range(config.n_layers):
        ours = tree["decoder"][f"layer_{i}"]
        p = f"decoder.block.{i}"
        q, k, v = split_self(ours["self_attn"])
        cq, ck, cv = split_cross(ours["cross_attn"])
        go = sub(ours)
        sd.update({f"{p}.layer.0.SelfAttention.q.weight": q,
                   f"{p}.layer.0.SelfAttention.k.weight": k,
                   f"{p}.layer.0.SelfAttention.v.weight": v,
                   f"{p}.layer.0.SelfAttention.o.weight":
                       go("self_attn", "out", "shard", "kernel").T,
                   f"{p}.layer.1.EncDecAttention.q.weight": cq,
                   f"{p}.layer.1.EncDecAttention.k.weight": ck,
                   f"{p}.layer.1.EncDecAttention.v.weight": cv,
                   f"{p}.layer.1.EncDecAttention.o.weight":
                       go("cross_attn", "out", "shard", "kernel").T})
        for j, name in ((0, "norm_self"), (1, "norm_cross"), (2, "norm_mlp")):
            sd[f"{p}.layer.{j}.layer_norm.weight"] = go(name, "scale")
        sd.update(mlp_keys(ours["mlp"], f"{p}.layer.2.DenseReluDense"))
    return _hf(sd)
