"""Shared config plumbing: the port of ``configs/common.py``.

The JAX configs are ``ml_collections.ConfigDict``s, which accept a CLI
override only on a declared field; the card has no ``ml_collections``, so
the port's configs are plain dicts with the same keys and values, and
``tpu_parallel_torch.configs.override`` applies ``--config.<key>=<value>``
on declared keys only, typed from the declared default.  Every config
declares the commonly tuned model knobs here, with the JAX package's
defaults.
"""

from typing import Any, Dict

# the model-shape knobs the JAX configs declare as ml_collections
# placeholders: None (keep the model's default; the Trainer drops
# None-valued overrides), typed for CLI overrides
PLACEHOLDER_TYPES = dict(
    bidirectional=bool,
    vocab_size=int,
    seq_len=int,
    n_layers=int,
    d_model=int,
    n_heads=int,
    n_kv_heads=int,
)


# the encoder-decoder's placeholders, declared by its config alone
SEQ2SEQ_PLACEHOLDER_TYPES = dict(
    enc_layers=int,
    src_seq_len=int,
)


def model_overrides(**kw) -> Dict[str, Any]:
    """The declared model overrides with the JAX package's defaults
    (behavior-neutral), updated by ``kw``."""
    base = dict(
        # attention: "xla" | "flash" | "ring" | "ulysses" (the last two shard the
        # sequence over a seq mesh axis)
        attn_impl="xla",
        flash_block_q=512,
        flash_block_k=512,
        # sliding-window attention (0 = full causal)
        attn_window=0,
        # remat: "full" | "proj" | "proj_attn" | "dots" (remat=False to disable)
        remat=True,
        remat_policy="full",
        scan_layers=True,
        dropout_rate=0.0,
        loss_chunk=0,
        # MoE routing family (only meaningful with moe_experts > 0)
        moe_router="topk",
        **{name: None for name in PLACEHOLDER_TYPES},
    )
    base.update(kw)
    return base
