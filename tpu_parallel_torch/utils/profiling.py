"""FLOP accounting: the port of ``tpu_parallel/utils/profiling.py`` (the
slice's part; the JAX package's TPU peak table stays behind)."""

from __future__ import annotations


def transformer_flops_per_token(cfg) -> float:
    """Training FLOPs per token: 6*N for the matmul params + attention term.

    PaLM-appendix accounting: 6 FLOPs per parameter per token (forward 2 +
    backward 4) over the matmul params (the untied lm_head included,
    embedding lookups excluded), plus ``12 * L * d * T`` for attention over
    ``T = seq_len`` (QK^T and PV, forward and backward).  A forward alone is
    a third of this.  MoE configs count active params (``moe_top_k``
    experts, or ``moe_capacity_factor`` under expert choice) plus the router.
    """
    mlp_term = 2 * cfg.mlp_ratio * cfg.d_model**2
    moe_experts = getattr(cfg, "moe_experts", 0)
    if moe_experts:
        k = (
            cfg.moe_top_k
            if getattr(cfg, "moe_router", "topk") == "topk"
            else getattr(cfg, "moe_capacity_factor", 1.0)
        )
        mlp_term = k * mlp_term + cfg.d_model * moe_experts  # + router
    matmul_params = (
        cfg.vocab_size * cfg.d_model  # lm_head projection
        + cfg.n_layers * (4 * cfg.d_model**2 + mlp_term)
    )
    attn = 12 * cfg.n_layers * cfg.d_model * cfg.seq_len
    return 6 * matmul_params + attn
