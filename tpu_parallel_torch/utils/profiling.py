"""FLOP accounting and MFU: the port of ``tpu_parallel/utils/profiling.py``.

The JAX package's table holds TPU peaks; this one holds NVIDIA's dense bf16
tensor-core peaks (data sheets, without sparsity), chosen by the card's name.
"""

from __future__ import annotations

from typing import Optional

import torch

# Dense bf16 peak FLOP/s by card name, matched as a lowercase substring of
# the name torch.cuda.get_device_name / nvidia-smi report ("NVIDIA H100 80GB
# HBM3" is the SXM part).  Cards not listed give None.
PEAK_FLOPS_BY_NAME = {
    "h100 pcie": 756e12,
    "h100 sxm": 989e12,
    "h100 80gb hbm3": 989e12,
}


def peak_flops(device=None) -> Optional[float]:
    """Peak dense bf16 FLOP/s of ``device``: a torch device (default: the
    current CUDA device, if any) or a card name as nvidia-smi prints it.
    None when unknown, e.g. on the CPU."""
    if isinstance(device, str) and device.split(":")[0] not in ("cpu", "cuda", "meta"):
        name = device
    else:
        if device is None:
            device = "cuda" if torch.cuda.is_available() else "cpu"
        device = torch.device(device)
        if device.type != "cuda":
            return None
        name = torch.cuda.get_device_name(device)
    name = name.lower()
    for key, value in PEAK_FLOPS_BY_NAME.items():
        if key in name:
            return value
    return None


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


def mfu(tokens_per_sec: float, cfg, device=None) -> Optional[float]:
    """Model FLOPs utilization of one device: training FLOPs per token times
    tokens/s over the device's peak; None when the peak is unknown."""
    peak = peak_flops(device)
    if peak is None:
        return None
    return tokens_per_sec * transformer_flops_per_token(cfg) / peak
