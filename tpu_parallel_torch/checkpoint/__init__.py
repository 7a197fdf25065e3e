"""Checkpoints of the port: train-state checkpoints with resume and drift
restore, and the serving weight sets with their manifests."""

from tpu_parallel_torch.checkpoint.io import (
    Checkpointer,
    WeightManifest,
    WeightsCorrupt,
    latest_weights_step,
    load_serving_weights,
    params_fingerprint,
    save_serving_weights,
)

__all__ = [
    "Checkpointer",
    "WeightManifest",
    "WeightsCorrupt",
    "latest_weights_step",
    "load_serving_weights",
    "params_fingerprint",
    "save_serving_weights",
]
