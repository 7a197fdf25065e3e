"""Data of the port (synthetic batches)."""

from tpu_parallel_torch.data.synthetic import lm_batch

__all__ = ["lm_batch"]
