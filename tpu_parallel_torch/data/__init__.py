"""Data of the port: synthetic batches, token-stream and packed datasets,
and the step-indexed loader."""

from tpu_parallel_torch.data.loader import DataLoader, TokenDataset, to_device
from tpu_parallel_torch.data.packed import PackedDataset
from tpu_parallel_torch.data.synthetic import lm_batch

__all__ = ["DataLoader", "PackedDataset", "TokenDataset", "lm_batch", "to_device"]
