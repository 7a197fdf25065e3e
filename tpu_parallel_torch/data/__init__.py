"""Data of the port: synthetic batches, token-stream and packed datasets,
the step-indexed loader and the global view of per-rank batches."""

from tpu_parallel_torch.data.loader import DataLoader, TokenDataset, make_global_batch, to_device
from tpu_parallel_torch.data.packed import PackedDataset
from tpu_parallel_torch.data.synthetic import classification_batch, lm_batch, seq2seq_batch

__all__ = ["DataLoader", "PackedDataset", "TokenDataset", "classification_batch", "lm_batch",
           "make_global_batch", "seq2seq_batch", "to_device"]
