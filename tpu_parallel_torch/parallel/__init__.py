"""Parallel strategies of the port (data parallelism so far)."""

from tpu_parallel_torch.parallel import dp

__all__ = ["dp"]
