"""Parallel strategies of the port: data parallelism, FSDP over the data
axis, the SPMD train functions, and the export of mesh-trained params."""

from tpu_parallel_torch.parallel import dp, fsdp, spmd, tp

__all__ = ["dp", "fsdp", "spmd", "tp"]
