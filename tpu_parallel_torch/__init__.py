"""PyTorch/CUDA port of ``tpu_parallel`` for NVIDIA Hopper.

A second package beside the JAX one, with its module and function names.
It imports ``torch`` and never JAX or ``tpu_parallel``.  The flash-attention
forward is a hand-written CUDA kernel (``csrc/flash_fwd.cu``), built with
``nvcc`` at first use; everything the JAX package leaves to XLA is plain
PyTorch.  Entry points run on ``"cuda"`` unless given ``device="cpu"``.
"""

from tpu_parallel_torch.runtime import resolve_device

__all__ = ["resolve_device"]
