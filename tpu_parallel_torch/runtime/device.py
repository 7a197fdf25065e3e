"""Device selection for the port's entry points.

Entry points take an explicit ``device`` that defaults to ``"cuda"``.  With
no GPU a CUDA device raises; nothing moves to the CPU unless the caller asks
for it (the CPU tests pass ``device="cpu"``).  Under a process group a bare
``"cuda"`` means this process's card, the one :func:`runtime.initialize`
made current (``cuda:{LOCAL_RANK}`` under torchrun).
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device(device)``, raising when it names CUDA and there is no
    CUDA device; a CUDA device without an index takes the current one when
    a process group is up."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path"
        )
    if dev.type == "cuda" and dev.index is None and torch.distributed.is_initialized():
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
