"""Device selection for the port's entry points.

Entry points take an explicit ``device`` that defaults to ``"cuda"``.  With
no GPU a CUDA device raises; nothing moves to the CPU unless the caller asks
for it (the CPU tests pass ``device="cpu"``).
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device(device)``, raising when it names CUDA and there is no
    CUDA device."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path"
        )
    return dev
