"""Explicit device placement for the port's entry points.

Every entry point takes `device=` and defaults to "cuda". Without a card it
raises instead of running on the CPU: the CPU runs the kernels' plain
PyTorch versions, and a caller gets them only by asking for device="cpu".
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """torch.device for `device` ("cuda" when None); raises if CUDA is asked
    for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be a cuda or cpu device; got {dev}")
    return dev
