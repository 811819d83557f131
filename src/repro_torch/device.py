"""Explicit device placement for the port's entry points.

Every entry point takes `device=` and defaults to "cuda". Without a card it
raises instead of running on the CPU: the CPU runs the kernels' plain
PyTorch versions, and a caller gets them only by asking for device="cpu".
"""

from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack


def resolve_device(device=None) -> torch.device:
    """torch.device for `device` ("cuda" when None); raises if CUDA is asked
    for and absent, except inside a dry run's FakeTensorMode
    (`dry_run_mode`), whose CUDA tensors need no card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available() and not _in_fake_mode():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be a cuda or cpu device; got {dev}")
    return dev


def require_full_f32_matmul() -> None:
    """Switch TF32 off for products on the card, and check that it is off:
    precision None/"highest" means full-f32 products."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise RuntimeError("TF32 products are on; the plain versions need full f32")


def dry_run_mode() -> FakeTensorMode:
    """The FakeTensorMode of a dry run (launch/dryrun.py): inside it
    resolve_device allows "cuda" without a card, and a real tensor reaching
    an op raises, so a module that materialises a constant shows."""
    mode = FakeTensorMode(allow_non_fake_inputs=False)
    mode.dry_run = True
    return mode


def _in_fake_mode() -> bool:
    return any(getattr(m, "dry_run", False) for m in _get_current_dispatch_mode_stack())
