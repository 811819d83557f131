"""Optimizers, the LR schedule, clipping and gradient compression on trees
of tensors (the reference's repro.optim)."""

from repro_torch.optim import optimizer
from repro_torch.optim.optimizer import (
    Optimizer,
    clip_by_global_norm,
    cosine_schedule,
    global_norm,
    make_adafactor,
    make_adamw,
    make_compressor,
    make_optimizer,
    make_sgd,
)

__all__ = [
    "Optimizer", "clip_by_global_norm", "cosine_schedule", "global_norm", "make_adafactor",
    "make_adamw", "make_compressor", "make_optimizer", "make_sgd", "optimizer",
]
