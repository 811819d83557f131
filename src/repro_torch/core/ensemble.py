"""Ensembles of parameter sets (one value per ensemble lane)."""

from __future__ import annotations

import torch

from repro_torch.core.constants import STOParams


def broadcast_params(base: STOParams, size: int, **sweeps) -> STOParams:
    """Ensemble of parameter sets with leaves shaped (E, 1).

    The (E, 1) trailing singleton broadcasts against per-oscillator arrays of
    shape (E, N). Any keyword in `sweeps` supplies a length-E array for that
    field; all other fields are tiled from `base`.
    """
    unknown = set(sweeps) - set(base._fields)
    if unknown:
        raise ValueError(f"unknown sweep fields: {sorted(unknown)}")
    ref = base.gamma
    leaves = {}
    for name in base._fields:
        if name in sweeps:
            v = torch.as_tensor(sweeps[name], dtype=ref.dtype, device=ref.device).reshape(size, 1)
        else:
            v = getattr(base, name).expand(size, 1)
        leaves[name] = v
    return STOParams(**leaves)
