"""Carry weights and state across from the reference package.

The reference's SimSpec leaves, readouts and per-tenant parameters, and its
LM parameter and KV-cache pytrees, reach the port as numpy arrays
(`np.asarray` of each leaf); these converters rebuild the port's objects from
them on `device`, so both packages compute the same thing from the same
numbers. Nothing here imports the reference.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.api.spec import SimSpec, validate_topology
from repro_torch.configs.base import ModelConfig
from repro_torch.core.constants import STOParams
from repro_torch.core.reservoir import Readout
from repro_torch.device import resolve_device
from repro_torch.models import transformer


def _tensor(x, dev, dtype=None) -> torch.Tensor:
    return torch.tensor(np.asarray(x), dtype=dtype).to(dev)  # a copy: the leaf stays the caller's


def params_from_numpy(params, device="cuda", dtype=None) -> STOParams:
    """STOParams from numpy leaves: a mapping by field name, an object with
    the fields as attributes (the reference's STOParams after np.asarray of
    each leaf), or a sequence in field order. Leaves keep their shape (0-d
    or (E, 1)); dtype None keeps each leaf's dtype."""
    dev = resolve_device(device)
    if isinstance(params, Mapping):
        leaves = [params[f] for f in STOParams._fields]
    elif all(hasattr(params, f) for f in STOParams._fields):
        leaves = [getattr(params, f) for f in STOParams._fields]
    else:
        leaves = list(params)
        if len(leaves) != len(STOParams._fields):
            raise ValueError(
                f"params needs {len(STOParams._fields)} leaves in the order "
                f"{STOParams._fields}; got {len(leaves)}"
            )
    return STOParams(*(_tensor(v, dev, dtype) for v in leaves))


def spec_from_numpy(params, w_cp, w_in, m0, dt, hold_steps, device="cuda") -> SimSpec:
    """The port's coupled-array SimSpec from the reference SimSpec's leaves
    as numpy arrays. The state dtype is m0's; params follow it."""
    dev = resolve_device(device)
    m0_t = _tensor(m0, dev)
    spec = SimSpec(
        params=params_from_numpy(params, dev, m0_t.dtype),
        w_cp=_tensor(w_cp, dev),
        w_in=_tensor(w_in, dev, m0_t.dtype),
        m0=m0_t,
        dt=float(dt),
        hold_steps=int(hold_steps),
    )
    validate_topology(spec)
    return spec


def readout_from_numpy(w_out, washout: int, device="cuda") -> Readout:
    """A Readout ((N+1, n_out) weights, last row the bias) from numpy."""
    return Readout(w_out=_tensor(w_out, resolve_device(device)), washout=int(washout))


def _tree_from_numpy(tree, dev):
    """Nested dicts/lists of numpy leaves -> the same structure of tensors
    (bf16 leaves arrive as ml_dtypes bfloat16 and are carried bit for bit)."""
    if isinstance(tree, Mapping):
        return {k: _tree_from_numpy(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_from_numpy(v, dev) for v in tree]
    a = np.asarray(tree)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16).to(dev)
    return torch.from_numpy(a.copy()).to(dev)


def lm_params_from_numpy(cfg: ModelConfig, tree, device="cuda"):
    """The port's LM parameters from the reference's `init_params` pytree with
    every leaf `np.asarray`'d. The two layouts are the same leaf for leaf:
    the period-stacked "stack" leaves keep their leading num_periods axis."""
    transformer.check_supported(cfg)
    params = _tree_from_numpy(tree, resolve_device(device))
    want = ("embed", "final_norm") + (() if cfg.tie_embeddings else ("lm_head",))
    missing = [k for k in want if k not in params]
    if missing:
        raise ValueError(f"{cfg.name}: parameter tree lacks {missing}")
    return params


def lm_caches_from_numpy(tree, device="cuda"):
    """The port's KV caches from the reference's cache pytree (prefill's or
    decode's, numpy leaves); period-stacked caches keep their leading
    num_periods axis."""
    return _tree_from_numpy(tree, resolve_device(device))
