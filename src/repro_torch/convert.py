"""Carry weights and state across from the reference package.

The reference's SimSpec leaves, readouts, per-tenant parameters, online
learners' (P, W) lanes and session checkpoints, and its LM parameter and
KV-cache pytrees, reach the port as numpy arrays (`np.asarray` of each leaf); these converters rebuild
the port's objects from them on `device`, so both packages compute the same
thing from the same numbers. Nothing here imports the reference.
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
from repro_torch.serve.reservoir import SessionCheckpoint


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


def spec_from_numpy(
    params, w_cp, w_in, m0, dt, hold_steps, tableau="rk4", topology="coupled_array",
    readout_window=0, device="cuda",
) -> SimSpec:
    """The port's SimSpec from the reference SimSpec's leaves as numpy arrays
    (any physics family). The state dtype is m0's; params follow it."""
    dev = resolve_device(device)
    m0_t = _tensor(m0, dev)
    spec = SimSpec(
        params=params_from_numpy(params, dev, m0_t.dtype),
        w_cp=_tensor(w_cp, dev),
        w_in=_tensor(w_in, dev, m0_t.dtype),
        m0=m0_t,
        dt=float(dt),
        hold_steps=int(hold_steps),
        tableau=str(tableau),
        topology=str(topology),
        readout_window=int(readout_window),
    )
    validate_topology(spec)
    return spec


def readout_from_numpy(w_out, washout: int, device="cuda") -> Readout:
    """A Readout ((N+1, n_out) weights, last row the bias) from numpy."""
    return Readout(w_out=_tensor(w_out, resolve_device(device)), washout=int(washout))


def learn_state_from_numpy(P, W, device="cuda"):
    """The (P, W) learn lanes of `CompiledSim.tick_chunk` from the
    reference's as numpy: P (E, S, S) or None (learn="lms"), W (E, S,
    n_out)."""
    dev = resolve_device(device)
    return (None if P is None else _tensor(P, dev)), _tensor(W, dev)


def checkpoint_from_numpy(ckpt) -> SessionCheckpoint:
    """The port's SessionCheckpoint from any object with the reference
    SessionCheckpoint's fields (its arrays are already host numpy): a
    session checkpointed on the reference engine then restores on the
    port's through `ReservoirEngine.restore_session`. Arrays are copied;
    params become 0-d CPU tensors (`params_from_numpy`), and a mixed-spec
    tenant's spec a SimSpec on the CPU (`spec_from_numpy`), which routes the
    restored session as the reference's engine routed it."""

    def arr(x):
        return None if x is None else np.array(x)

    return SessionCheckpoint(
        sid=int(ckpt.sid),
        u_seq=np.array(ckpt.u_seq),
        t=int(ckpt.t),
        m=arr(ckpt.m),
        params=None if ckpt.params is None else params_from_numpy(ckpt.params, device="cpu"),
        readout_w=arr(ckpt.readout_w),
        readout_washout=int(ckpt.readout_washout),
        collect_states=bool(ckpt.collect_states),
        targets=arr(ckpt.targets),
        learn_washout=int(ckpt.learn_washout),
        open=bool(ckpt.open),
        n_out=int(ckpt.n_out),
        states=arr(ckpt.states),
        outs=arr(ckpt.outs),
        preds=arr(ckpt.preds),
        P=arr(ckpt.P),
        Wl=arr(ckpt.Wl),
        spec=None if ckpt.spec is None else _spec_from_leaves(ckpt.spec),
    )


def _spec_from_leaves(spec) -> SimSpec:
    """A SimSpec on the CPU from an object with the reference SimSpec's
    fields (numpy or array leaves)."""
    return spec_from_numpy(
        spec.params, spec.w_cp, spec.w_in, spec.m0, spec.dt, spec.hold_steps,
        tableau=spec.tableau, topology=spec.topology,
        readout_window=spec.readout_window, device="cpu",
    )


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
