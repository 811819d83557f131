"""Carry weights and state across from the reference package.

The reference's SimSpec leaves, readouts, per-tenant parameters, online
learners' (P, W) lanes and session checkpoints, and its LM parameter,
KV-cache and optimizer-state pytrees, reach the port as numpy arrays
(`np.asarray` of each leaf); these converters rebuild the port's objects
from them on `device`, so both packages compute the same thing from the
same numbers. A session checkpoint also goes the other way
(`checkpoint_to_numpy`), so a session moves between the two packages'
engines and fleet replicas in either direction, and so do LM parameters and
optimizer states (`lm_params_to_numpy`, `opt_state_to_numpy`), so tests hold
the two packages' trees leaf for leaf. Nothing here imports the reference.
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
from repro_torch.serve.state_store import _host


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


def checkpoint_to_numpy(ckpt: SessionCheckpoint) -> dict:
    """The port's SessionCheckpoint as plain fields for the reference: a dict
    keyed by the SessionCheckpoint's field names, every array a numpy copy
    and every scalar a Python value. params become a dict of numpy leaves by
    STOParams field, and a spec a dict of numpy leaves and scalars by
    SimSpec field (its params such a dict too), from which the reference
    rebuilds its own STOParams and SimSpec. The reverse of
    `checkpoint_from_numpy`: a session checkpointed on the port's engine (or
    a fleet replica) restores on the reference's."""

    def arr(x):
        return None if x is None else np.array(_host(x))

    def leaves(params):
        return {f: np.array(_host(v)) for f, v in zip(STOParams._fields, params)}

    spec = None
    if ckpt.spec is not None:
        spec = dict(
            ckpt.spec._asdict(),
            params=leaves(ckpt.spec.params),
            w_cp=arr(ckpt.spec.w_cp), w_in=arr(ckpt.spec.w_in), m0=arr(ckpt.spec.m0),
        )
    return dict(
        sid=int(ckpt.sid),
        u_seq=arr(ckpt.u_seq),
        t=int(ckpt.t),
        m=arr(ckpt.m),
        params=None if ckpt.params is None else leaves(ckpt.params),
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
        spec=spec,
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


# the reference optimizers' state keys: a tree per key (AdamW, SGD), or one
# dict per parameter leaf (Adafactor: factored vr / vc, else v)
_OPT_KEYS = {"adamw": {"mu", "nu"}, "sgd": {"mom"}}
_ADAFACTOR_LEAVES = ({"vr", "vc"}, {"v"})


def _adafactor_leaves(state):
    if isinstance(state, dict) and set(state) in _ADAFACTOR_LEAVES:
        return [set(state)]
    items = state.values() if isinstance(state, dict) else state
    return [keys for v in items for keys in _adafactor_leaves(v)]


def opt_state_from_numpy(name: str, tree, device="cuda"):
    """The port's optimizer state for optimizer `name` ("adamw": mu / nu,
    "adafactor": vr / vc or v per parameter, "sgd": mom) from the
    reference's state pytree with every leaf `np.asarray`'d."""
    state = _tree_from_numpy(tree, resolve_device(device))
    if name in _OPT_KEYS:
        if not isinstance(state, dict) or set(state) != _OPT_KEYS[name]:
            raise ValueError(f"{name} state needs the keys {sorted(_OPT_KEYS[name])}")
    elif name == "adafactor":
        if not _adafactor_leaves(state):
            raise ValueError("adafactor state needs a vr / vc or v dict per parameter")
    else:
        raise ValueError(f"unknown optimizer {name!r}")
    return state


def _tree_to_numpy(tree):
    """Nested dicts/lists of tensors -> the same structure of numpy copies
    (a bf16 leaf as float32, which holds its values exactly: numpy has no
    bf16)."""
    if isinstance(tree, Mapping):
        return {k: _tree_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_to_numpy(v) for v in tree]
    t = tree.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()


def lm_params_to_numpy(params):
    """The port's LM parameters as numpy leaves (bf16 as exact float32)."""
    return _tree_to_numpy(params)


def opt_state_to_numpy(state):
    """An optimizer state of the port as numpy leaves."""
    return _tree_to_numpy(state)
