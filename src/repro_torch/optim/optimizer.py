"""Optimizers (AdamW, Adafactor, SGD with momentum), the LR schedule,
clipping and gradient compression, as plain functions on trees.

The counterpart of the reference's optim/optimizer.py, rule for rule. The
update rules are the reference's, not torch.optim's: AdamW decays the f32
copy of the parameter inside the step (`p - lr * (m^/(sqrt(n^) + eps) + wd *
p)`, computed in f32 and cast back to the parameter's dtype), and Adafactor
is the reference's factored rule (row and column second moments for a leaf
whose last two dims exceed 1, the RMS update clip). The schedule and the
bias corrections are f32 tensors, as the reference's are.

States are trees of f32 tensors beside the parameters (the sorted-key order
of repro_torch.tree is jax's, so a checkpoint's names are the reference's).
`init(params, device=None)` puts them on `device` ("cuda" by default; raises
without a card unless device="cpu"; "meta" gives a template of shapes and
dtypes without storage, for restore_checkpoint). `update(params, grads, state, step)`
walks leaf by leaf under torch.no_grad(), so the f32 temporaries are one
leaf's at a time, and UPDATES params and state IN PLACE (the reference
returns new trees); it returns the same trees. `state_specs(mesh,
param_specs, params)` gives the states' layouts (distributed/sharding.py's
tuples) from the parameters'.

On a model axis wider than 1 (distributed/tensor_parallel.py active) the
leaves are a rank's blocks, and `dims` (one entry per leaf in jax's order:
the dim a leaf is split on over "model", or None) tells the functions that
take it which reductions span the whole leaf: `global_norm` sums a split
leaf's squares over the axis (one all-reduce for every split leaf) and
counts a replicated leaf once; Adafactor's row, column and update-RMS means
are over the whole leaf (an all-reduce of the block means wherever the
mean runs along the split dim); the int8 compressor's scale is the whole
leaf's max (a MAX all-reduce). AdamW and SGD are elementwise.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from repro_torch import tree
from repro_torch.device import resolve_device
from repro_torch.distributed import tensor_parallel as tp


class Optimizer(NamedTuple):
    name: str
    init: Callable  # (params, device=None) -> state
    update: Callable  # (params, grads, state, step, dims=None) -> (params, state), in place
    state_specs: Callable  # (mesh, param_specs, params) -> state layouts


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


def cosine_schedule(step, base_lr=3e-4, warmup=200, total=10_000, min_frac=0.1):
    """Linear warmup to base_lr over `warmup` steps, then a cosine decay to
    min_frac * base_lr at `total`; an f32 tensor (on step's device when step
    is a tensor)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(warmup, 1)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return base_lr * torch.where(step < warmup, warm, cos)


def _split(dims, i):
    """Whether leaf i is a block split over an active model axis."""
    return dims is not None and dims[i] is not None and tp.active() is not None


def global_norm(grads, dims=None) -> torch.Tensor:
    """sqrt of the sum over leaves (jax's order) of each leaf's f32 sum of
    squares; a leaf split over the model axis (dims) sums its blocks'."""
    sq = [torch.sum(torch.square(x.float())) for x in tree.leaves(grads)]
    split = [i for i in range(len(sq)) if _split(dims, i)]
    if split:
        whole = tp.reduce_from_model(torch.stack([sq[i] for i in split]))
        for j, i in enumerate(split):
            sq[i] = whole[j]
    return torch.sqrt(sum(sq))


def _mean(t, dim, split: bool):
    """t's mean along `dim` (every element where dim is None), over the
    whole leaf: the blocks' means averaged over the model axis where the
    mean runs along the split dim (blocks are equal in size)."""
    m = torch.mean(t) if dim is None else torch.mean(t, dim=dim)
    if split:
        m = tp.reduce_from_model(m) / tp.size()
    return m


def clip_by_global_norm(grads, max_norm, gnorm=None):
    """grads scaled by min(1, max_norm / (gnorm + 1e-9)), each in its dtype."""
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp(max_norm / (gnorm + 1e-9), max=1.0)
    return tree.tree_map(lambda x: x * scale.to(x.dtype), grads)


def _state_device(device) -> torch.device:
    return torch.device("meta") if device == "meta" else resolve_device(device)


def _zeros_f32(params, device):
    dev = _state_device(device)
    return tree.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=dev), params)


def _walk(params, grads, *states):
    """(param, grad, state...) per leaf in jax's order; a state may hold a
    subtree at a parameter's leaf (Adafactor's per-leaf dicts)."""
    flat = tree.leaves_with_path(params)
    gl = tree.leaves(grads)
    if len(gl) != len(flat):
        raise ValueError(f"grads have {len(gl)} leaves, params {len(flat)}")
    out = []
    for (path, p), g in zip(flat, gl):
        subs = []
        for s in states:
            for k in path:
                s = s[k]
            subs.append(s)
        out.append((p, g, *subs))
    return out


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def make_adamw(lr_fn=cosine_schedule, b1=0.9, b2=0.95, eps=1e-8, wd=0.1):
    def init(params, device=None):
        return {"mu": _zeros_f32(params, device), "nu": _zeros_f32(params, device)}

    @torch.no_grad()
    def update(params, grads, state, step, dims=None):
        walk = _walk(params, grads, state["mu"], state["nu"])
        if not walk:
            return params, state
        step_t = _f32(step, walk[0][0])
        step_f = step_t + 1.0
        lr = lr_fn(step_t)
        bc1 = 1.0 - b1**step_f
        bc2 = 1.0 - b2**step_f
        for p, g, mu, nu in walk:
            g = g.float()
            mu.copy_(b1 * mu + (1 - b1) * g)
            nu.copy_(b2 * nu + (1 - b2) * g * g)
            delta = (mu / bc1) / (torch.sqrt(nu / bc2) + eps) + wd * p.float()
            p.copy_((p.float() - lr * delta).to(p.dtype))
        return params, state

    def state_specs(mesh, param_specs, params):
        return {"mu": param_specs, "nu": param_specs}

    return Optimizer("adamw", init, update, state_specs)


# ---------------------------------------------------------------------------
# Adafactor (factored second moments, no first moment)
# ---------------------------------------------------------------------------


def _factored(p) -> bool:
    return len(p.shape) >= 2 and p.shape[-1] > 1 and p.shape[-2] > 1


def make_adafactor(lr_fn=cosine_schedule, eps=1e-30, clip_thresh=1.0, wd=0.0):
    def init(params, device=None):
        dev = _state_device(device)
        zeros = lambda shape: torch.zeros(shape, dtype=torch.float32, device=dev)  # noqa: E731

        def st(p):
            if _factored(p):
                return {"vr": zeros(p.shape[:-1]), "vc": zeros(p.shape[:-2] + p.shape[-1:])}
            return {"v": zeros(p.shape)}

        return tree.tree_map(st, params)

    @torch.no_grad()
    def update(params, grads, state, step, dims=None):
        walk = _walk(params, grads, state)
        if not walk:
            return params, state
        step_t = _f32(step, walk[0][0])
        lr = lr_fn(step_t)
        beta2 = 1.0 - (step_t + 1.0) ** -0.8
        for i, (p, g, s) in enumerate(walk):
            split = _split(dims, i)
            d = dims[i] % p.dim() if split else None
            g = g.float()
            g2 = g * g + eps
            if _factored(p):
                last, second = p.dim() - 1, p.dim() - 2
                vr = beta2 * s["vr"] + (1 - beta2) * _mean(g2, -1, d == last)
                vc = beta2 * s["vc"] + (1 - beta2) * _mean(g2, -2, d == second)
                denom = _mean(vr, -1, d == second)[..., None]
                pre = (vr / torch.clamp(denom, min=eps))[..., None] * vc[..., None, :]
                u = g * torch.rsqrt(torch.clamp(pre, min=eps))
                s["vr"].copy_(vr)
                s["vc"].copy_(vc)
            else:
                v = beta2 * s["v"] + (1 - beta2) * g2
                u = g * torch.rsqrt(torch.clamp(v, min=eps))
                s["v"].copy_(v)
            # update clipping (Adafactor's RMS rule)
            rms = torch.sqrt(_mean(u * u, None, split) + 1e-30)
            u = u / torch.clamp(rms / clip_thresh, min=1.0)
            delta = u + wd * p.float()
            p.copy_((p.float() - lr * delta).to(p.dtype))
        return params, state

    def state_specs(mesh, param_specs, params):
        def st(spec, p):
            if _factored(p):
                # vr drops the last dim's entry, vc the second-to-last's
                full = tuple(spec) + (None,) * (len(p.shape) - len(spec))
                return {"vr": full[:-1], "vc": full[:-2] + full[-1:]}
            return {"v": spec}

        return tree.tree_map(st, param_specs, params)

    return Optimizer("adafactor", init, update, state_specs)


# ---------------------------------------------------------------------------
# SGD with momentum
# ---------------------------------------------------------------------------


def make_sgd(lr_fn=cosine_schedule, momentum=0.9):
    def init(params, device=None):
        return {"mom": _zeros_f32(params, device)}

    @torch.no_grad()
    def update(params, grads, state, step, dims=None):
        walk = _walk(params, grads, state["mom"])
        if not walk:
            return params, state
        lr = lr_fn(_f32(step, walk[0][0]))
        for p, g, m in walk:
            m.copy_(momentum * m + g.float())
            p.copy_((p.float() - lr * m).to(p.dtype))
        return params, state

    def state_specs(mesh, param_specs, params):
        return {"mom": param_specs}

    return Optimizer("sgd", init, update, state_specs)


def make_optimizer(name: str, cfg=None, lr_fn=cosine_schedule) -> Optimizer:
    if name == "adamw":
        return make_adamw(lr_fn=lr_fn)
    if name == "adafactor":
        return make_adafactor(lr_fn=lr_fn)
    if name == "sgd":
        return make_sgd(lr_fn=lr_fn)
    raise ValueError(name)


# ---------------------------------------------------------------------------
# Gradient compression
# ---------------------------------------------------------------------------


def make_compressor(kind: str):
    """Per-tensor int8 quantize -> dequantize on a gradient tree ("int8"),
    or the identity ("none"): compress(grads, dims=None).

    The value effect of an int8 gradient exchange, applied in place of it,
    as the reference applies it; the byte effect on the wire is
    distributed/collectives.compressed_psum's. A leaf split over the model
    axis (dims) takes the whole leaf's scale."""
    if kind == "none":
        return lambda g, dims=None: g
    if kind == "int8":

        def q(g, split):
            gf = g.float()
            top = gf.abs().max()
            if split:
                top = tp.max_over_model(top)
            scale = torch.clamp(top, min=1e-12) / 127.0
            qi = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
            return (qi.float() * scale).to(g.dtype)

        def compress(grads, dims=None):
            out = [q(g, _split(dims, i)) for i, g in enumerate(tree.leaves(grads))]
            return tree.unflatten(grads, out)

        return compress
    raise ValueError(kind)
