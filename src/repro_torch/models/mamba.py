"""Mamba-1 selective SSM mixer (jamba's sequence mixer).

The counterpart of the reference's models/mamba.py, op for op.

Train / prefill: a chunked scan over time. The outer Python loop over
chunks carries the (B, d_inner, d_state) f32 SSM state; within a chunk the
recurrence h_t = dA_t * h_{t-1} + dBx_t runs as a sequential loop over the
chunk's steps (torch has no associative_scan; the reference's
lax.associative_scan sums the same products in a tree, so the two agree to
f32 rounding, not bit for bit). `chunk` bounds the materialised (B, chunk,
d_inner, d_state) discretised tensors: nothing of shape (B, S, d_inner,
d_state) exists, and the peak extra memory is one chunk's, as in the
reference. Steps that pad the last chunk are identity transitions (dA = 1,
dBx = 0).

Decode: one O(1) recurrent step on {h, conv_tail}, written IN PLACE into the
cache dict it is given (the reference returns a new one): the transformer's
decode hands a layer views of the period-stacked cache leaves and ignores
what the layer returns.

On a model axis wider than 1 (distributed/tensor_parallel.py; the
reference's `constrain` calls put d_inner on it) a rank holds its block of
d_inner: in_proj is column-parallel, but its contiguous block does not
respect the x | z split (on 2 ranks rank 0 holds all of x, rank 1 all of
z), so its output is gathered whole (layers.whole_cols: one all-gather a
call) and the rank takes its block of x and of z; conv_w / conv_b, dt_proj
(column-parallel, its bias a block), a_log and d_skip are d_inner blocks;
x_proj is row-parallel (one all-reduce makes dt, B and C whole before their
norms); out_proj is row-parallel. The chunked scan and the states h and
conv_tail are the rank's d_inner block, with no collective.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import require_full_f32_matmul
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.models.layers import (
    TensorSpec, _normal, apply_norm, col_dense, make_dense, make_norm, row_dense, whole_cols,
)


def _dims(cfg: ModelConfig):
    mc = cfg.mamba
    d_inner = mc.expand * cfg.d_model
    dt_rank = mc.dt_rank or -(-cfg.d_model // 16)  # ceil(d/16)
    return mc, d_inner, dt_rank


def _uniform(generator, shape):
    """U[0, 1) f32 draws from `generator` (meta tensors for a template)."""
    if generator.device.type == "meta":
        return torch.empty(shape, dtype=torch.float32, device="meta")
    return torch.rand(shape, generator=generator, device=generator.device, dtype=torch.float32)


def make_mamba(generator, cfg: ModelConfig, dtype):
    mc, di, dtr = _dims(cfg)
    ds = mc.d_state
    dev = generator.device
    out_scale = di**-0.5 / (2.0 * cfg.num_layers) ** 0.5
    # S4-style A init: A_log = log(1..d_state) broadcast over channels, f32
    # whatever the model's dtype
    a_init = torch.log(torch.arange(1, ds + 1, dtype=torch.float32, device=dev))
    # dt_init log-uniform in [1e-3, 0.1], floored at 1e-4; the bias is its
    # inverse softplus
    lo, hi = math.log(0.001), math.log(0.1)
    dt_init = torch.clamp(torch.exp(_uniform(generator, (di,)) * (hi - lo) + lo), min=1e-4)
    return {
        "in_proj": make_dense(generator, cfg.d_model, 2 * di, dtype),
        "conv_w": _normal(generator, (mc.d_conv, di), 0.1, dtype),
        "conv_b": torch.zeros((di,), dtype=dtype, device=dev),
        "x_proj": make_dense(generator, di, dtr + 2 * ds, dtype),
        "dt_proj": {
            "kernel": _normal(generator, (dtr, di), dtr**-0.5, dtype),
            "bias": torch.log(torch.exp(dt_init) - 1.0 + 1e-9).to(dtype),
        },
        "a_log": a_init.expand(di, ds).contiguous(),
        "d_skip": torch.ones((di,), dtype=dtype, device=dev),
        # jamba normalizes dt/B/C
        "dt_norm": make_norm("rmsnorm", dtr, dtype, dev),
        "b_norm": make_norm("rmsnorm", ds, dtype, dev),
        "c_norm": make_norm("rmsnorm", ds, dtype, dev),
        "out_proj": make_dense(generator, di, cfg.d_model, dtype, scale=out_scale),
    }


def _conv_causal(w, b, x, tail=None):
    """Depthwise causal conv along S. x: (B, S, di); w: (K, di).

    tail: (B, K-1, di) previous inputs for decode continuity (None = zeros).
    Returns (y, new_tail); new_tail is a view of a new tensor."""
    k = w.shape[0]
    if tail is None:
        tail = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    xp = torch.cat([tail, x], dim=1)  # (B, S+K-1, di)
    y = sum(xp[:, i : i + x.shape[1]] * w[i] for i in range(k)) + b
    new_tail = xp[:, -(k - 1) :] if k > 1 else tail
    return y, new_tail


def _ssm_inputs(p, cfg: ModelConfig, xc):
    """Shared discretisation: xc (B, S, di) -> (dA, dBx, C), f32.

    Only ever called on short windows (decode: S = 1; prefill and train: one
    chunk at a time), so the (B, S, di, ds) tensors stay chunk-sized."""
    mc, _, dtr = _dims(cfg)
    ds = mc.d_state
    xdb = row_dense(p["x_proj"], xc)  # (B, S, dtr + 2 ds), whole
    # the normed dt, B and C are whole; each rank reads them for its d_inner
    dt = tp.copy_to_model(apply_norm(p["dt_norm"], xdb[..., :dtr]))
    bc = tp.copy_to_model(apply_norm(p["b_norm"], xdb[..., dtr : dtr + ds]))
    cc = tp.copy_to_model(apply_norm(p["c_norm"], xdb[..., dtr + ds :]))
    dt = F.softplus(col_dense(p["dt_proj"], dt).float())  # (B, S, di)
    a = -torch.exp(p["a_log"])  # (di, ds)
    da = torch.exp(dt[..., None] * a)  # (B, S, di, ds)
    dbx = (dt * xc.float())[..., None] * bc.float()[..., None, :]  # (B, S, di, ds)
    return da, dbx, cc.float()


def _chunk_states(da, dbx, h):
    """h_t = da_t * h_{t-1} + dbx_t over a chunk's steps (axis 1) from the
    carried state h (B, di, ds): every step's state, (B, chunk, di, ds)."""
    hs = []
    for da_t, dbx_t in zip(da.unbind(1), dbx.unbind(1)):
        h = torch.addcmul(dbx_t, da_t, h)
        hs.append(h)
    return torch.stack(hs, dim=1)


def _gate_output(p, y, xc, z, dtype):
    """The skip connection and the silu(z) gate, in f32, cast to the model's
    dtype."""
    y = y + p["d_skip"].float() * xc.float()
    return (y * F.silu(z.float())).to(dtype)


def _x_and_z(p, cfg: ModelConfig, x):
    """in_proj's x and z parts, the rank's d_inner block of each."""
    _, di, _ = _dims(cfg)
    xz = whole_cols(p["in_proj"], x, 2 * di)
    local = p["conv_w"].shape[1]
    return tp.local_slice(xz[..., :di], local), tp.local_slice(xz[..., di:], local)


def mamba_forward(p, cfg: ModelConfig, x, *, return_cache=False):
    """x: (B, S, D) -> (B, S, D) (+ decode cache {h, conv_tail}).

    Discretisation, the scan and the C projection all run one chunk at a
    time, so nothing of shape (B, S, di, ds) materialises; peak extra memory
    is (B, chunk, di, ds)."""
    mc, _, _ = _dims(cfg)
    ds = mc.d_state
    b, s, _ = x.shape
    di = p["conv_w"].shape[1]  # the rank's d_inner
    if x.device.type == "cuda":
        require_full_f32_matmul()
    x1, z = _x_and_z(p, cfg, x)
    xc, tail = _conv_causal(p["conv_w"], p["conv_b"], x1)
    xc = F.silu(xc)

    chunk = min(mc.chunk, s)
    s_pad = -(-s // chunk) * chunk
    xc_p = F.pad(xc, (0, 0, 0, s_pad - s)) if s_pad != s else xc
    h = torch.zeros((b, di, ds), dtype=torch.float32, device=x.device)
    ys = []
    for lo in range(0, s_pad, chunk):
        da, dbx, cc = _ssm_inputs(p, cfg, xc_p[:, lo : lo + chunk])
        if lo + chunk > s:  # padded steps are identity transitions: h_t = 1*h + 0
            vm = (torch.arange(lo, lo + chunk, device=x.device) < s)[None, :, None, None]
            da = torch.where(vm, da, 1.0)
            dbx = torch.where(vm, dbx, 0.0)
        h_all = _chunk_states(da, dbx, h)  # (B, chunk, di, ds)
        ys.append(torch.einsum("bsdn,bsn->bsd", h_all, cc))  # (B, chunk, di)
        h = h_all[:, -1]
    y = torch.cat(ys, dim=1)[:, :s]
    out = row_dense(p["out_proj"], _gate_output(p, y, xc, z, x.dtype))
    if return_cache:  # h: a copy, not a view that keeps the last chunk alive
        return out, {"h": h.clone(), "conv_tail": tail}
    return out


def mamba_decode(p, cfg: ModelConfig, x, cache):
    """One-token recurrent step. x: (B, 1, D). Writes the new h and
    conv_tail into `cache` IN PLACE and returns (y, cache)."""
    if x.device.type == "cuda":
        require_full_f32_matmul()
    x1, z = _x_and_z(p, cfg, x)
    xc, tail = _conv_causal(p["conv_w"], p["conv_b"], x1, cache["conv_tail"])
    xc = F.silu(xc)
    da, dbx, cc = _ssm_inputs(p, cfg, xc)  # (B, 1, di, ds)
    h = da[:, 0] * cache["h"] + dbx[:, 0]  # (B, di, ds)
    y = torch.einsum("bdn,bn->bd", h, cc[:, 0])[:, None]  # (B, 1, di)
    out = row_dense(p["out_proj"], _gate_output(p, y, xc, z, x.dtype))
    cache["h"].copy_(h)
    cache["conv_tail"].copy_(tail)
    return out, cache


def mamba_cache_spec(cfg: ModelConfig, batch: int, dtype):
    mc, di, _ = _dims(cfg)
    return {
        "h": TensorSpec((batch, di, mc.d_state), torch.float32),
        "conv_tail": TensorSpec((batch, mc.d_conv - 1, di), dtype),
    }
