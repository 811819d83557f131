"""xLSTM blocks: mLSTM (matrix memory, attention-like parallel train form,
O(1) recurrent decode) and sLSTM (scalar memory with recurrent gating,
sequential scan), with arXiv:2405.04517's stabilised exponential gating.

The counterpart of the reference's models/xlstm.py, op for op. Both blocks
carry their own projections (the xLSTM "block" includes the up/down
projection sandwich) and their own residuals, so the transformer assembly
gives them x, not a normed x, and uses mlp="none".

mLSTM keeps the reference's stabilised parallel form (NEG_INF = -1e30 for
the masked gates, the running max m, the normaliser max(|sum w|, exp(-m)))
and its q-chunked branch for long prefills: at _MLSTM_CHUNK_THRESHOLD tokens
and above, when _MLSTM_CHUNK divides S, the (T, S) gate and score tensors are
built _MLSTM_CHUNK query rows at a time. The reference reads both from its
REPRO_MLSTM_* environment variables; here they are module constants at the
reference's defaults.

sLSTM runs its recurrence as a Python loop over the tokens (the reference's
lax.scan), with the recurrent matrices and biases cast to f32 once, outside
the loop (the reference casts them inside its step: the same values). The
reference's REPRO_SLSTM_CHUNK, a rematerialisation knob for the backward
pass whose default (0) is the unchunked scan, is not carried, as
REPRO_REMAT_POLICY is not (models/transformer.py).

Both decodes write their new states IN PLACE into the cache dict they are
given (the reference returns new ones): the transformer's decode hands a
layer views of the period-stacked cache leaves and ignores what it returns.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import require_full_f32_matmul
from repro_torch.models.layers import (
    TensorSpec, _normal, apply_mlp, apply_norm, dense, make_dense, make_mlp, make_norm,
)
from repro_torch.models.mamba import _conv_causal

NEG_INF = -1e30
_MLSTM_CHUNK_THRESHOLD = 8192
_MLSTM_CHUNK = 1024


def _full_f32(x):
    if x.device.type == "cuda":
        require_full_f32_matmul()


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def _mlstm_dims(cfg: ModelConfig):
    di = int(cfg.xlstm.mlstm_proj_factor * cfg.d_model)
    return di, cfg.num_heads, di // cfg.num_heads


def make_mlstm(generator, cfg: ModelConfig, dtype):
    xc = cfg.xlstm
    d = cfg.d_model
    di, h, _ = _mlstm_dims(cfg)
    dev = generator.device
    return {
        "norm": make_norm(cfg.norm_type, d, dtype, dev),
        "up_proj": make_dense(generator, d, 2 * di, dtype),
        "conv_w": _normal(generator, (xc.conv_kernel, di), 0.1, dtype),
        "conv_b": torch.zeros((di,), dtype=dtype, device=dev),
        "wq": make_dense(generator, di, di, dtype),
        "wk": make_dense(generator, di, di, dtype),
        "wv": make_dense(generator, di, di, dtype),
        "w_if": make_dense(generator, di, 2 * h, dtype),  # input & forget gates / head
        "hnorm": make_norm("rmsnorm", di, dtype, dev),
        "down_proj": make_dense(
            generator, di, d, dtype, scale=di**-0.5 / (2.0 * cfg.num_layers) ** 0.5
        ),
    }


def _mlstm_qkvgates(p, cfg: ModelConfig, x_in, conv_tail=None):
    di = p["wq"]["kernel"].shape[0]
    h = cfg.num_heads
    dh = di // h
    up = dense(p["up_proj"], x_in)
    xm, z = up[..., :di], up[..., di:]
    xcv, tail = _conv_causal(p["conv_w"], p["conv_b"], xm, conv_tail)
    xcv = F.silu(xcv)
    b, s, _ = xm.shape
    q = dense(p["wq"], xcv).reshape(b, s, h, dh)
    k = dense(p["wk"], xcv).reshape(b, s, h, dh) * dh**-0.5
    v = dense(p["wv"], xm).reshape(b, s, h, dh)
    gates = dense(p["w_if"], xm).float()  # (B, S, 2H)
    i_pre, f_pre = gates[..., :h], gates[..., h:]
    return q, k, v, i_pre, f_pre, z, tail, (h, dh)


def mlstm_forward(p, cfg: ModelConfig, x, *, return_cache=False):
    """Parallel (quadratic) stabilised form for train / prefill; the (T, S)
    gate / score tensors are q-chunked at _MLSTM_CHUNK_THRESHOLD tokens and
    above, so long prefills never materialise (S x S)."""
    _full_f32(x)
    xn = apply_norm(p["norm"], x)
    q, k, v, i_pre, f_pre, z, tail, (h, dh) = _mlstm_qkvgates(p, cfg, xn)
    b, s = q.shape[:2]

    logf = F.logsigmoid(f_pre)  # (B, S, H)
    cumf = torch.cumsum(logf, dim=1)
    kf, vf = k.float(), v.float()
    spos = torch.arange(s, device=x.device)

    def hid_chunk(q_c, cumf_c, t0, ct):
        """Stabilised mLSTM rows for global q positions [t0, t0 + ct)."""
        ld = cumf_c[:, :, None, :] - cumf[:, None, :, :] + i_pre[:, None, :, :]  # (B, ct, S, H)
        tpos = t0 + torch.arange(ct, device=x.device)
        ld = torch.where((tpos[None, :, None, None] >= spos[None, None, :, None]), ld, NEG_INF)
        m = torch.amax(ld, dim=2, keepdim=True)  # (B, ct, 1, H)
        dmat = torch.exp(ld - m)
        scores = torch.einsum("bthd,bshd->btsh", q_c.float(), kf)
        w = scores * dmat
        norm = torch.maximum(torch.abs(torch.sum(w, dim=2)), torch.exp(-m[:, :, 0]))
        return torch.einsum("btsh,bshd->bthd", w, vf) / norm[..., None]

    if s >= _MLSTM_CHUNK_THRESHOLD and s % _MLSTM_CHUNK == 0:
        hid = torch.cat([
            hid_chunk(q[:, t0 : t0 + _MLSTM_CHUNK], cumf[:, t0 : t0 + _MLSTM_CHUNK], t0,
                      _MLSTM_CHUNK)
            for t0 in range(0, s, _MLSTM_CHUNK)
        ], dim=1)
    else:
        hid = hid_chunk(q, cumf, 0, s)

    hid = hid.reshape(b, s, h * dh).to(x.dtype)
    hid = apply_norm(p["hnorm"], hid) * F.silu(z)
    out = x + dense(p["down_proj"], hid)
    if not return_cache:
        return out
    # the recurrent state equivalent to having consumed the sequence
    return out, _mlstm_state_from_seq(q, k, v, i_pre, f_pre, tail)


def _mlstm_state_from_seq(q, k, v, i_pre, f_pre, tail):
    """Fold a full sequence into the recurrent (C, n, m) state (prefill)."""
    logf = F.logsigmoid(f_pre)
    cumf = torch.cumsum(logf, dim=1)
    total = cumf[:, -1]  # (B, H)
    # weight of step t in the final state: exp(totalF - cumF_t + i_t - mT)
    lw = total[:, None] - cumf + i_pre  # (B, S, H)
    m_t = torch.amax(lw, dim=1)  # (B, H)
    wgt = torch.exp(lw - m_t[:, None])
    kf, vf = k.float(), v.float()
    c = torch.einsum("bsh,bshd,bshe->bhde", wgt, kf, vf)
    n = torch.einsum("bsh,bshd->bhd", wgt, kf)
    return {"c": c, "n": n, "m": m_t, "conv_tail": tail}


def mlstm_decode(p, cfg: ModelConfig, x, cache):
    """One-token step. x: (B, 1, D). Writes c, n, m and conv_tail into
    `cache` IN PLACE and returns (out, cache)."""
    _full_f32(x)
    xn = apply_norm(p["norm"], x)
    q, k, v, i_pre, f_pre, z, tail, (h, dh) = _mlstm_qkvgates(p, cfg, xn, cache["conv_tail"])
    b = x.shape[0]
    q, k, v = q[:, 0].float(), k[:, 0].float(), v[:, 0].float()  # (B, H, dh)
    i_pre, f_pre = i_pre[:, 0], f_pre[:, 0]  # (B, H)
    logf_m = F.logsigmoid(f_pre) + cache["m"]  # the reference's logf + m, summed once
    m_new = torch.maximum(logf_m, i_pre)
    fw = torch.exp(logf_m - m_new)[..., None]
    iw = torch.exp(i_pre - m_new)[..., None]
    c = fw[..., None] * cache["c"] + iw[..., None] * torch.einsum("bhd,bhe->bhde", k, v)
    n = fw * cache["n"] + iw * k
    num = torch.einsum("bhde,bhd->bhe", c, q)
    den = torch.maximum(torch.abs(torch.einsum("bhd,bhd->bh", n, q)), torch.exp(-m_new))
    hid = (num / den[..., None]).reshape(b, 1, h * dh).to(x.dtype)
    hid = apply_norm(p["hnorm"], hid) * F.silu(z)
    out = x + dense(p["down_proj"], hid)
    for key, new in (("c", c), ("n", n), ("m", m_new), ("conv_tail", tail)):
        cache[key].copy_(new)
    return out, cache


def mlstm_cache_spec(cfg: ModelConfig, batch: int, dtype):
    di, h, dh = _mlstm_dims(cfg)
    return {
        "c": TensorSpec((batch, h, dh, dh), torch.float32),
        "n": TensorSpec((batch, h, dh), torch.float32),
        "m": TensorSpec((batch, h), torch.float32),
        "conv_tail": TensorSpec((batch, cfg.xlstm.conv_kernel - 1, di), dtype),
    }


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def make_slstm(generator, cfg: ModelConfig, dtype):
    d = cfg.d_model
    h, dh = cfg.num_heads, d // cfg.num_heads
    df = int(cfg.xlstm.slstm_proj_factor * d)
    dev = generator.device
    return {
        "norm": make_norm(cfg.norm_type, d, dtype, dev),
        "w_gates": make_dense(generator, d, 4 * d, dtype),  # i, f, z, o pre-acts
        # per-head recurrent matrices (block-diagonal R)
        "r_gates": _normal(generator, (4, h, dh, dh), dh**-0.5, dtype),
        "b_gates": torch.zeros((4, d), dtype=dtype, device=dev),
        "hnorm": make_norm("rmsnorm", d, dtype, dev),
        "ffn_norm": make_norm(cfg.norm_type, d, dtype, dev),
        "ffn": make_mlp(generator, d, df, "gelu", dtype,
                        out_scale=df**-0.5 / (2.0 * cfg.num_layers) ** 0.5),
    }


def _slstm_recurrent(p, cfg: ModelConfig):
    """The step's f32 recurrent matrices (4, H, dh, dh) and biases (1, 4, H,
    dh)."""
    return p["r_gates"].float(), p["b_gates"].float().reshape(1, 4, cfg.num_heads, -1)


def _slstm_step(r, bias, wx_t, state):
    """wx_t: (B, 4, H, dh) input pre-activations; r, bias from
    _slstm_recurrent; state: (c, n, m, h_prev)."""
    c, n, m, h_prev = state
    rh = torch.einsum("ghde,bhe->bghd", r, h_prev)
    pre = wx_t + rh + bias
    i_p, f_p, z_p, o_p = pre.unbind(1)
    logf_m = F.logsigmoid(f_p) + m  # the reference's logf + m, summed once
    m_new = torch.maximum(logf_m, i_p)
    i_w = torch.exp(i_p - m_new)
    f_w = torch.exp(logf_m - m_new)
    z = torch.tanh(z_p)
    o = torch.sigmoid(o_p)
    c_new = f_w * c + i_w * z
    n_new = f_w * n + i_w
    h_new = o * c_new / torch.clamp(n_new, min=1.0)
    return (c_new, n_new, m_new, h_new)


def _slstm_init_state(b, h, dh, device):
    z = torch.zeros((b, h, dh), dtype=torch.float32, device=device)
    return (z, z, torch.full((b, h, dh), 0.0, dtype=torch.float32, device=device), z)


def _slstm_out(p, x, hid):
    """The block's output from the hidden states: hnorm, the residual, then
    the gelu FFN with its own norm and residual."""
    y = x + apply_norm(p["hnorm"], hid.to(x.dtype))
    return y + apply_mlp(p["ffn"], apply_norm(p["ffn_norm"], y), "gelu")


def slstm_forward(p, cfg: ModelConfig, x, *, return_cache=False):
    _full_f32(x)
    b, s, d = x.shape
    h, dh = cfg.num_heads, d // cfg.num_heads
    xn = apply_norm(p["norm"], x)
    wx = dense(p["w_gates"], xn).float().reshape(b, s, 4, h, dh)
    r, bias = _slstm_recurrent(p, cfg)
    state = _slstm_init_state(b, h, dh, x.device)
    hs = []
    for wx_t in wx.unbind(1):
        state = _slstm_step(r, bias, wx_t, state)
        hs.append(state[3])
    y = _slstm_out(p, x, torch.stack(hs, dim=1).reshape(b, s, d))
    if not return_cache:
        return y
    c, n, m, hp = state
    return y, {"c": c, "n": n, "m": m, "h": hp}


def slstm_decode(p, cfg: ModelConfig, x, cache):
    """One-token step. x: (B, 1, D). Writes c, n, m and h into `cache` IN
    PLACE and returns (y, cache)."""
    _full_f32(x)
    b, _, d = x.shape
    h, dh = cfg.num_heads, d // cfg.num_heads
    xn = apply_norm(p["norm"], x)
    wx = dense(p["w_gates"], xn).float().reshape(b, 4, h, dh)
    r, bias = _slstm_recurrent(p, cfg)
    new = _slstm_step(r, bias, wx, (cache["c"], cache["n"], cache["m"], cache["h"]))
    y = _slstm_out(p, x, new[3].reshape(b, 1, d))
    for key, t in zip(("c", "n", "m", "h"), new):
        cache[key].copy_(t)
    return y, cache


def slstm_cache_spec(cfg: ModelConfig, batch: int, dtype):
    h, dh = cfg.num_heads, cfg.d_model // cfg.num_heads
    sd = TensorSpec((batch, h, dh), torch.float32)
    return {"c": sd, "n": sd, "m": sd, "h": sd}
