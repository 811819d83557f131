"""Shared model layers: norms, MLPs, RoPE, embeddings, the LM head and the
cross-entropy losses.

The counterpart of the reference's models/layers.py. Params are plain
nested dicts of tensors with the reference's names and layouts:

    kernel shapes: (in, out) for projections, (vocab, d) for embeddings.
    Names: w_in/w_gate/w_out (mlp), wq/wk/wv/wo (attention), embed, lm_head.

Initialisers draw from an explicit `torch.Generator` (on its own device) and
return tensors on that device; they do not reproduce the reference's
jax.random draws (tests carry the reference's weights across instead,
convert.lm_params_from_numpy). Casts follow the reference op for op: `dense`
multiplies in the parameter dtype, norms and RoPE compute in f32 and cast
back, `lm_logits` and the cross-entropy functions multiply f32-cast operands
(full f32 on the card: TF32 off). The reference's `constrain` calls on the
logits are not carried: they are inert without a model axis, and the port
trains data-parallel only (distributed/sharding.py).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.device import require_full_f32_matmul


class TensorSpec(NamedTuple):
    """Shape and dtype of a tensor that is not allocated (the reference's
    jax.ShapeDtypeStruct)."""

    shape: tuple
    dtype: torch.dtype


def _normal(generator, shape, scale, dtype):
    if generator.device.type == "meta":  # a template (transformer.param_template)
        return torch.empty(shape, dtype=dtype, device="meta")
    x = torch.randn(shape, generator=generator, device=generator.device, dtype=torch.float32)
    return (scale * x).to(dtype)


def make_dense(generator, d_in, d_out, dtype, scale: Optional[float] = None, bias=False):
    if scale is None:
        scale = d_in**-0.5
    p = {"kernel": _normal(generator, (d_in, d_out), scale, dtype)}
    if bias:
        p["bias"] = torch.zeros((d_out,), dtype=dtype, device=generator.device)
    return p


def dense(p, x):
    y = x @ p["kernel"]
    if "bias" in p:
        y = y + p["bias"]
    return y


# --- norms -----------------------------------------------------------------


def make_norm(norm_type: str, d: int, dtype, device):
    if norm_type == "rmsnorm":
        return {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if norm_type == "layernorm":
        return {
            "scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device),
        }
    raise ValueError(norm_type)


def apply_norm(p, x, eps: float = 1e-6):
    xf = x.float()
    if "bias" in p:  # layernorm
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + eps)
        return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


# --- MLPs ------------------------------------------------------------------


def make_mlp(generator, d_model, d_ff, mlp_type, dtype, bias=False, out_scale=None):
    p = {}
    if mlp_type in ("swiglu", "geglu"):
        p["w_gate"] = make_dense(generator, d_model, d_ff, dtype, bias=bias)
    p["w_in"] = make_dense(generator, d_model, d_ff, dtype, bias=bias)
    p["w_out"] = make_dense(generator, d_ff, d_model, dtype, scale=out_scale, bias=bias)
    return p


def apply_mlp(p, x, mlp_type):
    if mlp_type == "swiglu":
        h = F.silu(dense(p["w_gate"], x)) * dense(p["w_in"], x)
    elif mlp_type == "geglu":
        h = F.gelu(dense(p["w_gate"], x), approximate="tanh") * dense(p["w_in"], x)
    elif mlp_type == "gelu":
        h = F.gelu(dense(p["w_in"], x), approximate="tanh")
    else:
        raise ValueError(mlp_type)
    return dense(p["w_out"], h)


# --- rotary embeddings -------------------------------------------------------


def rope_freqs(positions: torch.Tensor, dim: int, theta: float) -> torch.Tensor:
    """(..., S) int positions -> (..., S, dim/2) f32 angles."""
    exponent = torch.arange(0, dim, 2, dtype=torch.float32, device=positions.device) / dim
    inv = 1.0 / (theta**exponent)
    return positions.float()[..., None] * inv


def apply_rope(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x: (..., S, H, D); angles: (..., S, D/2). Rotates the first half of
    the head dims against the second half (half-split, as the reference's
    code does), in f32, and casts back."""
    d = x.shape[-1]
    x1 = x[..., : d // 2].float()
    x2 = x[..., d // 2 :].float()
    cos = torch.cos(angles)[..., None, :]  # broadcast over heads
    sin = torch.sin(angles)[..., None, :]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --- embeddings ----------------------------------------------------------------


def make_embedding(generator, vocab_padded: int, d: int, dtype):
    return {"embed": _normal(generator, (vocab_padded, d), 0.02, dtype)}


def embed_tokens(p, tokens: torch.Tensor, scale: bool = False):
    x = p["embed"][tokens]
    if scale:
        x = x * torch.tensor(math.sqrt(x.shape[-1]), dtype=x.dtype, device=x.device)
    return x


def lm_logits(p_head, x, tied_embed=None, softcap: float = 0.0):
    """Project to (padded) vocab logits in f32 (f32-cast operands)."""
    w = tied_embed["embed"].T if tied_embed is not None else p_head["kernel"]
    logits = x.float() @ w.float()
    if softcap > 0:
        logits = softcap * torch.tanh(logits / softcap)
    return logits


# --- losses ----------------------------------------------------------------------

NEG_INF = -1e30  # the padded vocab's logits (the reference's fill)


def _mask_padded_vocab(logits, vocab_size: int):
    """Set the padded vocab columns (index >= vocab_size) to NEG_INF."""
    if logits.shape[-1] <= vocab_size:
        return logits
    pad = torch.arange(logits.shape[-1], device=logits.device) >= vocab_size
    return logits.masked_fill(pad, NEG_INF)


def _nll(logits, labels):
    """-log p(label) per position, from f32 logits: logsumexp less the gold logit."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, labels.long()[..., None], dim=-1)[..., 0]
    return logz - gold


def cross_entropy_from_features(x, w, labels, vocab_size: int, mask=None, chunk: int = 1024):
    """Sequence-chunked CE from final features x (B, S, d) and the head w
    (d, V_pad): logits for `chunk` positions at a time, so memory is
    O(B * chunk * V) instead of O(B * S * V). The chunks run in order as a
    Python loop where the reference scans, then the remainder; the mean is
    over unmasked positions (a mask sum below 1 counts as 1)."""
    b, s, _ = x.shape
    if mask is None:
        mask = torch.ones((b, s), dtype=torch.float32, device=x.device)
    if x.device.type == "cuda":
        require_full_f32_matmul()
    chunk = min(chunk, s)
    n = s // chunk
    wf = w.float()

    def ce_sum(xc, lc, mc):
        logits = _mask_padded_vocab(xc.float() @ wf, vocab_size)
        mc = mc.float()
        return (_nll(logits, lc) * mc).sum(), mc.sum()

    loss_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    m_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n):
        part = slice(i * chunk, (i + 1) * chunk)
        ls, ms = ce_sum(x[:, part], labels[:, part], mask[:, part])
        loss_sum, m_sum = loss_sum + ls, m_sum + ms
    if s > n * chunk:
        ls, ms = ce_sum(x[:, n * chunk:], labels[:, n * chunk:], mask[:, n * chunk:])
        loss_sum, m_sum = loss_sum + ls, m_sum + ms
    return loss_sum / torch.clamp(m_sum, min=1.0)


def cross_entropy_loss(logits, labels, vocab_size: int, mask=None):
    """Mean CE over valid tokens; padded-vocab columns are excluded by
    masking them to NEG_INF before the softmax."""
    nll = _nll(_mask_padded_vocab(logits, vocab_size), labels)
    if mask is None:
        return nll.mean()
    mask = mask.to(nll.dtype)
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
