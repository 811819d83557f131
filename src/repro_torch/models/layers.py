"""Shared model layers: norms, MLPs, RoPE, sinusoidal positions, embeddings,
the LM head and the cross-entropy losses.

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
(full f32 on the card: TF32 off).

On a model axis wider than 1 (distributed/tensor_parallel.py) a rank holds
its blocks and these functions compute its share, in the Megatron pattern:
`apply_mlp` is column then row parallel (its input through copy_to_model,
its output through one reduce_from_model); `embed_tokens` looks up the
rank's vocab rows (other rows zero) and sums over the axis, or gathers the
d_model columns where the layout falls back to them; `lm_logits` gives the
rank's vocab block of the logits; the cross-entropy functions take the max,
the sum of exponentials and the gold logit over the axis (the vocab-parallel
CE), masking the padded vocab by the block's offset. Without a model axis
they compute what the reference does, op for op.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.device import require_full_f32_matmul
from repro_torch.distributed import tensor_parallel as tp


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


def col_dense(p, x):
    """A column-parallel projection: x (replicated, after copy_to_model) by
    the rank's columns of the kernel, plus its slice of the replicated bias."""
    y = x @ p["kernel"]
    if "bias" in p:
        y = y + tp.local_slice(p["bias"], y.shape[-1])
    return y


def row_dense(p, x, reduce: bool = True):
    """A row-parallel projection: the rank's partial product, summed over the
    model axis, plus the bias once. reduce=False returns the partial alone
    (no bias: the caller sums partials, reduces them and adds `out_bias`)."""
    y = x @ p["kernel"]
    if not reduce:
        return y
    y = tp.reduce_from_model(y)
    if "bias" in p:
        y = y + p["bias"]
    return y


def whole_cols(p, x, width: int):
    """A column-parallel projection's whole output (..., width) on every
    rank: the rank's columns gathered over the model axis (x is consumed in
    part first, so through copy_to_model); a plain product where the layout
    left the kernel whole. For a product whose output splits into parts
    that a contiguous block does not respect (x | z, or the four gates):
    each consumer then takes its block with tp.local_slice."""
    if p["kernel"].shape[-1] == width:
        return dense(p, x)
    return tp.gather_from_model(col_dense(p, tp.copy_to_model(x)), -1)


def out_bias(*ps):
    """The sum of the row-parallel projections' biases (0 where none has one)."""
    return sum((p["bias"] for p in ps if "bias" in p), 0)


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


def rms_norm_split(p, x, width: int, eps: float = 1e-6):
    """An RMS norm over `width` features of which x holds the rank's block
    (the rest on the other ranks): the sum of squares over the axis (one
    all-reduce; its gradient summed back, since each rank reads it for its
    block alone) and the rank's slice of the replicated scale. apply_norm
    where x holds them all."""
    if x.shape[-1] == width:
        return apply_norm(p, x, eps)
    xf = x.float()
    ss = tp.copy_to_model(tp.reduce_from_model((xf * xf).sum(dim=-1, keepdim=True)))
    y = xf * torch.rsqrt(ss / width + eps)
    return (y * tp.local_slice(p["scale"], x.shape[-1]).float()).to(x.dtype)


# --- MLPs ------------------------------------------------------------------


def make_mlp(generator, d_model, d_ff, mlp_type, dtype, bias=False, out_scale=None):
    p = {}
    if mlp_type in ("swiglu", "geglu"):
        p["w_gate"] = make_dense(generator, d_model, d_ff, dtype, bias=bias)
    p["w_in"] = make_dense(generator, d_model, d_ff, dtype, bias=bias)
    p["w_out"] = make_dense(generator, d_ff, d_model, dtype, scale=out_scale, bias=bias)
    return p


def apply_mlp(p, x, mlp_type, reduce: bool = True):
    """The MLP, column then row parallel over the model axis (the rank's
    d_ff columns); reduce=False returns the rank's partial output without
    w_out's bias (row_dense)."""
    x = tp.copy_to_model(x)
    if mlp_type == "swiglu":
        h = F.silu(col_dense(p["w_gate"], x)) * col_dense(p["w_in"], x)
    elif mlp_type == "geglu":
        h = F.gelu(col_dense(p["w_gate"], x), approximate="tanh") * col_dense(p["w_in"], x)
    elif mlp_type == "gelu":
        h = F.gelu(col_dense(p["w_in"], x), approximate="tanh")
    else:
        raise ValueError(mlp_type)
    return row_dense(p["w_out"], h, reduce)


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


# --- positional embeddings ----------------------------------------------------


def sinusoidal_positions(seq: int, d: int, device=None) -> torch.Tensor:
    """(seq, d) f32 table: sin of pos / 10000^(2i / d) in the even columns,
    cos in the odd ones (whisper's encoder)."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    angle = pos / torch.pow(10_000.0, dim / d)
    pe = torch.zeros((seq, d), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(angle)
    pe[:, 1::2] = torch.cos(angle)
    return pe


# --- embeddings ----------------------------------------------------------------


def make_embedding(generator, vocab_padded: int, d: int, dtype):
    return {"embed": _normal(generator, (vocab_padded, d), 0.02, dtype)}


def embed_tokens(p, tokens: torch.Tensor, scale: bool = False, vocab: int = 0, d_model: int = 0):
    """The token rows of the embedding. On a model axis, `vocab` (the padded
    vocab) and `d_model` tell the rank's block apart from the whole table: a
    block of vocab rows looks its tokens up (zeros for tokens outside it) and
    sums over the axis; a block of d_model columns gathers them."""
    table = p["embed"]
    rows = table.shape[0]
    if vocab and rows < vocab:  # vocab-parallel
        local = tokens.long() - tp.rank() * rows
        inside = (local >= 0) & (local < rows)
        x = table[local.clamp(0, rows - 1)]
        x = tp.reduce_from_model(torch.where(inside[..., None], x, torch.zeros_like(x)))
    else:
        x = table[tokens]
        if d_model and table.shape[1] < d_model:
            x = tp.gather_from_model(x, -1)
    if scale:
        x = x * torch.tensor(math.sqrt(x.shape[-1]), dtype=x.dtype, device=x.device)
    return x


def _head_product(x, w, padded_vocab: int = 0):
    """x (replicated) by the head w (d, V) in f32. On a model axis: where w
    is the rank's vocab block (padded_vocab more than its columns), the
    rank's block of the logits, x through copy_to_model; where w holds a
    block of d_model rows (a tied embedding that fell back to them), the
    partial products summed over the axis (whole logits)."""
    if w.shape[0] < x.shape[-1]:
        return tp.reduce_from_model(tp.local_slice(x, w.shape[0]).float() @ w.float())
    if padded_vocab and w.shape[-1] < padded_vocab:
        x = tp.copy_to_model(x)
    return x.float() @ w.float()


def lm_logits(p_head, x, tied_embed=None, softcap: float = 0.0, padded_vocab: int = 0):
    """Project to (padded) vocab logits in f32 (f32-cast operands): the
    rank's vocab block where a model axis shards the head (padded_vocab,
    the whole padded vocab, tells a block from the whole)."""
    w = tied_embed["embed"].T if tied_embed is not None else p_head["kernel"]
    logits = _head_product(x, w, padded_vocab)
    if softcap > 0:
        logits = softcap * torch.tanh(logits / softcap)
    return logits


# --- losses ----------------------------------------------------------------------

NEG_INF = -1e30  # the padded vocab's logits (the reference's fill)


def _mask_padded_vocab(logits, vocab_size: int, offset: int = 0):
    """Set the padded vocab columns (global index >= vocab_size; the block's
    columns start at `offset`) to NEG_INF."""
    if offset + logits.shape[-1] <= vocab_size:
        return logits
    pad = torch.arange(offset, offset + logits.shape[-1], device=logits.device) >= vocab_size
    return logits.masked_fill(pad, NEG_INF)


def _nll(logits, labels):
    """-log p(label) per position, from f32 logits: logsumexp less the gold logit."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, labels.long()[..., None], dim=-1)[..., 0]
    return logz - gold


def _nll_vocab_parallel(logits, labels, offset: int):
    """_nll from the rank's vocab block of the logits (columns offset ...):
    the max over the axis (no gradient), the sum of exponentials and the
    gold logit (its block's rank alone holds it) summed over the axis."""
    n = logits.shape[-1]
    top = tp.max_over_model(logits.detach().amax(dim=-1))
    z = tp.reduce_from_model(torch.exp(logits - top[..., None]).sum(dim=-1))
    local = labels.long() - offset
    inside = (local >= 0) & (local < n)
    gold = torch.take_along_dim(logits, local.clamp(0, n - 1)[..., None], dim=-1)[..., 0]
    gold = tp.reduce_from_model(torch.where(inside, gold, torch.zeros_like(gold)))
    return top + torch.log(z) - gold


def _vocab_nll(logits, labels, vocab_size: int, padded_vocab: int):
    """-log p(label) from whole logits, or (a model axis that shards the
    vocab) from the rank's block of them."""
    if padded_vocab and logits.shape[-1] < padded_vocab:
        offset = tp.rank() * logits.shape[-1]
        return _nll_vocab_parallel(_mask_padded_vocab(logits, vocab_size, offset), labels, offset)
    return _nll(_mask_padded_vocab(logits, vocab_size), labels)


def cross_entropy_from_features(x, w, labels, vocab_size: int, mask=None, chunk: int = 1024,
                                padded_vocab: int = 0):
    """Sequence-chunked CE from final features x (B, S, d) and the head w
    (d, V_pad, or the rank's vocab block of it where padded_vocab is more
    than its columns): logits for `chunk` positions at a time, so memory is
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
    if w.shape[0] < x.shape[-1]:  # a tied embedding's block of d_model rows
        x = tp.local_slice(x, w.shape[0])
        head = lambda xc: tp.reduce_from_model(xc.float() @ wf)  # noqa: E731
    else:
        if padded_vocab and w.shape[-1] < padded_vocab:  # the rank's vocab block
            x = tp.copy_to_model(x)
        head = lambda xc: xc.float() @ wf  # noqa: E731

    def ce_sum(xc, lc, mc):
        nll = _vocab_nll(head(xc), lc, vocab_size, padded_vocab)
        mc = mc.float()
        return (nll * mc).sum(), mc.sum()

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


def cross_entropy_loss(logits, labels, vocab_size: int, mask=None, padded_vocab: int = 0):
    """Mean CE over valid tokens; padded-vocab columns are excluded by
    masking them to NEG_INF before the softmax. Logits that are the rank's
    vocab block (padded_vocab more than their columns) take the
    vocab-parallel CE."""
    nll = _vocab_nll(logits, labels, vocab_size, padded_vocab)
    if mask is None:
        return nll.mean()
    mask = mask.to(nll.dtype)
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
