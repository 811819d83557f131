"""Attention mixers: MHA/GQA/MQA and sliding-window attention.

The counterpart of the GQA/SWA half of the reference's models/attention.py.
Two execution modes share one math core:
    train / prefill  full-sequence self-attention (prefill also returns
                     the KV cache)
    decode           one token against a cache of capacity S

Layouts: activations (B, S, D); q/k/v (B, S, H, head_dim); caches
(B, S, KVH, head_dim).

On a CUDA tensor, `grouped_attend` sends every call inside the flash
kernel's contract (a head dim in HEAD_DIMS, bf16 or f32, no kv_len, no
softcap, scalar q_offset == Sk - Sq: every `attn_forward` call of a model
whose head dim the kernel was built for) that needs no gradient to the
hand-written kernel (kernels/flash_attention.py). The kernel has no backward,
as the reference's has none (its model always runs the einsum), so a call
under grad mode whose q, k or v requires grad (a training step) runs the
einsum path, and the kernel's wrapper refuses such inputs. Every other call (decode's per-row q_offset
and kv_len; another head dim, such as a reduced config's 16) runs
`_grouped_attend_dense`, the port of the reference's einsum path, which the
reference computes for every call outside its Pallas kernel. On the CPU every call
runs the einsum path. A row with no unmasked key gets zeros from the kernel
and the mean of V from the einsum path (its -1e30 fill); no prefill or
decode row is fully masked. The reference's q-chunked einsum path for long
sequences (its REPRO_ATTN_* knobs) is not carried: on the card the kernel
never materialises the (Sq, Sk) logits, and decode has Sq = 1.

MLA (latent attention, deepseek-v2-lite) is not ported yet and raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import _DTYPES, HEAD_DIMS, flash_attention_bshd
from repro_torch.models.layers import apply_rope, dense, make_dense, rope_freqs

NEG_INF = -1e30

_MLA_TODO = "MLA attention (deepseek-v2-lite) is not ported yet: ROADMAP queue 1 item 13d"


def make_attention(generator, cfg: ModelConfig, dtype):
    d, h, kvh, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    bias = cfg.attn_bias or cfg.qkv_bias
    out_scale = (h * hd) ** -0.5 / (2.0 * cfg.num_layers) ** 0.5
    return {
        "wq": make_dense(generator, d, h * hd, dtype, bias=bias),
        "wk": make_dense(generator, d, kvh * hd, dtype, bias=bias),
        "wv": make_dense(generator, d, kvh * hd, dtype, bias=bias),
        "wo": make_dense(generator, h * hd, d, dtype, scale=out_scale, bias=cfg.attn_bias),
    }


def _split_heads(x, n_heads, head_dim):
    b, s, _ = x.shape
    return x.reshape(b, s, n_heads, head_dim)


def _kernel_takes(q, k, v, q_offset, kv_len, softcap) -> bool:
    """The flash kernel's contract, device aside: a head dim it was
    instantiated for (HEAD_DIMS), a dtype it takes (bf16 or f32, the same
    for q, k and v), no kv_len, no softcap, and q_offset Sk - Sq."""
    if q.shape[-1] not in HEAD_DIMS or q.dtype not in _DTYPES:
        return False
    if k.dtype != q.dtype or v.dtype != q.dtype or kv_len is not None or softcap != 0:
        return False
    sq, sk = q.shape[1], k.shape[1]
    return q_offset is None or (isinstance(q_offset, int) and q_offset == sk - sq)


def _on_card(q) -> bool:
    return q.device.type == "cuda"


def _needs_grad(q, k, v) -> bool:
    """Whether autograd would record a graph through q, k or v."""
    return torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad)


def grouped_attend(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Sk, KVH, D)
    v: torch.Tensor,  # (B, Sk, KVH, D)
    *,
    causal: bool,
    window: int = 0,
    q_offset=None,  # (B,) tensor or int: global position of q[0]; default Sk - Sq
    kv_len=None,  # (B,) tensor or int: valid cache entries (decode); default Sk
    softcap: float = 0.0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    if _on_card(q) and not _needs_grad(q, k, v) and _kernel_takes(q, k, v, q_offset, kv_len, softcap):
        return flash_attention_bshd(q, k, v, causal=causal, window=window, scale=scale)
    return _grouped_attend_dense(
        q, k, v, causal=causal, window=window, q_offset=q_offset,
        kv_len=kv_len, softcap=softcap, scale=scale,
    )


def _grouped_attend_dense(
    q, k, v, *, causal, window=0, q_offset=None, kv_len=None, softcap=0.0, scale=None,
) -> torch.Tensor:
    """Grouped-query attention core (einsum path, f32 softmax)."""
    b, sq, h, d = q.shape
    _, sk, kvh, _ = k.shape
    g = h // kvh
    if scale is None:
        scale = d**-0.5
    qg = q.reshape(b, sq, kvh, g, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
    if softcap > 0:
        logits = softcap * torch.tanh(logits / softcap)

    # positions
    if q_offset is None:
        q_offset = sk - sq
    dev = q.device
    qpos = torch.as_tensor(q_offset, device=dev)[..., None] + torch.arange(sq, device=dev)
    qpos = qpos.expand(b, sq)
    kpos = torch.arange(sk, device=dev)[None, :]  # (1, Sk)

    mask = torch.ones((b, sq, sk), dtype=torch.bool, device=dev)
    if kv_len is not None:
        kl = torch.as_tensor(kv_len, device=dev).expand(b)
        mask = mask & (kpos < kl[:, None])[:, None, :]  # (B, 1, Sk) over Sq
    if causal:
        mask = mask & (kpos[None] <= qpos[..., None])
    if window > 0:
        mask = mask & (kpos[None] > qpos[..., None] - window)

    logits = logits.masked_fill(~mask[:, None, None], NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())
    return out.reshape(b, sq, h, d).to(q.dtype)


def attn_forward(
    p,
    cfg: ModelConfig,
    x: torch.Tensor,  # (B, S, D)
    positions: torch.Tensor,  # (B, S) int
    *,
    causal: bool = True,
    window: int = 0,
    return_cache: bool = False,
):
    """Full-sequence self-attention (train / prefill)."""
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = _split_heads(dense(p["wq"], x), h, hd)
    k = _split_heads(dense(p["wk"], x), kvh, hd)
    v = _split_heads(dense(p["wv"], x), kvh, hd)
    if cfg.pos_type == "rope":
        ang = rope_freqs(positions, hd, cfg.rope_theta)
        q = apply_rope(q, ang)
        k = apply_rope(k, ang)
    out = grouped_attend(
        q, k, v, causal=causal, window=window, q_offset=0, softcap=cfg.attn_logit_softcap,
    )
    y = dense(p["wo"], out.reshape(*x.shape[:-1], h * hd))
    if return_cache:
        return y, {"k": k, "v": v}
    return y


def attn_decode(
    p,
    cfg: ModelConfig,
    x: torch.Tensor,  # (B, 1, D) new-token activations
    cache: dict,  # {"k": (B, S, KVH, D), "v": ...}
    pos: torch.Tensor,  # (B,) index to write; attends to <= pos
    *,
    window: int = 0,
) -> Tuple[torch.Tensor, dict]:
    """One-token attention step. Writes the new token's k/v into `cache` IN
    PLACE and returns it (the reference returns a new cache)."""
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    b = x.shape[0]
    q = _split_heads(dense(p["wq"], x), h, hd)  # (B, 1, H, D)
    k_new = _split_heads(dense(p["wk"], x), kvh, hd)
    v_new = _split_heads(dense(p["wv"], x), kvh, hd)
    if cfg.pos_type == "rope":
        ang = rope_freqs(pos[:, None], hd, cfg.rope_theta)  # (B, 1, hd/2)
        q = apply_rope(q, ang)
        k_new = apply_rope(k_new, ang)
    bidx = torch.arange(b, device=x.device)
    cache["k"][bidx, pos.long()] = k_new[:, 0]
    cache["v"][bidx, pos.long()] = v_new[:, 0]
    out = grouped_attend(
        q, cache["k"], cache["v"], causal=True, window=window,
        q_offset=pos, kv_len=pos + 1, softcap=cfg.attn_logit_softcap,
    )
    y = dense(p["wo"], out.reshape(b, 1, h * hd))
    return y, cache


def make_mla(generator, cfg: ModelConfig, dtype):
    raise NotImplementedError(_MLA_TODO)


def mla_forward(p, cfg: ModelConfig, x, positions, *, return_cache=False):
    raise NotImplementedError(_MLA_TODO)


def mla_decode(p, cfg: ModelConfig, x, cache, pos):
    raise NotImplementedError(_MLA_TODO)
