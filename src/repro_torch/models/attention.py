"""Attention mixers: MHA/GQA/MQA, sliding-window attention, cross-attention
and MLA.

The counterpart of the reference's models/attention.py. Two execution modes
share one math core:
    train / prefill  full-sequence attention (self, bidirectional for an
                     encoder, or cross-attention to `kv_x`); prefill also
                     returns the KV cache
    decode           one token against a cache of capacity S, or (cross)
                     against the static cache of the encoder's k / v

Layouts: activations (B, S, D); q/k/v (B, S, H, head_dim); caches
(B, S, KVH, head_dim).

On a CUDA tensor, `grouped_attend` sends every call inside the flash
kernel's contract (a head dim in HEAD_DIMS, bf16 or f32, no kv_len, no
softcap, and a q_offset that puts the last q row on the last k row, or any
scalar q_offset where nothing is masked: no causal mask and no window;
every `attn_forward` call of a model whose head dim the kernel was built
for, and a cross-attention decode) that needs no gradient to the
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

MLA (DeepSeek's multi-head latent attention, deepseek-v2-lite) keeps the
reference's two paths. `mla_forward` (train / prefill) decompresses the
latent into per-head k and v and folds the nope and rope logits into one
`grouped_attend` call at head dim dn + dr (192 at full width, in HEAD_DIMS,
so a bf16 prefill on the card runs the flash kernel), v zero-padded to that
width and sliced back. `mla_decode` attends in latent space (the absorbed
path) in f32, over a cache of only c_kv (B, S, r) and k_rope (B, S, dr),
which it writes IN PLACE.

On a model axis wider than 1 (distributed/tensor_parallel.py) a rank
computes its q heads against their kv heads (column-parallel wq / wk / wv,
row-parallel wo). A KV cache leaf's block follows sharding.cache_spec_for,
read back from its shape (`cache_model_dim`): the rank's kv heads (or
head_dim columns), or, where REPRO_KV_SEQ_SHARD lays the cache over the
sequence and the axis divides it, the rank's rows [r S / m, (r + 1) S / m)
of every head. Decode over such rows is a flash-decode combine: every q
head gathered (small), the rank's partial softmax over its rows against
global positions (rank S / m + i <= pos), one MAX and one SUM all-reduce,
then the rank's heads for wo; only the rank whose rows hold a row's pos
writes it. MLA splits wq and w_uk / w_uv by heads (wkv_a and kv_norm
replicated); its latent cache lies over the sequence (the same combine, in
latent space) or over its columns (r, and k_rope's dr), where the logits are
partial sums over the axis and the context is gathered over r.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import require_full_f32_matmul
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.distributed.sharding import BATCH, MODEL, constrain
from repro_torch.kernels.flash_attention import _DTYPES, HEAD_DIMS, flash_attention_bshd
from repro_torch.models.layers import (
    _normal, apply_norm, apply_rope, col_dense, dense, make_dense, make_norm, rope_freqs,
    row_dense,
)

NEG_INF = -1e30


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


def _kernel_takes(q, k, v, q_offset, kv_len, softcap, causal=True, window=0) -> bool:
    """The flash kernel's contract, device aside: a head dim it was
    instantiated for (HEAD_DIMS), a dtype it takes (bf16 or f32, the same
    for q, k and v), no kv_len, no softcap, and q_offset Sk - Sq (the
    kernel's alignment) or, with no causal mask and no window (an encoder,
    a cross-attention prefill), any int: the mask is then all ones."""
    if q.shape[-1] not in HEAD_DIMS or q.dtype not in _DTYPES:
        return False
    if k.dtype != q.dtype or v.dtype != q.dtype or kv_len is not None or softcap != 0:
        return False
    if q_offset is None:
        return True
    unmasked = not causal and window == 0
    return isinstance(q_offset, int) and (unmasked or q_offset == k.shape[1] - q.shape[1])


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
    if _on_card(q) and not _needs_grad(q, k, v) and _kernel_takes(
            q, k, v, q_offset, kv_len, softcap, causal, window):
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


def _heads(t, n_heads, head_dim):
    """(B, S, columns) -> ((B, S, heads, head_dim), the first head's global
    index, gathered). On a model axis a rank's columns are whole heads where
    the axis divides n_heads (its heads, in rank order); where it does not,
    the columns split a head, and they are gathered over the axis into every
    head (gathered True: the result is replicated)."""
    cols = t.shape[-1]
    if cols == n_heads * head_dim:
        return _split_heads(t, n_heads, head_dim), 0, False
    if n_heads % tp.size() == 0:
        local = cols // head_dim
        return _split_heads(t, local, head_dim), tp.rank() * local, False
    return _split_heads(tp.gather_from_model(t, -1), n_heads, head_dim), 0, True


def _kv_for_q(t, first, gathered, q0, hq, group):
    """The kv heads a rank's q heads q0 .. q0 + hq read (GQA: q head i reads
    kv head i // group) out of t (B, S, heads, D) whose first head is
    `first`; a gathered (replicated) t goes through copy_to_model, since the
    rank's heads consume it in part."""
    lo, hi = q0 // group, (q0 + hq - 1) // group + 1
    if gathered:
        t = tp.copy_to_model(t)
    if lo == first and hi - lo == t.shape[2]:
        return t
    return t[:, :, lo - first:hi - first]


def _cache_block(t, width: int):
    """A rank's cache block of k or v (B, S, heads, D) under cache_spec_for's
    layout, `width` its head_dim columns: t itself (whole, or the rank's kv
    heads), or, where the axis does not divide the kv heads
    (REPRO_KV_SEQ_SHARD=0), the rank's block of head_dim columns of every
    head (t gathered)."""
    if width == t.shape[-1]:
        return t
    return t[..., tp.rank() * width:(tp.rank() + 1) * width]


def cache_model_dim(shape, whole, kv_heads: int) -> Optional[int]:
    """The dim of a sequence cache leaf's block (B, S, *rest) that the
    active model axis splits under cache_spec_for: a rest dim narrower than
    its whole width `whole`, else the sequence (1) where the layout policy
    puts it there (tp.kv_seq of kv_heads; 0 for a latent cache), else None
    (whole: one rank, or a layout that replicates it). A block with whole
    rest dims under a sequence policy is its rows, as tp.check_supported
    refuses the configs whose blocks could be either."""
    for i, (n, w) in enumerate(zip(shape[2:], whole)):
        if n < w:
            return 2 + i
    return 1 if tp.size() > 1 and tp.kv_seq(kv_heads) else None


def _write_rows(cache, new, pos):
    """new (B, ...) into the rank's rows of a sequence-sharded cache (B,
    S / m, ...) at global positions pos (B,): each row written by the rank
    whose block holds its pos, in place."""
    b, s_l = cache.shape[0], cache.shape[1]
    at = pos.long() - tp.rank() * s_l
    inside = ((at >= 0) & (at < s_l)).view((b,) + (1,) * (new.dim() - 1))
    at = at.clamp(0, s_l - 1)
    bidx = torch.arange(b, device=cache.device)
    cache[bidx, at] = torch.where(inside, new.to(cache.dtype), cache[bidx, at])


def _partial_softmax(lg, vals, eq: str):
    """A softmax over keys split across the model axis, from each rank's
    logits lg (..., S / m; masked with NEG_INF) and values: the max over the
    axis (one MAX all-reduce), then the weighted values and the sums of the
    exponentials summed over it (one SUM all-reduce of both, packed).
    Returns (numerator per `eq`, denominator), f32."""
    top = tp.max_over_model(lg.amax(dim=-1, keepdim=True))
    pr = torch.exp(lg - top)
    num = torch.einsum(eq, pr, vals)
    den = pr.sum(dim=-1)
    packed = tp.sum_over_model(torch.cat([num.reshape(-1), den.reshape(-1)]))
    return packed[:num.numel()].view_as(num), packed[num.numel():].view_as(den)


def _flash_decode(q, kc, vc, pos=None, window: int = 0, softcap: float = 0.0):
    """One-token attention of every q head (B, 1, H, D) over the rank's rows
    of a sequence-sharded cache (B, S / m, KVH, D), combined over the axis:
    with pos, rows at global positions <= pos (and within the window); a
    cross cache (pos None) unmasked. f32, cast to q's dtype."""
    b, _, h, d = q.shape
    s_l, kvh = kc.shape[1], kc.shape[2]
    qg = q.reshape(b, kvh, h // kvh, d).float()
    lg = torch.einsum("bhgd,bkhd->bhgk", qg, kc.float()) * d**-0.5
    if softcap > 0:
        lg = softcap * torch.tanh(lg / softcap)
    if pos is not None:
        kpos = tp.rank() * s_l + torch.arange(s_l, device=q.device)
        mask = kpos[None] <= pos[:, None]
        if window > 0:
            mask = mask & (kpos[None] > pos[:, None] - window)
        lg = lg.masked_fill(~mask[:, None, None], NEG_INF)
    num, den = _partial_softmax(lg, vc.float(), "bhgk,bkhd->bhgd")
    return (num / den[..., None]).reshape(b, 1, h, d).to(q.dtype)


def _kv_cache(k, v, gathered: bool, kvh: int, hd: int) -> dict:
    """The rank's cache blocks of a prefill's k / v (B, S, heads, D: its kv
    heads, or every head where `gathered`): its rows of every head where the
    layout puts the cache over the sequence, else its heads or (a split
    head) its head_dim columns."""
    if tp.cache_dim("k", k.shape[:2] + (kvh, hd)) == 1:
        k, v = tp.gather_whole(k, kvh, 2), tp.gather_whole(v, kvh, 2)
        return {"k": tp.cache_block(k, "k"), "v": tp.cache_block(v, "v")}
    m = tp.size()
    width = hd // m if gathered and hd % m == 0 else hd
    return {"k": _cache_block(k, width), "v": _cache_block(v, width)}


def attn_forward(
    p,
    cfg: ModelConfig,
    x: torch.Tensor,  # (B, S, D)
    positions: torch.Tensor,  # (B, S) int
    *,
    causal: bool = True,
    window: int = 0,
    kv_x: Optional[torch.Tensor] = None,  # cross-attention source (B, Se, D)
    return_cache: bool = False,
    reduce: bool = True,
):
    """Full-sequence attention (train / prefill / encoder / cross). With
    `kv_x`, k and v come from it, no RoPE is applied and the mask is off:
    every q row attends to every row of kv_x; the cache is kv_x's k / v.

    On a model axis the rank computes its q heads against their kv heads
    (column-parallel wq / wk / wv, row-parallel wo: one all-reduce of the
    output; reduce=False returns the rank's partial output without wo's
    bias), and its cache is its block of the kv heads; where the axis does
    not divide the kv heads, k and v are gathered over it first, and the
    cache is its block of head_dim columns of every head."""
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    x = tp.copy_to_model(x)
    src = x if kv_x is None else tp.copy_to_model(kv_x)
    q, q0, _ = _heads(col_dense(p["wq"], x), h, hd)
    k, k0, gathered = _heads(col_dense(p["wk"], src), kvh, hd)
    v, _, _ = _heads(col_dense(p["wv"], src), kvh, hd)
    if cfg.pos_type == "rope" and kv_x is None:
        ang = rope_freqs(positions, hd, cfg.rope_theta)
        q = apply_rope(q, ang)
        k = apply_rope(k, ang)
    hq = q.shape[2]
    kq = _kv_for_q(k, k0, gathered, q0, hq, h // kvh)
    vq = _kv_for_q(v, k0, gathered, q0, hq, h // kvh)
    out = grouped_attend(
        q, kq, vq, causal=causal and kv_x is None, window=window, q_offset=0,
        softcap=cfg.attn_logit_softcap,
    )
    y = row_dense(p["wo"], out.reshape(*x.shape[:-1], hq * hd), reduce)
    if return_cache:
        return y, _kv_cache(k, v, gathered, kvh, hd)
    return y


def attn_decode(
    p,
    cfg: ModelConfig,
    x: torch.Tensor,  # (B, 1, D) new-token activations
    cache: dict,  # {"k": (B, S, KVH, D), "v": ...}
    pos: torch.Tensor,  # (B,) index to write; attends to <= pos
    *,
    window: int = 0,
    cross: bool = False,
    reduce: bool = True,
) -> Tuple[torch.Tensor, dict]:
    """One-token attention step. Writes the new token's k/v into `cache` IN
    PLACE and returns it (the reference returns a new cache). With `cross`,
    `cache` is the static cross-attention cache (the encoder's k / v): the
    step attends to all of it, with no RoPE and no kv_len, and writes
    nothing.

    On a model axis, as attn_forward: the rank's q heads against its cache
    block (its kv heads, or its head_dim columns of every head, which are
    gathered over the axis before the step attends), or, on the rank's rows
    of a sequence-sharded cache, the flash-decode combine of every q head
    (`_flash_decode`), of which the rank keeps its own for wo."""
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    b = x.shape[0]
    x = tp.copy_to_model(x)
    q, q0, _ = _heads(col_dense(p["wq"], x), h, hd)  # (B, 1, H, D)
    hq = q.shape[2]
    seq = cache_model_dim(cache["k"].shape, (kvh, hd), kvh) == 1
    if not cross:
        k_new, _, _ = _heads(col_dense(p["wk"], x), kvh, hd)
        v_new, _, _ = _heads(col_dense(p["wv"], x), kvh, hd)
        if cfg.pos_type == "rope":
            ang = rope_freqs(pos[:, None], hd, cfg.rope_theta)  # (B, 1, hd/2)
            q = apply_rope(q, ang)
            k_new = apply_rope(k_new, ang)
        if seq:
            _write_rows(cache["k"], tp.gather_whole(k_new, kvh, 2)[:, 0], pos)
            _write_rows(cache["v"], tp.gather_whole(v_new, kvh, 2)[:, 0], pos)
        else:
            bidx = torch.arange(b, device=x.device)
            cache["k"][bidx, pos.long()] = _cache_block(k_new, cache["k"].shape[-1])[:, 0]
            cache["v"][bidx, pos.long()] = _cache_block(v_new, cache["v"].shape[-1])[:, 0]
    if seq:
        out = _flash_decode(tp.gather_whole(q, h, 2), cache["k"], cache["v"],
                            pos=None if cross else pos, window=window,
                            softcap=cfg.attn_logit_softcap)[:, :, q0:q0 + hq]
        return row_dense(p["wo"], out.reshape(b, 1, hq * hd), reduce), cache
    kc, vc = cache["k"], cache["v"]
    if kc.shape[-1] < hd:  # head_dim columns: every head, gathered
        kc, vc = tp.gather_from_model(kc, -1), tp.gather_from_model(vc, -1)
    first = 0 if kc.shape[2] == kvh else tp.rank() * kc.shape[2]
    kc = _kv_for_q(kc, first, False, q0, hq, h // kvh)
    vc = _kv_for_q(vc, first, False, q0, hq, h // kvh)
    if cross:
        out = grouped_attend(q, kc, vc, causal=False, softcap=cfg.attn_logit_softcap)
    else:
        out = grouped_attend(
            q, kc, vc, causal=True, window=window,
            q_offset=pos, kv_len=pos + 1, softcap=cfg.attn_logit_softcap,
        )
    y = row_dense(p["wo"], out.reshape(b, 1, hq * hd), reduce)
    return y, cache


# ---------------------------------------------------------------------------
# MLA (DeepSeek multi-head latent attention)
# ---------------------------------------------------------------------------


def _mla_dims(cfg: ModelConfig):
    mla = cfg.mla
    return mla.kv_lora_rank, mla.qk_nope_head_dim, mla.qk_rope_head_dim, mla.v_head_dim


def make_mla(generator, cfg: ModelConfig, dtype):
    d, h = cfg.d_model, cfg.num_heads
    r, dn, dr, dv = _mla_dims(cfg)
    out_scale = (h * dv) ** -0.5 / (2.0 * cfg.num_layers) ** 0.5
    return {
        "wq": make_dense(generator, d, h * (dn + dr), dtype),
        "wkv_a": make_dense(generator, d, r + dr, dtype),  # latent + shared rope key
        "kv_norm": make_norm("rmsnorm", r, dtype, generator.device),
        "w_uk": _normal(generator, (r, h, dn), r**-0.5, dtype),
        "w_uv": _normal(generator, (r, h, dv), r**-0.5, dtype),
        "wo": make_dense(generator, h * dv, d, dtype, scale=out_scale),
    }


def _mla_qsplit(p, cfg: ModelConfig, x, positions):
    """q's nope and rope parts of the rank's heads (column-parallel wq)."""
    _, dn, dr, _ = _mla_dims(cfg)
    q = col_dense(p["wq"], tp.copy_to_model(x)).reshape(*x.shape[:-1], -1, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, rope_freqs(positions, dr, cfg.rope_theta))
    return q_nope, q_rope


def mla_forward(p, cfg: ModelConfig, x, positions, *, return_cache=False):
    """Train / prefill MLA: decompress k and v and run standard attention.

    The decoupled-rope logits q_nope.k_nope + q_rope.k_rope are one
    grouped_attend call over the concatenated nope / rope components per
    head (k_rope shared by every head); v is zero-padded to the concat width
    and sliced back (the extra columns contribute nothing).

    On a model axis: the rank's heads (wq, w_uk, w_uv), c_kv and k_rope
    computed whole (wkv_a replicated), row-parallel wo; the cache is the
    rank's block of the whole latents (`tp.cache_block`)."""
    b, s, _ = x.shape
    r, dn, dr, dv = _mla_dims(cfg)
    q_nope, q_rope = _mla_qsplit(p, cfg, x, positions)
    h = q_nope.shape[2]

    kv_a = dense(p["wkv_a"], x)  # (B, S, r + dr)
    c_kv = apply_norm(p["kv_norm"], kv_a[..., :r])
    k_rope = kv_a[..., r:].reshape(b, s, 1, dr)
    k_rope = apply_rope(k_rope, rope_freqs(positions, dr, cfg.rope_theta))[:, :, 0]

    c_in, k_rope_in = tp.copy_to_model(c_kv), tp.copy_to_model(k_rope)  # read by the rank's heads
    k_nope = constrain(torch.einsum("bsr,rhd->bshd", c_in, p["w_uk"]), BATCH, None, MODEL, None)
    v = constrain(torch.einsum("bsr,rhd->bshd", c_in, p["w_uv"]), BATCH, None, MODEL, None)

    # torch.cat and F.pad write new contiguous tensors (the flash kernel's
    # TMA maps need 16-byte rows; no stride-0 head axis reaches it)
    qq = torch.cat([q_nope, q_rope], dim=-1)  # (B, S, H, dn + dr)
    kk = torch.cat([k_nope, k_rope_in[:, :, None].expand(b, s, h, dr)], dim=-1)
    vv = F.pad(v, (0, dn + dr - dv))
    out = grouped_attend(qq, kk, vv, causal=True, q_offset=0)[..., :dv]
    y = row_dense(p["wo"], out.reshape(b, s, -1))
    if return_cache:
        return y, {"c_kv": tp.cache_block(c_kv, "c_kv"), "k_rope": tp.cache_block(k_rope, "k_rope")}
    return y


def _write_latent(cache, new, pos, dim):
    """new (B, w), whole, into a latent cache block at pos, in place: the
    rank's rows (dim 1), its columns (dim 2) or the whole leaf (None)."""
    if dim == 1:
        _write_rows(cache, new, pos)
        return
    if dim == 2:
        new = tp.local_slice(new, new.shape[1] // tp.size(), 1)
    bidx = torch.arange(new.shape[0], device=cache.device)
    cache[bidx, pos.long()] = new.to(cache.dtype)


def mla_decode(p, cfg: ModelConfig, x, cache, pos):
    """Absorbed-matrix MLA decode: attend in latent space over a cache of
    r + dr values a token, W_uk folded into the query and W_uv into the
    output, in f32 (full f32 on the card: TF32 off). Writes the new token's
    c_kv and k_rope rows into `cache` IN PLACE and returns it (the reference
    returns a new cache).

    On a model axis: q_lat and q_rope of the rank's heads; over the rank's
    rows of the cache (the sequence layout) every head's q gathered and the
    flash-decode combine (`_partial_softmax`); over its columns (r, and
    k_rope's dr) every head's q narrowed to them, the logits' partial sums
    summed over the axis (one all-reduce), the softmax whole and the context
    gathered over r; then the rank's heads through w_uv and row-parallel
    wo."""
    b = x.shape[0]
    r, dn, dr, _ = _mla_dims(cfg)
    h = cfg.num_heads
    q_nope, q_rope = _mla_qsplit(p, cfg, x, pos[:, None])  # (B, 1, H, *)
    hl = q_nope.shape[2]
    h0 = tp.rank() * hl if hl < h else 0

    kv_a = dense(p["wkv_a"], x)  # (B, 1, r + dr)
    c_new = apply_norm(p["kv_norm"], kv_a[..., :r])[:, 0]  # (B, r)
    k_rope_new = kv_a[..., r:].reshape(b, 1, 1, dr)
    k_rope_new = apply_rope(k_rope_new, rope_freqs(pos[:, None], dr, cfg.rope_theta))[:, 0, 0]

    c_cache, r_cache = cache["c_kv"], cache["k_rope"]  # (B, S, r), (B, S, dr): blocks
    c_dim = cache_model_dim(c_cache.shape, (r,), 0)
    r_dim = cache_model_dim(r_cache.shape, (dr,), 0)
    _write_latent(c_cache, c_new, pos, c_dim)
    _write_latent(r_cache, k_rope_new, pos, r_dim)

    if x.device.type == "cuda":
        require_full_f32_matmul()
    c32, r32 = c_cache.float(), r_cache.float()
    scale = (dn + dr) ** -0.5
    # absorb W_uk into q: (B, 1, H, dn) x (r, H, dn) -> (B, H, r)
    q_lat = torch.einsum("bqhd,rhd->bhr", q_nope.float(), p["w_uk"].float())
    if c_dim is None and r_dim is None:  # whole caches: the rank's heads alone
        lg = torch.einsum("bhr,bsr->bhs", q_lat, c32)
        lg = lg + torch.einsum("bqhd,bsd->bhs", q_rope.float(), r32)
        lg = lg * scale
        mask = torch.arange(c_cache.shape[1], device=x.device)[None, :] <= pos[:, None]  # (B, S)
        lg = lg.masked_fill(~mask[:, None], NEG_INF)
        pr = torch.softmax(lg, dim=-1)
        ctx = torch.einsum("bhs,bsr->bhr", pr, c32)
    else:
        q_lat = tp.gather_whole(q_lat, h, 1)  # every head
        q_rope = tp.gather_whole(q_rope, h, 2).float()
        if c_dim == 1:  # the rank's rows
            s_l = c_cache.shape[1]
            lg = torch.einsum("bhr,bsr->bhs", q_lat, c32)
            lg = (lg + torch.einsum("bqhd,bsd->bhs", q_rope, r32)) * scale
            kpos = tp.rank() * s_l + torch.arange(s_l, device=x.device)
            lg = lg.masked_fill(~(kpos[None, :] <= pos[:, None])[:, None], NEG_INF)
            num, den = _partial_softmax(lg, c32, "bhs,bsr->bhr")
            ctx = num / den[..., None]
        else:  # the rank's columns of r (and of dr)
            terms = (("bhr,bsr->bhs", q_lat, c32, c_dim), ("bqhd,bsd->bhs", q_rope, r32, r_dim))
            part = whole = 0.0
            for eq, q_t, cache_t, dim in terms:
                if dim is None:
                    whole = whole + torch.einsum(eq, q_t, cache_t)
                else:
                    q_t = tp.local_slice(q_t, q_t.shape[-1] // tp.size(), -1)
                    part = part + torch.einsum(eq, q_t, cache_t)
            lg = (tp.sum_over_model(part) + whole) * scale
            mask = torch.arange(c_cache.shape[1], device=x.device)[None, :] <= pos[:, None]
            lg = lg.masked_fill(~mask[:, None], NEG_INF)
            pr = torch.softmax(lg, dim=-1)
            ctx = torch.einsum("bhs,bsr->bhr", pr, c32)
            if c_dim == 2:
                ctx = tp.gather_from_model(ctx, -1)
        ctx = ctx[:, h0:h0 + hl]
    out = torch.einsum("bhr,rhd->bhd", ctx, p["w_uv"].float()).to(x.dtype)
    y = row_dense(p["wo"], out.reshape(b, 1, -1))
    return y, cache
