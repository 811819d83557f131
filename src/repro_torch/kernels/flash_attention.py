"""Flash attention (forward): the wrapper around the hand-written CUDA kernel
(kernels/csrc/flash_attention.cu) and its plain PyTorch version.

The kernel replaces the reference's Pallas kernel `_flash_kernel` /
`flash_attention_grouped` (kernels/flash_attention.py there): an online
softmax over KV tiles, GQA groups folded into the q tile (K/V are never
repeated), causal and sliding-window masks with the last q row aligned to
the last k row, zeros for a row with no unmasked key, f32 sums and the
output in q's dtype. It takes bf16 (tensor cores: TMA loads and wgmma,
flash_bf16) and f32 (CUDA cores, flash_f32), any Sq and Sk (the kernel masks
the ragged edges), and head dims in HEAD_DIMS.

Two entries, one kernel (it reads its operands through strides):
    flash_attention_bshd  the model's layout: q (B, Sq, H, D),
                          k/v (B, Sk, KVH, D) -> (B, Sq, H, D)
    flash_attention       the reference's user layout: q (B, H, Sq, D),
                          k/v (B, KVH, Sk, D) -> (B, H, Sq, D)

A CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
version, `flash_attention_plain`, and nothing else does. Each launch adds one
to LAUNCHES["flash_attention"]. The kernel has no backward (nor has the
reference's), so both entries raise on inputs that need a gradient under
grad mode, on either device, instead of cutting the autograd graph: a caller
that trains runs the einsum path (models/attention.grouped_attend).

`tile_plan` and `tile_work` mirror the bf16 kernel's tiles: whole positions
of a kv head's q heads per 128-row tile, the KV tiles each q tile reads, and
the launch order (heaviest first). The wrapper passes the plan's tile shape
to the kernel; the tests hold the rest against a brute-force band count.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Iterator

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import LAUNCHES  # noqa: F401 (re-exported)

HEAD_DIMS = (32, 64, 80, 96, 128, 192, 256)  # the kernel's template instantiations
_DTYPES = (torch.bfloat16, torch.float32)
TMAP_ERROR = 1000  # + CUresult: the driver refused a TMA tensor map

# flash_bf16's tile (csrc/flash_attention.cu, Tile<D>): q rows per tile, and
# the shared memory a block may use on an H100
ROWS = 128
SMEM_LIMIT = 232448


def kv_tile(d: int) -> int:
    """Keys per KV tile: 64 above D = 128 (192, 256: S, P and a 64 x D f32 O
    within a consumer's registers), else 128."""
    return 64 if d > 128 else 128


def ring_depth(d: int) -> int:
    """Stages of the K/V ring: 2 from D = 128 (to fit shared memory), else 3."""
    return 2 if d >= 128 else 3


def smem_bytes(d: int) -> int:
    """Dynamic shared memory of one flash_bf16 block: the Q tile, the ring of
    K and V tiles, and 1024 bytes to align the swizzled boxes."""
    return ROWS * d * 2 + ring_depth(d) * 2 * kv_tile(d) * d * 2 + 1024


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """flash_bf16's q tile for a group of G q heads per kv head: `heads` (Gc)
    heads x `positions` (P) whole positions, row = position * Gc + head;
    G > ROWS splits into `head_chunks` equal chunks. `q_tiles` tiles per
    (batch, kv head, chunk) cover Sq."""

    heads: int
    positions: int
    head_chunks: int
    q_tiles: int
    kv_tile: int
    ring: int


def tile_plan(g: int, sq: int, d: int) -> TilePlan:
    chunks = -(-g // ROWS)
    gc = -(-g // chunks)
    positions = ROWS // gc
    return TilePlan(gc, positions, chunks, -(-sq // positions), kv_tile(d), ring_depth(d))


@dataclasses.dataclass(frozen=True)
class TileWork:
    """One block of the launch: q positions [q0, q1) of heads [h0, h0 + Gc)
    of its kv head (those < G stored), reading KV tiles [kv0, kv1)."""

    batch: int
    kv_head: int
    h0: int
    q0: int
    q1: int
    kv0: int
    kv1: int


def tile_work(plan: TilePlan, batch: int, kv_heads: int, sq: int, sk: int, causal: bool,
              window: int) -> Iterator[TileWork]:
    """The blocks in launch order (blockIdx.x), in the formulas of
    flash_bf16's q_tile and make_band: the q tiles run backwards under a
    causal mask (later tiles read more keys) and forwards without one (a
    window makes earlier tiles heavier), each over all (batch, kv head,
    chunk) groups."""
    groups = batch * kv_heads * plan.head_chunks
    bk, off = plan.kv_tile, sk - sq
    for bid in range(plan.q_tiles * groups):
        r, grp = divmod(bid, groups)
        qt = plan.q_tiles - 1 - r if causal else r
        q0 = qt * plan.positions
        q1 = min(q0 + plan.positions, sq)
        k_begin = max(0, q0 + off - window + 1) if window > 0 else 0
        k_end = min(sk, q1 - 1 + off + 1) if causal else sk
        kv0 = k_begin // bk
        kv1 = -(-k_end // bk) if k_end > k_begin else kv0
        yield TileWork(
            batch=grp // (kv_heads * plan.head_chunks),
            kv_head=(grp // plan.head_chunks) % kv_heads,
            h0=(grp % plan.head_chunks) * plan.heads,
            q0=q0, q1=q1, kv0=kv0, kv1=kv1,
        )


def flash_attention_plain(q, k, v, causal: bool = True, window: int = 0, scale=None):
    """Plain softmax attention, the counterpart of the reference's
    kernels/ref.mha_reference extended to GQA: q (B, H, Sq, D), k/v
    (B, KVH, Sk, D) -> (B, H, Sq, D). q head h reads kv head h // (H / KVH)
    through a reshape of q (K and V are not repeated). Sums in f32, output in
    q's dtype; a row with no unmasked key gives zeros, as the kernel does."""
    b, h, sq, d = q.shape
    _, kvh, sk, _ = k.shape
    if scale is None:
        scale = d**-0.5
    qg = q.reshape(b, kvh, h // kvh, sq, d).float()
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) * scale
    qi = torch.arange(sq, device=q.device)[:, None] + (sk - sq)  # last q on last k
    ki = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= ki <= qi
    if window > 0:
        mask &= ki > qi - window
    logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    probs = torch.where(mask.any(dim=-1, keepdim=True), probs, 0.0)
    out = torch.einsum("bhgqk,bhkd->bhgqd", probs, v.float())
    return out.reshape(b, h, sq, d).to(q.dtype)


def _on_cpu(*tensors) -> bool:
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"q, k, v must share one device; got {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"tensors must live on a cuda or cpu device; got {dev}")
    return dev.type == "cpu"


def _launch(q, k, v, o, dims, causal, window, scale):
    """One kernel launch. dims are the (batch, seq, head) dim indices of all
    four operands; shapes are already checked."""
    b, h, sq, d = (q.shape[i] for i in (dims[0], dims[2], dims[1], 3))
    kvh, sk = k.shape[dims[2]], k.shape[dims[1]]
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: q, k, v must all be bf16 or f32; got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if d not in HEAD_DIMS:
        raise NotImplementedError(
            f"flash_attention: head dim {d} is not one of the kernel's {HEAD_DIMS}"
        )
    align = 16 // q.element_size()  # elements per 16-byte row alignment
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"flash_attention: {name}'s head dim must be contiguous")
        if t.data_ptr() % 16 or any(t.stride(i) % align for i in dims):
            raise ValueError(
                f"flash_attention: {name}'s rows must be 16-byte aligned (strides "
                f"{t.stride()} in elements)"
            )
    bf16 = q.dtype == torch.bfloat16
    if not bf16 and b * kvh > 65535:
        raise ValueError(f"flash_attention: batch x kv heads = {b * kvh} exceeds 65535")
    plan = tile_plan(h // kvh, sq, d)
    err = _build.load().flash_attention_fwd(
        int(bf16),
        ctypes.c_void_p(q.data_ptr()), ctypes.c_void_p(k.data_ptr()),
        ctypes.c_void_p(v.data_ptr()), ctypes.c_void_p(o.data_ptr()),
        b, h, kvh, sq, sk, d,
        *(t.stride(i) for t in (q, k, v, o) for i in dims),
        int(causal), int(window), float(scale), plan.heads, plan.positions,
        ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream),
    )
    if err >= TMAP_ERROR:
        raise RuntimeError(f"flash_attention: the driver refused a TMA tensor map (CUresult "
                           f"{err - TMAP_ERROR}; strides {[t.stride() for t in (q, k, v)]})")
    if err != 0:
        raise RuntimeError(f"flash_attention: CUDA launch failed with cudaError {err}")
    _build.count_launch("flash_attention")
    return o


def _check_shapes(q, k, v, h_ax):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: 4-d q and k == v shapes expected; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3]:
        raise ValueError("flash_attention: q and k differ in batch or head dim")
    if q.shape[h_ax] % k.shape[h_ax]:
        raise ValueError(
            f"flash_attention: {q.shape[h_ax]} q heads not a multiple of {k.shape[h_ax]} kv heads"
        )


def _refuse_grad(q, k, v):
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise RuntimeError(
            "flash_attention has no backward: inputs that require grad would cut the "
            "autograd graph; run the einsum path (attention._grouped_attend_dense) or "
            "call under torch.no_grad()"
        )


def _args(q, causal, window, scale):
    if window < 0:
        raise ValueError(f"flash_attention: window must be >= 0; got {window}")
    return bool(causal), int(window), q.shape[-1] ** -0.5 if scale is None else float(scale)


def flash_attention_bshd(q, k, v, *, causal: bool = True, window: int = 0, scale=None):
    """q (B, Sq, H, D), k/v (B, Sk, KVH, D) -> (B, Sq, H, D), the layout the
    model makes; read through strides, never transposed in memory."""
    _check_shapes(q, k, v, 2)
    _refuse_grad(q, k, v)
    causal, window, scale = _args(q, causal, window, scale)
    if _on_cpu(q, k, v):
        t = lambda x: x.transpose(1, 2)  # noqa: E731
        return t(flash_attention_plain(t(q), t(k), t(v), causal, window, scale))
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if q.numel() == 0 or k.numel() == 0:
        return o.zero_()  # no query, or no key: every row is fully masked
    return _launch(q, k, v, o, (0, 1, 2), causal, window, scale)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0, scale=None):
    """q (B, H, Sq, D), k/v (B, KVH, Sk, D) -> (B, H, Sq, D), the reference's
    user-layout wrapper."""
    _check_shapes(q, k, v, 1)
    _refuse_grad(q, k, v)
    causal, window, scale = _args(q, causal, window, scale)
    if _on_cpu(q, k, v):
        return flash_attention_plain(q, k, v, causal, window, scale)
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if q.numel() == 0 or k.numel() == 0:
        return o.zero_()  # no query, or no key: every row is fully masked
    # (batch, seq, head) are dims (0, 2, 1) of the (B, H, S, D) layout
    return _launch(q, k, v, o, (0, 2, 1), causal, window, scale)
