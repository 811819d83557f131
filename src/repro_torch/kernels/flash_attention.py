"""Flash attention (forward): the wrapper around the hand-written CUDA kernel
(kernels/csrc/flash_attention.cu) and its plain PyTorch version.

The kernel replaces the reference's Pallas kernel `_flash_kernel` /
`flash_attention_grouped` (kernels/flash_attention.py there): an online
softmax over KV tiles, GQA groups folded into the q tile (K/V are never
repeated), causal and sliding-window masks with the last q row aligned to
the last k row, zeros for a row with no unmasked key, f32 sums and the
output in q's dtype. It takes bf16 (tensor cores) and f32 (CUDA cores), any
Sq and Sk (the kernel masks the ragged edges), and head dims in
HEAD_DIMS.

Two entries, one kernel (it reads its operands through strides):
    flash_attention_bshd  the model's layout: q (B, Sq, H, D),
                          k/v (B, Sk, KVH, D) -> (B, Sq, H, D)
    flash_attention       the reference's user layout: q (B, H, Sq, D),
                          k/v (B, KVH, Sk, D) -> (B, H, Sq, D)

A CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
version, `flash_attention_plain`, and nothing else does. Each launch adds one
to LAUNCHES["flash_attention"].
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import LAUNCHES

HEAD_DIMS = (32, 64, 80, 96, 128)  # the kernel's template instantiations
_DTYPES = (torch.bfloat16, torch.float32)


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
            f"flash_attention: head dim {d} is not one of the kernel's {HEAD_DIMS} "
            "(head dim 256, gemma-7b: ROADMAP queue 2, flash kernel head dims)"
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
    if b * kvh > 65535:
        raise ValueError(f"flash_attention: batch x kv heads = {b * kvh} exceeds 65535")
    err = _build.load().flash_attention_fwd(
        int(q.dtype == torch.bfloat16),
        ctypes.c_void_p(q.data_ptr()), ctypes.c_void_p(k.data_ptr()),
        ctypes.c_void_p(v.data_ptr()), ctypes.c_void_p(o.data_ptr()),
        b, h, kvh, sq, sk, d,
        *(t.stride(i) for t in (q, k, v, o) for i in dims),
        int(causal), int(window), float(scale),
        ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream),
    )
    if err != 0:
        raise RuntimeError(f"flash_attention: CUDA launch failed with cudaError {err}")
    LAUNCHES["flash_attention"] += 1
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


def _args(q, causal, window, scale):
    if window < 0:
        raise ValueError(f"flash_attention: window must be >= 0; got {window}")
    return bool(causal), int(window), q.shape[-1] ** -0.5 if scale is None else float(scale)


def flash_attention_bshd(q, k, v, *, causal: bool = True, window: int = 0, scale=None):
    """q (B, Sq, H, D), k/v (B, Sk, KVH, D) -> (B, Sq, H, D), the layout the
    model makes; read through strides, never transposed in memory."""
    _check_shapes(q, k, v, 2)
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
    causal, window, scale = _args(q, causal, window, scale)
    if _on_cpu(q, k, v):
        return flash_attention_plain(q, k, v, causal, window, scale)
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if q.numel() == 0 or k.numel() == 0:
        return o.zero_()  # no query, or no key: every row is fully masked
    # (batch, seq, head) are dims (0, 2, 1) of the (B, H, S, D) layout
    return _launch(q, k, v, o, (0, 2, 1), causal, window, scale)
