"""Batched online readout updates: recursive least squares (RLS) and
normalized least mean squares (LMS).

The learning rule behind `ExecPlan.learn="rls"`: every serving tick, each
ensemble lane e refines its readout weights W[e] against that tick's target
with the classic RLS recursion

    k   = P x / (lam + x^T P x)          gain        (E, S)
    e   = y - W^T x                      a-priori error
    W'  = W + k e^T                      weight update
    P'  = (P - k (P x)^T) / lam          inverse-Gram update

with x the (S,) = (N + 1,) feature vector (node states + bias), lam the
forgetting factor, and P initialized to I / reg. With lam == 1 the
recursion converges to the regularized normal equations batch ridge solves,
so the streaming path has an offline oracle (`core.reservoir.fit_rls`).

These are plain torch functions on (E, ...)-batched operands, so the SAME
update runs after every tick_chunk backend: the core-layout scan and the
planes impls (whose integrate is a CUDA kernel). The P' expression uses the
k (P x)^T outer product, not k (x^T P), so P stays symmetric by
construction.

Lane stability, which the served-lane == oracle contract rests on: every
reduction is a multiply and a sum over the trailing axis, or a batched GEMM
(`torch.bmm`) that runs one fixed-shape product per lane. On the CPU the
lane-0 result of either is bit-equal at any batch width E (pinned by
tests/test_torch_rls.py), so a lane served at width E reproduces the E = 1
oracle. On CUDA, cuBLAS's bmm and the reduce kernels pick another
algorithm for another batch count (at E = 256 against E = 1 they differ
at rounding level, tools/rls_tail_probe.py); a lane at width E is still
bit-equal to the same lane replayed at width E, whatever the other lanes
hold and whichever lane it is (tests/test_torch_cuda.py and chip_smoke.py
hold both, and the E = 1 oracle within a tolerance). The lane's position
matters to CUDA's reduce kernel, which begins its vectorized loads at each
row's first 16-byte boundary: with S = N + 1 odd, lane e's rows start at
another alignment than lane 0's and sum in another order. So the serving
path's trailing sums go through `_dot`, which on CUDA pads the summed axis
to a multiple of four (every row then starts aligned), and `rls_chunk`'s
K == 1 product through bmm there (tools/rls_lane_probe.py; a session
migrated into another lane keeps its bits).

Numerical note: the recursion runs in P's dtype (f32 for serving). With
lam == 1, P shrinks monotonically and f32 is stable for any stream length;
with aggressive forgetting over very long streams P's conditioning degrades
in f32, so keep lam close to 1 for long-lived f32 sessions or run the spec
in float64.

Precision policies (ExecPlan.precision) stop HERE: the learn recursion
always runs in P's dtype, and both update entry points upcast reduced-dtype
feature vectors to it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.device import resolve_device


def rls_init(
    e: int, n_state: int, n_out: int, reg: float, dtype, device=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fresh per-lane learning state: P = I / reg, W = 0.

    Returns (P (E, S, S), W (E, S, n_out)), both contiguous on `device`
    ("cuda" when None; raises without a card unless given device="cpu").
    reg plays exactly the role of ridge regression's `reg`.
    """
    if reg <= 0:
        raise ValueError(f"reg must be > 0 (P0 = I / reg); got {reg}")
    device = resolve_device(device)
    eye = torch.eye(n_state, dtype=dtype, device=device) / torch.tensor(
        reg, dtype=dtype, device=device
    )
    p0 = eye[None].expand(e, n_state, n_state).contiguous()
    w0 = torch.zeros((e, n_state, n_out), dtype=dtype, device=device)
    return p0, w0


def _dot(a: torch.Tensor, b: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """sum(a * b) over `dim`, the feature axis, in an order that does not
    depend on where a lane's row lies in memory. On CUDA the product is
    padded with zeros along that axis to a multiple of four elements, so
    every row of the reduction starts 16-byte aligned (the zeros add exactly
    nothing); the CPU sums the product as it is (module docstring)."""
    prod = (a * b).movedim(dim, -1)
    pad = -prod.shape[-1] % 4
    if prod.device.type == "cuda" and pad:
        prod = torch.nn.functional.pad(prod, (0, pad))
    return torch.sum(prod, dim=-1)


def _masked(mask: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    """value where mask (broadcast over value's trailing axes), else 0."""
    m = mask.reshape(mask.shape + (1,) * (value.ndim - mask.ndim))
    return torch.where(m, value, torch.zeros((), dtype=value.dtype, device=value.device))


def rls_update(
    p: torch.Tensor,  # (E, S, S) inverse-Gram per lane
    w: torch.Tensor,  # (E, S, n_out) readout weights per lane
    x: torch.Tensor,  # (E, S) this tick's feature vector per lane
    y: torch.Tensor,  # (E, n_out) this tick's target per lane
    mask: torch.Tensor,  # (E,) bool; False lanes return (p, w) value-frozen
    lam: float,  # forgetting factor in (0, 1], a Python float
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One masked batched RLS step -> (P', W', a-priori predictions (E, n_out)).

    The prediction uses the INCOMING weights. Masked-off lanes keep P and W
    value-frozen (a -0.0 may become +0.0) and still predict. Masking folds
    into the gain (k = 0 -> P - 0, W + 0).
    """
    x = x.to(p.dtype)
    y = y.to(p.dtype)
    px = torch.sum(p * x[:, None, :], dim=-1)  # (E, S)
    denom = lam + torch.sum(x * px, dim=-1)  # (E,)
    k = _masked(mask, px / denom[:, None])  # (E, S)
    pred = torch.sum(w * x[:, :, None], dim=1)  # (E, n_out)
    err = y - pred
    w_new = w + k[:, :, None] * err[:, None, :]
    # k (P x)^T, not k (x^T P): symmetric-by-construction P update
    p_new = p - k[:, :, None] * px[:, None, :]
    if lam != 1.0:
        # frozen lanes divide by exactly 1.0 (an IEEE no-op)
        lam_e = torch.where(
            mask,
            torch.tensor(lam, dtype=p.dtype, device=p.device),
            torch.tensor(1.0, dtype=p.dtype, device=p.device),
        )
        p_new = p_new / lam_e[:, None, None]
    return p_new, w_new, pred


def rls_chunk(
    p: torch.Tensor,  # (E, S, S) inverse-Gram per lane
    w: torch.Tensor,  # (E, S, n_out) readout weights per lane
    xb: torch.Tensor,  # (K, E, S) feature vectors, one row per tick
    y: torch.Tensor,  # (K, E, n_out) targets per tick
    mask: torch.Tensor,  # (K, E) bool; False ticks leave (p, w) value-frozen
    lam: float,  # forgetting factor in (0, 1], a Python float
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K sequential RLS steps applied with O(1) full-P passes per CHUNK.

    P is (E, S, S) — 6.4 GB at E = 256, S = 2501 in f32 — so the per-tick
    recursion would pay ~3K full-P traversals a chunk. This computes the
    same gain sequence from rank-1 algebra on small (E, S) vectors:

        B        = P x_t for all K ticks      ... one read of P (bmm)
        px_t     = cum_t B_t - sum_{j<t} coef_j (px_j . x_t) k_j
        k_t      = mask_t ? px_t / (lam + x_t . px_t) : 0
        W_{t+1}  = W_t + k_t (y_t - W_t^T x_t)^T     (a-priori preds kept)
        P'       = cum_K P - sum_t coef_t k_t px_t^T ... one read + write

    The gains equal K applications of `rls_update` mathematically; the float
    op order differs, so the offline oracle (`core.reservoir.fit_rls(
    block=K)`) runs THIS routine with the same block size. Masked ticks add
    exactly-zero terms. P' is formed by one `torch.baddbmm` (K == 1: one
    `torch.addcmul`) into a new tensor, so no second (E, S, S) temporary
    exists beside P and P' (bit-equal to `p - bmm(...)` on the CPU,
    tests/test_torch_rls.py).
    """
    k_ticks = xb.shape[0]
    xb = xb.to(p.dtype)
    y = y.to(p.dtype)
    dev, dt = p.device, p.dtype
    if k_ticks == 1 and p.device.type == "cuda":
        # a mat-vec per lane; padding (E, S, S) for _dot would copy all of P
        b = torch.bmm(p, xb[0][:, :, None])  # (E, S, 1)
    elif k_ticks == 1:
        # the degenerate GEMM is a mat-vec: the multiply + trailing sum
        # spelling of rls_update, so chunk_ticks=1 runs its op sequence
        b = torch.sum(p * xb[0][:, None, :], dim=-1)[:, :, None]  # (E, S, 1)
    else:
        b = torch.bmm(p, xb.permute(1, 2, 0))  # (E, S, K): P x_t per column

    # gst / pxst grow one (E, 1, S) row per tick: each tick's corrections
    # against all prior pairs are one batched op, O(K) ops a chunk
    gst: Optional[torch.Tensor] = None  # (E, t, S) stacked gains
    pxst: Optional[torch.Tensor] = None  # (E, t, S) stacked px vectors
    preds = []
    if lam != 1.0:
        inv_lam = torch.tensor(1.0 / lam, dtype=dt, device=dev)
        one = torch.tensor(1.0, dtype=dt, device=dev)
        cum = torch.ones(p.shape[0], dtype=dt, device=dev)  # (E,) prod of 1/lam_e
        coefs: Optional[torch.Tensor] = None  # (E, t) coefficient of each pair
    w_t = w
    for t in range(k_ticks):
        x_t = xb[t]  # (E, S)
        px_t = b[:, :, t] if lam == 1.0 else cum[:, None] * b[:, :, t]
        if t:
            c = _dot(pxst, x_t[:, None, :])  # (E, t) px_j . x_t
            if lam != 1.0:
                c = coefs * c
            px_t = px_t - torch.sum(c[:, :, None] * gst, dim=1)
        denom = lam + _dot(x_t, px_t)  # (E,)
        k_t = _masked(mask[t], px_t / denom[:, None])
        pred_t = _dot(w_t, x_t[:, :, None], dim=1)  # (E, n_out)
        w_t = w_t + k_t[:, :, None] * (y[t] - pred_t)[:, None, :]
        preds.append(pred_t)
        if gst is None:
            gst, pxst = k_t[:, None, :], px_t[:, None, :]
        else:
            gst = torch.cat([gst, k_t[:, None, :]], dim=1)
            pxst = torch.cat([pxst, px_t[:, None, :]], dim=1)
        if lam != 1.0:
            u_t = torch.where(mask[t], inv_lam, one)  # (E,)
            coefs = (
                u_t[:, None]
                if coefs is None
                else torch.cat([coefs * u_t[:, None], u_t[:, None]], dim=1)
            )
            cum = cum * u_t
    # P' = cum P - sum_t coef_t k_t px_t^T: one read + write of P, a batched
    # fixed-shape GEMM accumulated into the scaled copy. At K == 1 the
    # product is an outer product, which a batched GEMM of inner size 1 does
    # not round alike at every batch width on the CPU; an elementwise
    # multiply-add does.
    if lam != 1.0:
        gst = coefs[:, :, None] * gst
        p_scaled = cum[:, None, None] * p
        if k_ticks == 1:
            return p_scaled.addcmul_(gst.transpose(1, 2), pxst, value=-1), w_t, torch.stack(preds)
        p_new = p_scaled.baddbmm_(gst.transpose(1, 2), pxst, alpha=-1)
    elif k_ticks == 1:
        p_new = torch.addcmul(p, gst.transpose(1, 2), pxst, value=-1)
    else:
        p_new = torch.baddbmm(p, gst.transpose(1, 2), pxst, alpha=-1)
    return p_new, w_t, torch.stack(preds)  # (E,S,S), (E,S,O), (K,E,O)


# ---------------------------------------------------------------------------
# LMS (normalized least mean squares): the O(S) learner behind
# ExecPlan.learn="lms"
# ---------------------------------------------------------------------------
#
#     pred = W^T x
#     e    = y - pred
#     W'   = W + mu * x e^T / (eps + ||x||^2)        (NLMS normalization)
#
# O(S) state per output column and O(S) work per tick. The ||x||^2
# normalization makes the stable step range 0 < mu < 2 whatever the states'
# scale; eps = 1e-8 guards all-zero feature rows. Every reduction is a
# multiply and a trailing sum, masked ticks fold into the gain, and the
# update is per-tick local, so chunked application is the SAME op sequence
# at any chunk size: fit_lms needs no `block` parameter.

_LMS_EPS = 1e-8


def lms_init(e: int, n_state: int, n_out: int, dtype, device=None) -> torch.Tensor:
    """Fresh per-lane LMS weights: W = 0, shape (E, S, n_out), on `device`
    ("cuda" when None; raises without a card unless given device="cpu")."""
    return torch.zeros((e, n_state, n_out), dtype=dtype, device=resolve_device(device))


def lms_update(
    w: torch.Tensor,  # (E, S, n_out) readout weights per lane
    x: torch.Tensor,  # (E, S) this tick's feature vector per lane
    y: torch.Tensor,  # (E, n_out) this tick's target per lane
    mask: torch.Tensor,  # (E,) bool; False lanes return w value-frozen
    mu: float,  # step size in (0, 2), a Python float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One masked batched NLMS step -> (W', a-priori predictions (E, n_out))."""
    x = x.to(w.dtype)
    y = y.to(w.dtype)
    pred = _dot(w, x[:, :, None], dim=1)  # (E, n_out)
    err = y - pred
    norm = _dot(x, x) + torch.tensor(_LMS_EPS, dtype=w.dtype, device=w.device)
    # a tensor numerator: a Python number over a tensor is a reciprocal
    # and a multiply in torch, two roundings where the reference has one
    g = _masked(mask, torch.tensor(mu, dtype=w.dtype, device=w.device) / norm)
    w_new = w + (g[:, None] * x)[:, :, None] * err[:, None, :]
    return w_new, pred


def lms_chunk(
    w: torch.Tensor,  # (E, S, n_out) readout weights per lane
    xb: torch.Tensor,  # (K, E, S) feature vectors, one row per tick
    y: torch.Tensor,  # (K, E, n_out) targets per tick
    mask: torch.Tensor,  # (K, E) bool; False ticks leave w value-frozen
    mu: float,  # step size in (0, 2)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K sequential NLMS steps -> (W', a-priori preds (K, E, n_out)): the
    per-tick `lms_update` over the chunk's ticks."""
    xb = xb.to(w.dtype)
    y = y.to(w.dtype)
    preds = []
    for t in range(xb.shape[0]):
        w, pred = lms_update(w, xb[t], y[t], mask[t], mu)
        preds.append(pred)
    return w, torch.stack(preds)  # (E, S, n_out), (K, E, n_out)
