"""Wrappers around the hand-written CUDA kernels for the coupled-STO RK4 step.

Three kernels (kernels/csrc/sto_rk4.cu), one per regime, each replacing
the Pallas kernel of the same name in the reference's kernels/sto_step.py:

1. `rk4_chunk`  (chunked serving): K ticks x hold_steps x 4 RK4 stages in
   one cooperative launch, with per-tick input drives and lane masks (a
   frozen lane comes back bit-identical) and the per-tick x-plane states.
2. `rk4_fused`  (small/medium N): n_inner RK4 steps under a constant input
   drive in one cooperative launch.
3. `field_tiled` (large N): one LLG slope per (N-row, E) tile, one launch per
   RK4 stage; `rk4_tiled_step` does the stage algebra and the RK4 combine
   in torch around four launches.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs and scratch with torch.empty, launches on the current stream,
raises if the launch reports a CUDA error, and adds one to its entry of
LAUNCHES after a launch. Tensors on the CPU take the plain version
(kernels/ref.py, or the plain function beside the wrapper) — only because
they are on the CPU; there is no fallback for a CUDA tensor.

The CUDA path takes an f32 state with W in f32 or bf16. The RK4 stage
coefficients dt/2, dt and dt/6 are computed in double on the host and
rounded once to f32.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as kref
from repro_torch.kernels._build import LAUNCHES, reset_launches  # noqa: F401 (re-exported)
from repro_torch.kernels.ref import NP

# Tile sizes of the CUDA kernels (TILE_N / TILE_E in csrc/sto_rk4.cu): the
# kernels take N and E padded to multiples of these (kernels/ops.py pads).
TILE_N = 64
TILE_E = 64


def _field_planes(mx, my, mz, hx, p):
    """Elementwise LLG slope given the coupling/input x-field hx, in the op
    order of the CUDA epilogue. p is a dict of (E,) parameter rows."""
    hz = p["happl"] + p["demag"] * mz
    mdotp = p["px"] * mx + p["py"] * my + p["pz"] * mz
    hs = p["hs_coef"] / (1.0 + p["lam"] * mdotp)
    bx = hx + hs * (p["py"] * mz - p["pz"] * my)
    by = hs * (p["pz"] * mx - p["px"] * mz)
    bz = hz + hs * (p["px"] * my - p["py"] * mx)
    cx = my * bz - mz * by
    cy = mz * bx - mx * bz
    cz = mx * by - my * bx
    dx = my * cz - mz * cy
    dy = mz * cx - mx * cz
    dz = mx * cy - my * cx
    napref = -p["pref"]
    al = p["alpha"]
    return torch.stack(
        [napref * (cx + al * dx), napref * (cy + al * dy), napref * (cz + al * dz)]
    )


# ---------------------------------------------------------------------------
# checks shared by the wrappers
# ---------------------------------------------------------------------------


def _on_cpu(m: torch.Tensor) -> bool:
    if m.device.type == "cpu":
        return True
    if m.device.type != "cuda":
        raise ValueError(f"tensors must live on a cuda or cpu device; got {m.device}")
    return False


def _check_cuda(name: str, **tensors) -> None:
    """Every tensor on m's card, contiguous, of the dtype the kernel takes."""
    dev = tensors["m"].device
    if tensors["m"].dtype != torch.float32:
        raise NotImplementedError(
            f"{name}: the CUDA kernels take an f32 state; got {tensors['m'].dtype} "
            "(an f64 state on CUDA is not supported yet: ROADMAP queue 1 item 4, f64 kernels)"
        )
    for key, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name}: {key} is on {t.device}, m on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
        want = (torch.float32, torch.bfloat16) if key == "w_cp" else (torch.float32,)
        if t.dtype not in want:
            raise ValueError(f"{name}: {key} must be one of {want}; got {t.dtype}")


def _check_tiles(name: str, n: int, e: int, block_n: int, block_e: int) -> None:
    if block_n % TILE_N or block_e % TILE_E:
        raise ValueError(
            f"{name}: block_n/block_e ({block_n}, {block_e}) must be multiples of "
            f"the kernel tiles ({TILE_N}, {TILE_E})"
        )
    if n % block_n or e % block_e:
        raise ValueError(
            f"{name}: N={n}, E={e} must be padded to multiples of ({block_n}, "
            f"{block_e}) (kernels/ops.py pads)"
        )


def _lib():
    """The kernel library, built on first use; its tiles must be ours."""
    lib = _build.load()
    if (lib.sto_tile_n(), lib.sto_tile_e()) != (TILE_N, TILE_E):
        raise RuntimeError(
            f"csrc/sto_rk4.cu tiles ({lib.sto_tile_n()}, {lib.sto_tile_e()}) differ "
            f"from sto_step.TILE_N/TILE_E ({TILE_N}, {TILE_E})"
        )
    return lib


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def _ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream(dev) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def _coop_launch(name, m, w_cp, params, dt, steps, h, h_stride, mask, states):
    """One cooperative launch of the shared chunk/fused body; returns m'."""
    _, n, e = m.shape
    m_out = torch.empty_like(m)
    m_out.copy_(m)
    scratch = torch.empty((7, n, e), dtype=m.dtype, device=m.device)
    dt = float(dt)
    lib = _lib()
    err = lib.sto_rk4_coop(
        int(w_cp.dtype == torch.bfloat16), _ptr(params), _ptr(w_cp), _ptr(h), h_stride,
        None if mask is None else _ptr(mask), _ptr(m_out),
        None if states is None else _ptr(states), _ptr(scratch),
        n, e, h.shape[0] if h_stride else 1, steps,
        dt / 2.0, dt, dt / 6.0, _stream(m.device),
    )
    _raise_on(err, name)
    LAUNCHES[name] += 1
    return m_out


# ---------------------------------------------------------------------------
# Kernel 1: fully fused RK4 (+ multi-step)
# ---------------------------------------------------------------------------


def rk4_fused(
    m: torch.Tensor,  # (3, N, E), N and E already padded
    w_cp: torch.Tensor,  # (N, N)
    params: torch.Tensor,  # (NP, E)
    dt: float,
    n_inner: int = 1,
    block_e: int = TILE_E,
    h_in: torch.Tensor = None,  # (N, E) input-drive x-field; None = undriven
) -> torch.Tensor:
    """n_inner RK4 steps under a constant input drive. Returns (3, N, E)."""
    _, n, e = m.shape
    if h_in is None:
        h_in = torch.zeros((n, e), dtype=m.dtype, device=m.device)
    if _on_cpu(m):
        return kref.rk4_multi_step_planes(m, w_cp, params, dt, n_inner, h_in)
    _check_cuda("rk4_fused", m=m, w_cp=w_cp, params=params, h_in=h_in)
    _check_tiles("rk4_fused", n, e, TILE_N, block_e)
    if w_cp.shape != (n, n) or params.shape != (NP, e) or h_in.shape != (n, e):
        raise ValueError("rk4_fused: w_cp (N, N), params (NP, E), h_in (N, E) expected")
    return _coop_launch("rk4_fused", m, w_cp, params, dt, n_inner, h_in, 0, None, None)


# ---------------------------------------------------------------------------
# Kernel 2: tiled field evaluation (+ fused stage algebra) for large N
# ---------------------------------------------------------------------------


def field_tiled_plain(m, yx_full, k_prev, w_cp, params, stage_coef, h_in):
    """k = f(m + stage_coef * k_prev) with the coupling taken against the
    full stage x-plane yx_full; stage_coef = 0 skips the stage algebra."""
    p = kref._unpack(params)
    hx = p["a_cp"] * kref.coupling_dot(w_cp, yx_full, m.dtype) + h_in
    y = m if stage_coef == 0.0 else m + stage_coef * k_prev
    return _field_planes(y[0], y[1], y[2], hx, p)


def field_tiled(
    m: torch.Tensor,  # (3, N, E) base state
    yx_full: torch.Tensor,  # (N, E) x-plane of the stage state y
    k_prev: torch.Tensor,  # (3, N, E) previous slope (ignored when coef=0)
    w_cp: torch.Tensor,  # (N, N)
    params: torch.Tensor,  # (NP, E)
    stage_coef: float,
    block_n: int = TILE_N,
    block_e: int = TILE_E,
    h_in: torch.Tensor = None,  # (N, E) input-drive x-field; None = undriven
) -> torch.Tensor:
    """One LLG slope k = f(m + stage_coef * k_prev) per (row, lane)."""
    _, n, e = m.shape
    if h_in is None:
        h_in = torch.zeros((n, e), dtype=m.dtype, device=m.device)
    if _on_cpu(m):
        return field_tiled_plain(m, yx_full, k_prev, w_cp, params, stage_coef, h_in)
    _check_cuda(
        "field_tiled", m=m, yx_full=yx_full, k_prev=k_prev, w_cp=w_cp, params=params, h_in=h_in
    )
    _check_tiles("field_tiled", n, e, block_n, block_e)
    if (
        w_cp.shape != (n, n)
        or params.shape != (NP, e)
        or yx_full.shape != (n, e)
        or h_in.shape != (n, e)
        or k_prev.shape != m.shape
    ):
        raise ValueError("field_tiled: operand shapes do not match m (3, N, E)")
    out = torch.empty_like(m)
    lib = _lib()
    err = lib.sto_field_tiled(
        int(w_cp.dtype == torch.bfloat16), _ptr(params), _ptr(w_cp), _ptr(h_in),
        _ptr(yx_full), _ptr(m), _ptr(k_prev), _ptr(out), float(stage_coef),
        int(stage_coef != 0.0), n, e, _stream(m.device),
    )
    _raise_on(err, "field_tiled")
    LAUNCHES["field_tiled"] += 1
    return out


# ---------------------------------------------------------------------------
# Kernel 3: the chunk-resident serving kernel
# ---------------------------------------------------------------------------


def rk4_chunk(
    m: torch.Tensor,  # (3, N, E), N and E already padded
    w_cp: torch.Tensor,  # (N, N); may be pre-cast (reduced-precision coupling)
    params: torch.Tensor,  # (NP, E)
    dt: float,
    hold_steps: int,
    h_block: torch.Tensor,  # (K, N, E) per-tick input-drive x-fields
    mask_block: torch.Tensor,  # (K, E) f32 0/1 per-tick lane masks
    block_e: int = TILE_E,
):
    """K ticks x hold_steps x 4 stages in one launch.

    Returns (m' (3, N, E), states (K, N, E) per-tick x-planes).
    """
    _, n, e = m.shape
    k_ticks = h_block.shape[0]
    if _on_cpu(m):
        return kref.rk4_chunk_planes(m, w_cp, params, dt, hold_steps, h_block, mask_block > 0.5)
    _check_cuda("rk4_chunk", m=m, w_cp=w_cp, params=params, h_block=h_block, mask_block=mask_block)
    _check_tiles("rk4_chunk", n, e, TILE_N, block_e)
    if (
        w_cp.shape != (n, n)
        or params.shape != (NP, e)
        or h_block.shape != (k_ticks, n, e)
        or mask_block.shape != (k_ticks, e)
    ):
        raise ValueError(
            "rk4_chunk: w_cp (N, N), params (NP, E), h_block (K, N, E), "
            "mask_block (K, E) expected"
        )
    states = torch.empty((k_ticks, n, e), dtype=m.dtype, device=m.device)
    m_out = _coop_launch(
        "rk4_chunk", m, w_cp, params, dt, hold_steps, h_block, n * e, mask_block, states
    )
    return m_out, states


# ---------------------------------------------------------------------------
# One RK4 step from four tiled field launches
# ---------------------------------------------------------------------------


def _tiled_step(field, m, dt, h_in):
    dt = float(dt)
    zeros = torch.zeros_like(m)
    k1 = field(m, m[0], zeros, stage_coef=0.0, h_in=h_in)
    k2 = field(m, m[0] + (0.5 * dt) * k1[0], k1, stage_coef=0.5 * dt, h_in=h_in)
    k3 = field(m, m[0] + (0.5 * dt) * k2[0], k2, stage_coef=0.5 * dt, h_in=h_in)
    k4 = field(m, m[0] + dt * k3[0], k3, stage_coef=dt, h_in=h_in)
    return m + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


def rk4_tiled_step(
    m: torch.Tensor,
    w_cp: torch.Tensor,
    params: torch.Tensor,
    dt: float,
    block_n: int = TILE_N,
    block_e: int = TILE_E,
    h_in: torch.Tensor = None,
) -> torch.Tensor:
    """One RK4 step built from four `field_tiled` launches; the y^x stage
    planes and the RK4 combine are O(N E) torch ops beside the O(N^2 E)
    in-kernel coupling."""
    field = functools.partial(
        field_tiled, w_cp=w_cp, params=params, block_n=block_n, block_e=block_e
    )
    return _tiled_step(field, m, dt, h_in)


def rk4_tiled_step_plain(m, w_cp, params, dt, h_in=None):
    """`rk4_tiled_step` through the plain field (any device)."""
    if h_in is None:
        h_in = torch.zeros(m.shape[1:], dtype=m.dtype, device=m.device)

    def field(m_, yx, kp, stage_coef, h_in):
        return field_tiled_plain(m_, yx, kp, w_cp, params, stage_coef, h_in)

    return _tiled_step(field, m, dt, h_in)
