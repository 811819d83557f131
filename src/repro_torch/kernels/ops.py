"""Public wrappers around the CUDA kernels: layout, padding, dispatch.

Handles layout conversion ((E, N, 3) user layout <-> (3, N, E) kernel
layout), padding to the kernels' tiles, and implementation dispatch:

    impl="fused"  whole-RK4(-multi-step) cooperative kernel (small/med N)
    impl="tiled"  per-stage row-tiled kernel (large N)
    impl="ref"    plain PyTorch version (the CPU's production path)
    impl="chunk"  chunk-resident serving kernel: the K-tick x hold_steps x
                  4-stage loop in ONE cooperative launch on CUDA (the plain
                  chunk body elsewhere). Per-hold-window entry points run it
                  as a one-tick chunk.
    impl="auto"   measured-latency table if populated; else, on CUDA, fused
                  while W and the kernel's scratch planes fit the L2 budget,
                  else tiled; on the CPU always ref. Never "ref" on CUDA.

`interpret=True` runs the plain versions of the kernels through the same
padding and dispatch (the reference's interpret mode, which runs the Pallas
kernels through the interpreter). It is an explicit request, never a default.

Precision policies (ExecPlan.precision) resolve HERE into a single W cast
hoisted outside the integration loops: "bf16_coupling"/"mixed" pass a bf16
W into the kernels and plain versions, whose coupling products consume the
reduced operands and accumulate in the state dtype.

Serving extensions:
  - `h_in`: an (N, E) input-drive x-field added to the coupling field,
    held constant over the integration window.
  - `lane_mask`: lanes where the mask is False come back bit-identical to
    their input state (a select), so idle serving slots stay frozen.

Zero-padding correctness: padded W rows/cols are zero so padded oscillators
receive/contribute no coupling; padded h_in rows/lanes are zero; padded
lanes are dropped on exit; params are edge-broadcast into padded lanes so no
division hits an uninitialised value (denominators are 1 + lam*m.p >= 1-lam).
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import constants, coupling
from repro_torch.core.constants import STOParams
from repro_torch.kernels import ref as kref
from repro_torch.kernels import sto_step

# Padding granules: the CUDA kernels' tiles.
BLOCK_N = sto_step.TILE_N
BLOCK_E = sto_step.TILE_E

# L2 budget used by auto-dispatch (bytes). An H100 has 50 MB of L2 (NVIDIA
# Hopper white paper). The cooperative fused kernel re-reads W and its
# scratch planes at every stage, so it is preferred while they stay
# L2-resident; 40 MB leaves room for the input and output planes.
L2_BUDGET = 40 * 1000 * 1000
# planes (N, E) the cooperative kernel keeps live: state x3, stage x-plane
# x2, stage y/z x2, RK4 accumulator x3
COOP_PLANES = 10


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def fused_fits_l2(n: int, e: int, w_itemsize: int = 4) -> bool:
    """W (n^2) + the cooperative kernel's f32 planes must fit the L2 budget."""
    need = n * n * w_itemsize + COOP_PLANES * n * e * 4
    return need <= L2_BUDGET


def _platform(device=None) -> str:
    if device is not None:
        return torch.device(device).type
    return "cuda" if torch.cuda.is_available() else "cpu"


# ---------------------------------------------------------------------------
# Measured-latency dispatch table
# ---------------------------------------------------------------------------

# (platform, N_padded, E_padded, itemsize, precision) -> impl name, filled by
# measure_impl_latency(), register_impl_choice() and the persisted
# per-platform JSON tables (kernels/dispatch_table.py, loaded lazily by
# choose_impl); consulted before the platform gate / L2 heuristic.
_LATENCY_TABLE: Dict[Tuple[str, int, int, int, str], str] = {}

# Bumped on every change of the table: the api layer's PlanCache keys
# impl="auto" plans on it, so a cached auto resolution is dropped the moment
# a new measurement pins another winner.
_DISPATCH_GEN = 0


def dispatch_generation() -> int:
    """Monotonic version of the in-process dispatch table state."""
    return _DISPATCH_GEN


# The bit-exact default's tag in dispatch keys (ExecPlan.precision None and
# "highest" collapse to this).
PRECISION_DEFAULT = "highest"
# the policies whose coupling GEMM consumes a bf16 W
REDUCED_COUPLING = ("bf16_coupling", "mixed")


def normalize_precision(precision: Optional[str]) -> str:
    """Collapse the ExecPlan.precision aliases to a dispatch-key tag."""
    return PRECISION_DEFAULT if precision in (None, PRECISION_DEFAULT) else precision


def register_impl_choice(
    n: int,
    e: int,
    impl: str,
    platform: Optional[str] = None,
    itemsize: int = 4,
    precision: Optional[str] = None,
):
    """Pin the dispatch choice for a padded (N, E, itemsize, precision)
    shape on a platform."""
    global _DISPATCH_GEN
    _DISPATCH_GEN += 1
    _LATENCY_TABLE[dispatch_key(n, e, platform, itemsize, precision)] = impl


def dispatch_key(
    n: int,
    e: int,
    platform: Optional[str] = None,
    itemsize: int = 4,
    precision: Optional[str] = None,
) -> Tuple[str, int, int, int, str]:
    """The dispatch table's key of an (N, E, itemsize, precision) shape."""
    return (
        platform or _platform(),
        _round_up(n, BLOCK_N),
        _round_up(e, BLOCK_E),
        itemsize,
        normalize_precision(precision),
    )


def latency_table() -> Dict[Tuple[str, int, int, int, str], str]:
    return dict(_LATENCY_TABLE)


def clear_latency_table() -> None:
    """Drop every in-process dispatch entry (persisted files untouched)."""
    global _DISPATCH_GEN
    _DISPATCH_GEN += 1
    _LATENCY_TABLE.clear()


def choose_impl(
    n: int,
    e: int,
    itemsize: int = 4,
    platform: Optional[str] = None,
    precision: Optional[str] = None,
) -> str:
    """Resolve impl="auto" for a given (N, E, precision) problem shape.

    Priority: the measured-latency table (in-process measurements, then
    the platform's persisted JSON from kernels/dispatch_table.py) — first
    at the exact precision key, then at the bit-exact default key for the
    same shape — > platform gate (the CUDA kernels run only on "cuda"; the
    CPU integrates through the plain version) > L2-fit heuristic (fused or
    tiled).
    """
    from repro_torch.kernels import dispatch_table

    platform = platform or _platform()
    dispatch_table.ensure_loaded(platform)
    prec = normalize_precision(precision)
    shape_key = (platform, _round_up(n, BLOCK_N), _round_up(e, BLOCK_E), itemsize)
    if shape_key + (prec,) in _LATENCY_TABLE:
        return _LATENCY_TABLE[shape_key + (prec,)]
    if prec != PRECISION_DEFAULT and shape_key + (PRECISION_DEFAULT,) in _LATENCY_TABLE:
        return _LATENCY_TABLE[shape_key + (PRECISION_DEFAULT,)]
    if platform != "cuda":
        return "ref"
    w_itemsize = 2 if prec in REDUCED_COUPLING else 4
    n_p, e_p = _round_up(n, BLOCK_N), _round_up(e, BLOCK_E)
    return "fused" if fused_fits_l2(n_p, e_p, w_itemsize) else "tiled"


def measure_impl_latency(
    n: int,
    e: int,
    dt: float = 1.0e-11,
    n_steps: int = 8,
    candidates: Optional[Tuple[str, ...]] = None,
    dtype=torch.float32,
    reps: int = 3,
    register: bool = True,
    precision: Optional[str] = None,
    chunk_ticks: int = 4,
    device=None,
) -> Dict[str, object]:
    """Time each candidate impl at (N, E, precision) and record the winner.

    Each candidate runs the chunked serving shape — chunk_ticks hold windows
    of n_steps each. On CUDA the time is the median of `reps` runs timed with
    CUDA events (after one warm-up run that also builds the kernels); on the
    CPU, where only "ref" runs by default, with the host clock.

    Returns {impl: seconds per chunk}, plus a "failed" entry mapping impl
    name to the error string for candidates that raised (also surfaced as a
    RuntimeWarning, so a broken backend shows in the report instead of
    silently skewing the table). With register=True the fastest surviving
    impl is written into the dispatch table.
    """
    platform = _platform(device)
    dev = torch.device(platform if device is None else device)
    if candidates is None:
        candidates = ("fused", "tiled", "chunk") if platform == "cuda" else ("ref",)
    w = torch.as_tensor(coupling.make_coupling_matrix(n, seed=0), dtype=dtype).to(dev)
    m_user = constants.initial_magnetization(n, dtype, device=dev).expand(e, n, 3)
    m0 = to_planes(m_user).contiguous()
    pv = kref.pack_params(constants.default_params(dtype, device=dev), e, dtype)
    h_block = torch.zeros((chunk_ticks, n, e), dtype=dtype, device=dev)
    mask_block = torch.ones((chunk_ticks, e), dtype=torch.bool, device=dev)
    timings: Dict[str, object] = {}
    failed: Dict[str, str] = {}
    for impl in candidates:

        def fn():
            return sto_rk4_tick_chunk_planes(
                m0, w, pv, float(dt), n_steps, h_block, mask_block,
                impl=impl, precision=precision,
            )[0]

        try:
            fn()  # build + warm
            times = []
            for _ in range(reps):
                if platform == "cuda":
                    start = torch.cuda.Event(enable_timing=True)
                    stop = torch.cuda.Event(enable_timing=True)
                    start.record()
                    fn()
                    stop.record()
                    stop.synchronize()
                    times.append(start.elapsed_time(stop) / 1e3)
                else:
                    t0 = time.perf_counter()
                    fn()
                    times.append(time.perf_counter() - t0)
            timings[impl] = sorted(times)[len(times) // 2]
        except (RuntimeError, ValueError, NotImplementedError) as exc:
            failed[impl] = f"{type(exc).__name__}: {exc}"
    if failed:
        import warnings

        timings["failed"] = failed
        warnings.warn(
            f"measure_impl_latency({n}, {e}): candidate impl(s) failed and "
            f"were excluded from dispatch: "
            + ", ".join(f"{k} ({v})" for k, v in failed.items()),
            RuntimeWarning,
            stacklevel=2,
        )
    successes = {k: v for k, v in timings.items() if isinstance(v, float)}
    if register and successes:
        register_impl_choice(
            n, e, min(successes, key=successes.get), platform=platform,
            itemsize=torch.empty((), dtype=dtype).element_size(), precision=precision,
        )
    return timings


# ---------------------------------------------------------------------------
# Layout conversion + padding
# ---------------------------------------------------------------------------


def to_planes(m_user: torch.Tensor) -> torch.Tensor:
    """(..., N, 3) -> (3, N, E) kernel layout (E = flattened batch, >=1)."""
    if m_user.ndim == 2:
        m_user = m_user[None]
    n = m_user.shape[-2]
    flat = m_user.reshape(-1, n, 3)
    return flat.permute(2, 1, 0)


def from_planes(m_planes: torch.Tensor, batch_shape) -> torch.Tensor:
    """(3, N, E) -> (*batch_shape, N, 3)."""
    out = m_planes.permute(2, 1, 0)  # (E, N, 3)
    return out.reshape(*batch_shape, m_planes.shape[1], 3)


def _pad_planes(m, w, params, h_in, block_n, block_e):
    """Pad m/W/h with zeros and params by edge-broadcast to the granules;
    returns contiguous operands and the original (N, E)."""
    _, n, e = m.shape
    n_p = _round_up(max(n, 1), block_n)
    e_p = _round_up(max(e, 1), block_e)
    if n_p != n or e_p != e:
        m = torch.nn.functional.pad(m, (0, e_p - e, 0, n_p - n))
        w = torch.nn.functional.pad(w, (0, n_p - n, 0, n_p - n))
        if h_in is not None:
            h_in = torch.nn.functional.pad(h_in, (0, e_p - e, 0, n_p - n))
        # broadcast params into padded lanes (edge mode keeps denominators sane)
        params = torch.cat([params, params[:, -1:].expand(-1, e_p - e)], dim=1)
    return (
        m.contiguous(),
        w.contiguous(),
        params.contiguous(),
        None if h_in is None else h_in.contiguous(),
        n,
        e,
    )


# ---------------------------------------------------------------------------
# Precision policy
# ---------------------------------------------------------------------------


def input_field_einsum(eq: str, w_in, u, precision) -> torch.Tensor:
    """The input-field GEMM under the precision policy — ONE home for it.

    "mixed" runs W^in u on bf16 operands accumulating in the input dtype
    (both widened exactly before the product); every other policy runs the
    plain einsum in the input dtype.
    """
    if precision == "mixed":
        return torch.einsum(
            eq,
            w_in.to(torch.bfloat16).to(u.dtype),
            u.to(torch.bfloat16).to(u.dtype),
        )
    if u.is_cuda:
        kref.require_full_f32_matmul()
    return torch.einsum(eq, w_in, u)


def _coupling_operand(w: torch.Tensor, precision: str) -> torch.Tensor:
    """Resolve the precision policy into the W operand the kernels consume.

    The cast happens ONCE, outside the integration loops. "mixed" adds the
    input-field GEMM on top of "bf16_coupling" (api layer), so here both map
    to a bf16 W.
    """
    if precision in REDUCED_COUPLING:
        return w.to(torch.bfloat16)
    return w


# ---------------------------------------------------------------------------
# Integration entry points
# ---------------------------------------------------------------------------


def sto_rk4_integrate_planes(
    m0: torch.Tensor,  # (3, N, E) kernel layout
    w_cp: torch.Tensor,  # (N, N)
    params_vec: torch.Tensor,  # (NP, E) packed (kernels/ref.pack_params)
    dt: float,
    n_steps: int,
    h_in: Optional[torch.Tensor] = None,  # (N, E) input-drive x-field
    lane_mask: Optional[torch.Tensor] = None,  # (E,) bool; False lanes frozen
    impl: str = "auto",
    n_inner: int = 8,
    block_n: int = BLOCK_N,
    block_e: int = BLOCK_E,
    interpret: bool = False,
    precision: Optional[str] = None,
) -> torch.Tensor:
    """Integrate n_steps of (optionally driven) coupled-STO RK4 in kernel
    layout. Returns the final (3, N, E) state. impl="auto" resolves here,
    against the dispatch table, on every call."""
    _, n, e = m0.shape
    if impl == "auto":
        impl = choose_impl(
            n, e, m0.element_size(), platform=m0.device.type, precision=precision
        )
    return _integrate_planes(
        m0, w_cp, params_vec, h_in, lane_mask,
        dt=dt, n_steps=n_steps, impl=impl, n_inner=n_inner,
        block_n=block_n, block_e=block_e, interpret=interpret,
        precision=normalize_precision(precision),
    )


def _integrate_planes(
    m0, w_cp, params_vec, h_in, lane_mask,
    *, dt, n_steps, impl, n_inner, block_n, block_e, interpret,
    precision=PRECISION_DEFAULT,
):
    # the plain version needs no tiles, so padding would only burn FLOPs on
    # dead lanes; the kernels (and their plain versions under interpret) pad.
    # "chunk" at the per-hold-window level is a one-tick chunk: the kernel on
    # CUDA, the plain ref steps elsewhere.
    use_chunk_kernel = impl == "chunk" and (m0.is_cuda or interpret)
    pb_n, pb_e = (
        (1, 1) if impl in ("ref", "chunk") and not use_chunk_kernel else (block_n, block_e)
    )
    m, w, pv, h, n_orig, e_orig = _pad_planes(m0, w_cp, params_vec, h_in, pb_n, pb_e)
    w = _coupling_operand(w, precision)

    if use_chunk_kernel:
        _, n_p, e_p = m.shape
        h_block = (
            torch.zeros((1, n_p, e_p), dtype=m.dtype, device=m.device) if h is None else h[None]
        )
        ones = torch.ones((1, e_p), dtype=m.dtype, device=m.device)
        if interpret:
            m, _ = kref.rk4_chunk_planes(m, w, pv, dt, n_steps, h_block, ones > 0.5)
        else:
            m, _ = sto_step.rk4_chunk(m, w, pv, dt, n_steps, h_block, ones, block_e=block_e)
    elif impl in ("ref", "chunk"):
        dt_c = torch.full((), float(dt), dtype=m.dtype, device=m.device)
        for _ in range(n_steps):
            m = kref.rk4_step_planes(m, w, pv, dt_c, h)
    elif impl == "fused":
        while n_steps % n_inner != 0:
            n_inner -= 1
        for _ in range(n_steps // n_inner):
            if interpret:
                m = kref.rk4_multi_step_planes(m, w, pv, dt, n_inner, h)
            else:
                m = sto_step.rk4_fused(m, w, pv, dt, n_inner=n_inner, block_e=block_e, h_in=h)
    elif impl == "tiled":
        for _ in range(n_steps):
            if interpret:
                m = sto_step.rk4_tiled_step_plain(m, w, pv, dt, h_in=h)
            else:
                m = sto_step.rk4_tiled_step(
                    m, w, pv, dt, block_n=block_n, block_e=block_e, h_in=h
                )
    else:
        raise ValueError(f"unknown impl: {impl}")

    m = m[:, :n_orig, :e_orig]
    if lane_mask is not None:
        # frozen lanes return their input state bit-identically (a select)
        m = torch.where(lane_mask[None, None, :], m, m0)
    return m


def sto_rk4_tick_chunk_planes(
    m0: torch.Tensor,  # (3, N, E) kernel layout
    w_cp: torch.Tensor,  # (N, N)
    params_vec: torch.Tensor,  # (NP, E) packed (kernels/ref.pack_params)
    dt: float,
    hold_steps: int,
    h_block: torch.Tensor,  # (K, N, E) per-tick input-drive x-fields
    mask_block: torch.Tensor,  # (K, E) bool; False = lane frozen that tick
    impl: str = "auto",
    precision: Optional[str] = None,
    n_inner: int = 8,
    block_n: int = BLOCK_N,
    block_e: int = BLOCK_E,
    interpret: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K serving ticks (K hold windows) in kernel layout.

    impl="chunk" runs the whole K x hold_steps x 4-stage loop in one launch
    (the plain chunk body off CUDA); the per-window impls (ref/fused/tiled)
    loop over ticks re-entering their kernels. Returns (m' (3, N, E),
    states (K, N, E)). Frozen (masked False) lanes come back bit-identical
    for every impl.
    """
    _, n, e = m0.shape
    if impl == "auto":
        impl = choose_impl(
            n, e, m0.element_size(), platform=m0.device.type, precision=precision
        )
    return _tick_chunk_planes(
        m0, w_cp, params_vec, h_block, mask_block,
        dt=dt, hold_steps=hold_steps, impl=impl, n_inner=n_inner,
        block_n=block_n, block_e=block_e, interpret=interpret,
        precision=normalize_precision(precision),
    )


def _tick_chunk_planes(
    m0, w_cp, params_vec, h_block, mask_block,
    *, dt, hold_steps, impl, n_inner, block_n, block_e, interpret,
    precision=PRECISION_DEFAULT,
):
    use_chunk_kernel = impl == "chunk" and (m0.is_cuda or interpret)
    pb_n, pb_e = (1, 1) if impl in ("ref", "chunk") else (block_n, block_e)
    if use_chunk_kernel:
        pb_n, pb_e = block_n, block_e
    m, w, pv, _, n_orig, e_orig = _pad_planes(m0, w_cp, params_vec, None, pb_n, pb_e)
    _, n_p, e_p = m.shape
    if (n_p, e_p) != tuple(h_block.shape[1:]):
        h_block = torch.nn.functional.pad(
            h_block, (0, e_p - h_block.shape[2], 0, n_p - h_block.shape[1])
        )
        # padded lanes stay frozen
        mask_block = torch.nn.functional.pad(mask_block, (0, e_p - mask_block.shape[1]))
    h_block = h_block.contiguous()
    w = _coupling_operand(w, precision)

    if use_chunk_kernel:
        if interpret:
            mT, states = kref.rk4_chunk_planes(m, w, pv, dt, hold_steps, h_block, mask_block)
        else:
            mT, states = sto_step.rk4_chunk(
                m, w, pv, dt, hold_steps, h_block,
                mask_block.to(m.dtype).contiguous(), block_e=block_e,
            )
    elif impl in ("ref", "chunk"):
        mT, states = kref.rk4_chunk_planes(m, w, pv, dt, hold_steps, h_block, mask_block)
    elif impl in ("fused", "tiled"):
        if impl == "fused":
            while hold_steps % n_inner != 0:
                n_inner -= 1
        mm, rows = m, []
        for t in range(h_block.shape[0]):
            h_t = h_block[t]
            m_new = mm
            if impl == "fused":
                for _ in range(hold_steps // n_inner):
                    m_new = (
                        kref.rk4_multi_step_planes(m_new, w, pv, dt, n_inner, h_t)
                        if interpret
                        else sto_step.rk4_fused(
                            m_new, w, pv, dt, n_inner=n_inner, block_e=block_e, h_in=h_t
                        )
                    )
            else:
                for _ in range(hold_steps):
                    m_new = (
                        sto_step.rk4_tiled_step_plain(m_new, w, pv, dt, h_in=h_t)
                        if interpret
                        else sto_step.rk4_tiled_step(
                            m_new, w, pv, dt, block_n=block_n, block_e=block_e, h_in=h_t
                        )
                    )
            mm = torch.where(mask_block[t][None, None, :], m_new, mm)
            rows.append(mm[0])
        mT, states = mm, torch.stack(rows)
    else:
        raise ValueError(f"unknown impl: {impl}")

    return mT[:, :n_orig, :e_orig], states[:, :n_orig, :e_orig]


def sto_rk4_integrate(
    m0: torch.Tensor,  # (..., N, 3) user layout
    w_cp: torch.Tensor,  # (N, N)
    params_vec: torch.Tensor,  # (NP, E) packed (kernels/ref.pack_params)
    dt: float,
    n_steps: int,
    impl: str = "auto",
    n_inner: int = 8,
    block_n: int = BLOCK_N,
    block_e: int = BLOCK_E,
    interpret: bool = False,
    precision: Optional[str] = None,
) -> torch.Tensor:
    """Integrate n_steps of coupled-STO RK4 with the chosen implementation.

    Returns the final state in user layout. n_steps must be divisible by
    n_inner for the fused path (auto-adjusted otherwise).
    """
    batch_shape = m0.shape[:-2]
    e = 1
    for s in batch_shape:
        e *= int(s)
    if impl == "auto":
        impl = choose_impl(
            m0.shape[-2], e, m0.element_size(), platform=m0.device.type, precision=precision
        )
    m = _integrate_planes(
        to_planes(m0), w_cp, params_vec, None, None,
        dt=dt, n_steps=n_steps, impl=impl, n_inner=n_inner,
        block_n=block_n, block_e=block_e, interpret=interpret,
        precision=normalize_precision(precision),
    )
    return from_planes(m, batch_shape)


def sto_rk4_step(
    m0: torch.Tensor,
    w_cp: torch.Tensor,
    params: STOParams,
    dt: float,
    impl: str = "auto",
    interpret: bool = False,
    block_n: int = BLOCK_N,
    block_e: int = BLOCK_E,
) -> torch.Tensor:
    """Single RK4 step convenience wrapper taking STOParams directly."""
    e = 1
    for s in m0.shape[:-2]:
        e *= int(s)
    pv = kref.pack_params(params, e, dtype=m0.dtype)
    return sto_rk4_integrate(
        m0, w_cp, pv, dt, 1,
        impl=impl, n_inner=1, block_n=block_n, block_e=block_e, interpret=interpret,
    )
