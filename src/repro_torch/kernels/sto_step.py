"""Wrappers around the hand-written CUDA kernels for the STO RK4 step.

Three kernels (kernels/csrc/sto_rk4.cu), one per regime, each replacing
the Pallas kernel of the same name in the reference's kernels/sto_step.py:

1. `rk4_chunk`  (chunked serving): K ticks x hold_steps x 4 RK4 stages in
   one cooperative launch, with per-tick input drives and lane masks (a
   frozen lane comes back bit-identical) and the per-tick x-plane states.
2. `rk4_fused`  (small/medium N): n_inner RK4 steps under a constant input
   drive in one cooperative launch.
   Both launch `rk4_coop_kernel` with the work split of `coop_split`:
   thread-block clusters that each sum one output tile (64 rows for an f32
   W, 128 for a bf16 W, x 256 lanes), one contraction slice per block;
   `coop_block_work` says what each block computes, in the kernel's own
   formulas.
3. `field_tiled` (large N): one LLG slope k = f(m + c k_prev) per (row,
   lane), from `field_stage_kernel` with the work split of `field_split`
   (the same clusters and slices as `coop_split`, one output tile per
   cluster, in an ordinary launch). `rk4_tiled_step` is four launches of
   the same kernel, one per RK4 stage, whose epilogue also writes the next
   stage's x-plane, the running RK4 sum and, at stage 4, the new state; no
   elementwise torch op runs between them. For a bf16 W, a small kernel
   (`round_bf16_kernel`, counted under LAUNCHES["round_bf16"]) first rounds
   the f32 x-plane the caller gives (field_tiled) or m^x (rk4_tiled_step).

A fourth kernel (kernels/csrc/sto_delay_line.cu) runs the time-multiplexed
family's delay line: `tm_delay_line` is one tick of it for every lane (one
thread a lane, the oscillator in registers), and `tm_chunk` K ticks, each
the feedback product (torch.matmul) and one launch. It replaces the node
loop of the reference's plain-jnp `tm_chunk_planes`, which XLA compiles
into one device loop on the TPU, and gives its plain version's bits.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs and scratch with torch.empty, launches on the current stream,
raises if the launch reports a CUDA error, and adds one to its entry of
LAUNCHES after a launch. On fake tensors (a dry run, launch/dryrun.py) it
launches nothing and reports the launch's FLOPs and bytes instead
(`_build.fake_launch`; the formulas of chip_smoke.py's bounds). Tensors on
the CPU take the plain version (kernels/ref.py, or the plain function
beside the wrapper) — only because they are on the CPU; there is no
fallback for a CUDA tensor.

The CUDA path takes an f32 state with W in f32 or bf16. The RK4 stage
coefficients dt/2, dt and dt/6 are computed in double on the host and
rounded once to f32.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Callable, Iterator, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as kref
from repro_torch.kernels._build import LAUNCHES, reset_launches  # noqa: F401 (re-exported)
from repro_torch.kernels.ref import NP

# Tile sizes of the CUDA kernels (TILE_N / TILE_E in csrc/sto_rk4.cu): the
# kernels take N and E padded to multiples of these (kernels/ops.py pads).
TILE_N = 64
TILE_E = 64
# rk4_coop_kernel (Product<WT>::ROWS, SLICE, CO_LANES, MAX_CLUSTER in
# csrc/sto_rk4.cu): an output tile is COOP_ROWS[W dtype] rows x COOP_LANES
# lanes, the contraction is cut into slices of whole SLICE units, and a
# cluster has at most MAX_CLUSTER blocks (the portable cluster size).
COOP_ROWS = {torch.float32: 64, torch.bfloat16: 128}
SLICE = 64
COOP_LANES = 256
MAX_CLUSTER = 8
# FLOPs of the LLG epilogue and the stage algebra per (oscillator, lane,
# stage), and of one RK4 step of one lane in the delay-line kernel (4 x 51 in
# the field, 18 in the stage updates, 21 in the combination): the bounds'
# operation counts
EPILOGUE_FLOPS = 60
STEP_OPS = 4 * 51 + 18 + 21


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


@functools.lru_cache(maxsize=None)
def _lib():
    """The kernel library, built on first use; its tiles must be ours (checked
    once)."""
    lib = _build.load()
    theirs = (
        lib.sto_tile_n(), lib.sto_tile_e(), lib.sto_coop_rows(0), lib.sto_coop_rows(1),
        lib.sto_coop_slice(), lib.sto_coop_lanes(), lib.sto_coop_max_cluster(),
    )
    ours = (
        TILE_N, TILE_E, COOP_ROWS[torch.float32], COOP_ROWS[torch.bfloat16], SLICE,
        COOP_LANES, MAX_CLUSTER,
    )
    if theirs != ours:
        raise RuntimeError(
            f"csrc/sto_rk4.cu tiles {theirs} differ from sto_step's (TILE_N, TILE_E, "
            f"COOP_ROWS f32/bf16, SLICE, COOP_LANES, MAX_CLUSTER) {ours}"
        )
    return lib


def _fake_launch(name, tensors, gemm_flops, gemm_kind, other_flops) -> None:
    """A dry run's launch: `gemm_flops` at the rate of `gemm_kind`, the rest
    as FP32; each operand (None skipped) read or written once."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors if t is not None)
    flops = {"bf16": 0.0, "f32": float(other_flops)}
    flops[gemm_kind] += float(gemm_flops)
    _build.fake_launch(name, flops, nbytes)


def _gemm_kind(w_cp) -> str:
    return "bf16" if w_cp.dtype == torch.bfloat16 else "f32"


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def _ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream(dev) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


# ---------------------------------------------------------------------------
# The cooperative kernel's work split
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CoopSplit:
    """How one rk4_coop_kernel launch divides a stage's coupling product.

    `clusters` clusters of `cluster` blocks each; the `items` output tiles
    (`rows` rows x COOP_LANES lanes) go to the clusters in turn, and rank r
    of a cluster sums contraction slice r of each of its tiles
    (`coop_block_work`).
    """

    cluster: int  # blocks per cluster = contraction slices per tile
    clusters: int  # clusters launched (co-resident; field_split: one per tile)
    rows: int  # rows per output tile (COOP_ROWS of the W dtype)
    col_tiles: int  # lane tiles: ceil(E / COOP_LANES)
    items: int  # output tiles: ceil(N / rows) x col_tiles
    resident: int = 0  # co-resident clusters of this size on the card

    @property
    def blocks(self) -> int:
        return self.cluster * self.clusters

    @property
    def rounds(self) -> int:
        """Tiles a cluster takes in turn (rk4_coop_kernel)."""
        return -(-self.items // self.clusters)

    @property
    def waves(self) -> int:
        """Waves of co-resident clusters that run the items."""
        return -(-self.items // max(self.resident, 1))


def split_cost(n: int, rows: int, cluster: int, resident: int) -> int:
    """The time `_cluster_size` weighs for clusters of `cluster` blocks, of
    which `resident` fit the card at once, at a padded N and tiles of `rows`
    rows, in quarters of a 64-row slice unit: with T = ceil(N / rows) row
    tiles and U = N / SLICE slice units, (rounds or waves of T tiles over the
    co-resident clusters) x (work of one: the longest slice, ceil(U / C)
    units of a rows-high tile, plus a quarter of a 64-row unit for the
    tile's setup and two cluster barriers). The quarter is the ratio of
    those per-round phases (~1.6 us) to one f32 slice unit (~6.8 us) that
    tools/sto_phase_times.py read on an H100; the epilogue, ~12 us a stage at
    any C there, does not enter."""
    tiles, units = -(-n // rows), n // SLICE
    return -(-tiles // min(resident, tiles)) * (4 * (-(-units // cluster) * rows // SLICE) + 1)


def _cluster_size(n: int, rows: int, max_clusters: Callable[[int], int]) -> Tuple[int, int]:
    """The cluster size C for a padded N and tiles of `rows` rows, and the
    co-resident clusters of that size: C minimises `split_cost`, ties to the
    smaller C (fewer partials to reduce). N alone decides, so a lane's sums
    never depend on E."""
    best = None
    for c in range(1, min(MAX_CLUSTER, n // SLICE) + 1):
        resident = max_clusters(c)
        if resident < 1:
            continue
        cost = split_cost(n, rows, c, resident)
        if best is None or cost < best[0]:
            best = (cost, c, resident)
    if best is None:
        raise RuntimeError("no cluster size fits the card")
    return best[1], best[2]


def _check_split_shape(name: str, n: int, e: int) -> None:
    if n % SLICE or e % TILE_E or n < SLICE or e < TILE_E:
        raise ValueError(f"{name}: N={n}, E={e} must be padded to ({SLICE}, {TILE_E})")


def coop_split(
    n: int, e: int, max_clusters: Callable[[int], int], rows: int = COOP_ROWS[torch.float32]
) -> CoopSplit:
    """The rk4_coop_kernel split for a padded (N, E) and tiles of `rows`
    rows, given the co-resident clusters of each size
    (cudaOccupancyMaxActiveClusters on the card): `_cluster_size` picks C
    from N; a cooperative launch holds only co-resident clusters, so the
    tiles (lane tiles add items) are taken in rounds."""
    _check_split_shape("coop_split", n, e)
    c, resident = _cluster_size(n, rows, max_clusters)
    col_tiles = -(-e // COOP_LANES)
    items = -(-n // rows) * col_tiles
    return CoopSplit(
        cluster=c, clusters=min(resident, items), rows=rows, col_tiles=col_tiles, items=items,
        resident=resident,
    )


def field_split(
    n: int, e: int, max_clusters: Callable[[int], int], rows: int = COOP_ROWS[torch.float32]
) -> CoopSplit:
    """The field_stage_kernel split: the cluster size of `_cluster_size`
    (from N alone, weighing waves as coop_split weighs rounds) and one
    cluster per output tile, in an ordinary launch whose tiles past the
    co-resident clusters run in waves. `coop_block_work` says what each
    block computes."""
    _check_split_shape("field_split", n, e)
    c, resident = _cluster_size(n, rows, max_clusters)
    col_tiles = -(-e // COOP_LANES)
    items = -(-n // rows) * col_tiles
    return CoopSplit(
        cluster=c, clusters=items, rows=rows, col_tiles=col_tiles, items=items, resident=resident
    )


@dataclasses.dataclass(frozen=True)
class CoopWork:
    """One output tile as one block sees it, every stage: it sums W[rows, k]
    x[k, lanes] over k in `k` into its partial tile, then reduces the rows
    `reduce_rows` x `lanes` over the cluster's partials and runs the epilogue
    there. Ranges are half-open."""

    rows: tuple
    lanes: tuple
    k: tuple
    reduce_rows: tuple


def coop_block_work(split: CoopSplit, n: int, e: int, block: int) -> Iterator[CoopWork]:
    """What block `block` of the launch computes each stage, in the formulas
    of rk4_coop_kernel and field_stage_kernel (csrc/sto_rk4.cu)."""
    c, rows = split.cluster, split.rows
    rank, cid = block % c, block // c
    units = n // SLICE
    k = (SLICE * (rank * units // c), SLICE * ((rank + 1) * units // c))
    red = (rank * rows // c, (rank + 1) * rows // c)
    for item in range(cid, split.items, split.clusters):
        r0 = (item // split.col_tiles) * rows
        c0 = (item % split.col_tiles) * COOP_LANES
        yield CoopWork(
            rows=(r0, min(r0 + rows, n)),
            lanes=(c0, min(c0 + COOP_LANES, e)),
            k=k,
            reduce_rows=(min(r0 + red[0], n), min(r0 + red[1], n)),  # rows past N are padding
        )


def _coop_resident(w_bf16: int, cluster: int) -> int:
    return _lib().sto_coop_max_clusters(w_bf16, cluster)


def _field_resident(w_bf16: int, cluster: int) -> int:
    return _lib().sto_field_max_clusters(w_bf16, cluster)


@functools.lru_cache(maxsize=None)
def _max_clusters(query, w_bf16: bool, device_index: int, cluster: int) -> int:
    """Co-resident clusters of `cluster` blocks on a card, from the library's
    occupancy `query` (_coop_resident or _field_resident)."""
    with torch.cuda.device(device_index):
        count = query(int(w_bf16), cluster)
    if count < 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed with cudaError {-count}")
    return count


def _device_index(device) -> int:
    index = torch.device(device).index
    return torch.cuda.current_device() if index is None else index


@functools.lru_cache(maxsize=None)
def _launch_config(split, query, n: int, e: int, w_dtype: torch.dtype, index: int) -> CoopSplit:
    bf16 = w_dtype == torch.bfloat16
    return split(n, e, lambda c: _max_clusters(query, bf16, index, c), COOP_ROWS[w_dtype])


def coop_launch_config(n: int, e: int, w_dtype: torch.dtype, device) -> CoopSplit:
    """The split rk4_chunk / rk4_fused launch with on `device` for a padded
    (N, E) and a W of `w_dtype`."""
    return _launch_config(coop_split, _coop_resident, n, e, w_dtype, _device_index(device))


def field_launch_config(n: int, e: int, w_dtype: torch.dtype, device) -> CoopSplit:
    """The split field_tiled / rk4_tiled_step launch with on `device`."""
    return _launch_config(field_split, _field_resident, n, e, w_dtype, _device_index(device))


def coop_smem_bytes(w_dtype: torch.dtype) -> int:
    """Dynamic shared memory of one rk4_coop_kernel block."""
    return _lib().sto_coop_smem(int(w_dtype == torch.bfloat16))


def field_smem_bytes(w_dtype: torch.dtype) -> int:
    """Dynamic shared memory of one field_stage_kernel block."""
    return _lib().sto_field_smem(int(w_dtype == torch.bfloat16))


def _coop_launch(name, m, w_cp, params, dt, steps, h, h_stride, mask, states):
    """One cooperative launch of the shared chunk/fused body; returns m'."""
    _, n, e = m.shape
    m_out = m.clone()  # the kernel advances it in place
    bf16 = w_cp.dtype == torch.bfloat16
    # f32 planes: stage x-plane x2 (a bf16 W: one f32 + two bf16), y/z, accumulator x3
    scratch = torch.empty((7, n, e), dtype=m.dtype, device=m.device)
    if _build.is_fake(m):
        evals = 4 * steps * (h.shape[0] if h_stride else 1)  # stages of the launch
        _fake_launch(name, (m, m_out, w_cp, params, h, mask, states), 2.0 * n * n * e * evals,
                     _gemm_kind(w_cp), EPILOGUE_FLOPS * n * e * evals)
        return m_out
    split = coop_launch_config(n, e, w_cp.dtype, m.device)
    dt = float(dt)
    lib = _lib()
    err = lib.sto_rk4_coop(
        int(bf16), _ptr(params), _ptr(w_cp), _ptr(h), h_stride,
        None if mask is None else _ptr(mask), _ptr(m_out),
        None if states is None else _ptr(states), _ptr(scratch),
        n, e, h.shape[0] if h_stride else 1, steps,
        dt / 2.0, dt, dt / 6.0, split.cluster, split.clusters, _stream(m.device),
    )
    _raise_on(err, name)
    _build.count_launch(name)
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


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    """x (f32, contiguous, on the card) rounded to bf16 by round_bf16_kernel."""
    out = torch.empty(x.shape, dtype=torch.bfloat16, device=x.device)
    if _build.is_fake(x):
        _fake_launch("round_bf16", (x, out), 0.0, "f32", x.numel())
        return out
    _raise_on(_lib().sto_round_bf16(_ptr(x), _ptr(out), x.numel(), _stream(x.device)), "round_bf16")
    _build.count_launch("round_bf16")
    return out


def _field_launch(
    m, x, w_cp, params, h_in, *, kprev=None, acc_in=None, k=None, x_next=None, acc_out=None,
    m_out=None, c=0.0, c_next=0.0, c_out=0.0,
):
    """One field_stage_kernel launch (csrc/sto_rk4.cu FieldArgs); x and x_next
    are in W's dtype, every other plane f32."""
    _, n, e = m.shape
    if _build.is_fake(m):
        _fake_launch("field_tiled", (m, x, w_cp, params, h_in, kprev, acc_in, k, x_next, acc_out,
                                     m_out), 2.0 * n * n * e, _gemm_kind(w_cp),
                     EPILOGUE_FLOPS * n * e)
        return
    split = field_launch_config(n, e, w_cp.dtype, m.device)
    opt = lambda t: None if t is None else _ptr(t)  # noqa: E731
    err = _lib().sto_field_stage(
        int(w_cp.dtype == torch.bfloat16), _ptr(params), _ptr(w_cp), _ptr(x), _ptr(h_in),
        _ptr(m), opt(kprev), opt(acc_in), opt(k), opt(x_next), opt(acc_out), opt(m_out),
        float(c), float(c_next), float(c_out), n, e, split.cluster, _stream(m.device),
    )
    _raise_on(err, "field_tiled")
    _build.count_launch("field_tiled")


def _check_field(name, m, w_cp, params, h_in, block_n, block_e, **planes):
    _, n, e = m.shape
    _check_cuda(name, m=m, w_cp=w_cp, params=params, h_in=h_in, **planes)
    _check_tiles(name, n, e, block_n, block_e)
    if (
        w_cp.shape != (n, n)
        or params.shape != (NP, e)
        or h_in.shape != (n, e)
        or any(t.shape[-2:] != (n, e) or t.dim() != (2 if key == "yx_full" else 3)
               for key, t in planes.items())
    ):
        raise ValueError(f"{name}: operand shapes do not match m (3, N, E)")


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
    """One LLG slope k = f(m + stage_coef * k_prev) per (row, lane). For a
    bf16 W the x-plane is first rounded to bf16 by a second, elementwise
    kernel (round_bf16_kernel), which the product then reads."""
    _, n, e = m.shape
    if h_in is None:
        h_in = torch.zeros((n, e), dtype=m.dtype, device=m.device)
    if _on_cpu(m):
        return field_tiled_plain(m, yx_full, k_prev, w_cp, params, stage_coef, h_in)
    _check_field(
        "field_tiled", m, w_cp, params, h_in, block_n, block_e, yx_full=yx_full, k_prev=k_prev
    )
    x = _round_bf16(yx_full) if w_cp.dtype == torch.bfloat16 else yx_full
    out = torch.empty_like(m)
    _field_launch(
        m, x, w_cp, params, h_in, kprev=None if stage_coef == 0.0 else k_prev, k=out,
        c=stage_coef,
    )
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
# Kernel 4: the time-multiplexed delay line (csrc/sto_delay_line.cu)
# ---------------------------------------------------------------------------


def tm_coefficients(dt: float) -> Tuple[float, float, float]:
    """dt, dt / 2 and dt / 6 rounded to f32 as `kref.tm_delay_line_plain`
    rounds them (on the host, from a 0-d f32 tensor), for the kernel."""
    dt_c = torch.full((), float(dt), dtype=torch.float32)
    return float(dt_c), float(0.5 * dt_c), float(dt_c / 6.0)


def tm_delay_line(
    m: torch.Tensor,  # (3, N, E) the previous tick's snapshots; row N-1 carries the oscillator
    h_t: torch.Tensor,  # (N, E) node drives (kref.tm_feedback)
    params: torch.Tensor,  # (NP, E)
    dt: float,
    hold_steps: int,
    mask: torch.Tensor = None,  # (E,) f32 0/1; None = every lane live
) -> torch.Tensor:
    """One tick's delay line for every lane: the oscillator m[:, N-1, e]
    runs hold_steps RK4 steps under each node's drive in turn, snapshot j
    after node j. A lane masked 0 comes back bit-identical. Returns
    m' (3, N, E)."""
    _, n, e = m.shape
    if _on_cpu(m):
        snaps = kref.tm_delay_line_plain(m[:, n - 1], h_t, params, dt, hold_steps)
        return snaps if mask is None else torch.where(mask[None, None, :] > 0.5, snaps, m)
    planes = dict(h_t=h_t, params=params) if mask is None else dict(h_t=h_t, params=params, mask=mask)
    _check_cuda("tm_delay_line", m=m, **planes)
    if h_t.shape != (n, e) or params.shape != (NP, e) or (mask is not None and mask.shape != (e,)):
        raise ValueError("tm_delay_line: h_t (N, E), params (NP, E), mask (E,) expected")
    out = torch.empty_like(m)
    if _build.is_fake(m):
        _fake_launch("tm_delay_line", (m, h_t, params, mask, out), 0.0, "f32",
                     STEP_OPS * n * hold_steps * e)
        return out
    dt32, half, sixth = tm_coefficients(dt)
    err = _lib().sto_tm_delay_line(
        _ptr(m), _ptr(h_t), _ptr(params), None if mask is None else _ptr(mask), _ptr(out),
        n, e, int(hold_steps), dt32, half, sixth, _stream(m.device),
    )
    _raise_on(err, "tm_delay_line")
    _build.count_launch("tm_delay_line")
    return out


def tm_chunk(
    m: torch.Tensor,  # (3, N, E)
    w_cp: torch.Tensor,  # (N, N) feedback mixing, pre-cast for reduced precision
    params: torch.Tensor,  # (NP, E)
    dt: float,
    hold_steps: int,
    h_block: torch.Tensor,  # (K, N, E) masked-input fields
    mask_block: torch.Tensor,  # (K, E) bool
):
    """K time-multiplexed ticks: per tick the feedback product
    (`kref.tm_feedback`, torch.matmul under the precision policy, as the
    reference leaves it to jnp.dot) and one `tm_delay_line` launch. On the
    CPU, `kref.tm_chunk_planes`. Returns (m' (3, N, E), states (K, N, E))."""
    if _on_cpu(m):
        return kref.tm_chunk_planes(m, w_cp, params, dt, hold_steps, h_block, mask_block)
    masks = mask_block.to(m.dtype)
    states = []
    for t in range(h_block.shape[0]):
        h_t = kref.tm_feedback(h_block[t], w_cp, m[0], params)
        m = tm_delay_line(m, h_t, params, dt, hold_steps, masks[t])
        states.append(m[0])
    return m, torch.stack(states)


# ---------------------------------------------------------------------------
# One RK4 step from four field_stage_kernel launches
# ---------------------------------------------------------------------------

STAGES = 4


def _stage_coefs(dt: float):
    """Stage coefficients c_1..c_4 (c_1 = 0: y = m) and the final dt / 6."""
    return (0.0, 0.5 * dt, 0.5 * dt, dt), dt / 6.0


def rk4_tiled_stage_plain(stage, m, yx, k_prev, acc, w_cp, params, dt, h_in):
    """Stage `stage` (1..4) of the tiled RK4 step, as the kernel's epilogue
    computes it. k = f(m + c_stage k_prev) against the stage x-plane yx
    (`field_tiled_plain`); stages 1-3 return (k, the next stage's x-plane
    m^x + c_next k^x, the running sum), stage 4 returns m + (dt/6)(acc + k).
    The sum is the reference's k1 + 2 k2 + 2 k3 + k4, left to right: k1
    (stage 1 returns k itself), acc + 2 k (stage 2 starts from k_prev = k1)."""
    dt = float(dt)
    coefs, sixth = _stage_coefs(dt)
    k = field_tiled_plain(m, yx, k_prev, w_cp, params, coefs[stage - 1], h_in)
    if stage == STAGES:
        return m + sixth * (acc + k)
    acc_out = k if stage == 1 else (k_prev if stage == 2 else acc) + 2.0 * k
    return k, m[0] + coefs[stage] * k[0], acc_out


def rk4_tiled_step_plain(m, w_cp, params, dt, h_in=None):
    """`rk4_tiled_step` through the plain stages (any device)."""
    if h_in is None:
        h_in = torch.zeros(m.shape[1:], dtype=m.dtype, device=m.device)
    yx, k, acc = m[0], None, None
    for stage in range(1, STAGES):
        k, yx, acc = rk4_tiled_stage_plain(stage, m, yx, k, acc, w_cp, params, dt, h_in)
    return rk4_tiled_stage_plain(STAGES, m, yx, k, acc, w_cp, params, dt, h_in)


def rk4_tiled_step(
    m: torch.Tensor,
    w_cp: torch.Tensor,
    params: torch.Tensor,
    dt: float,
    block_n: int = TILE_N,
    block_e: int = TILE_E,
    h_in: torch.Tensor = None,
) -> torch.Tensor:
    """One RK4 step: four field_stage_kernel launches (`field_tiled` with
    the stage algebra in the epilogue), no elementwise torch op between
    them; for a bf16 W, round_bf16_kernel first rounds m^x to bf16. Each
    launch reads the x-plane the one before wrote (double-buffered)."""
    _, n, e = m.shape
    if h_in is None:
        h_in = torch.zeros((n, e), dtype=m.dtype, device=m.device)
    if _on_cpu(m):
        return rk4_tiled_step_plain(m, w_cp, params, dt, h_in)
    _check_field("rk4_tiled_step", m, w_cp, params, h_in, block_n, block_e)
    coefs, sixth = _stage_coefs(float(dt))
    ka, kb, acc, out = (torch.empty_like(m) for _ in range(4))
    x1, x2 = torch.empty((2, n, e), dtype=w_cp.dtype, device=m.device)
    x0 = _round_bf16(m[0]) if w_cp.dtype == torch.bfloat16 else m[0]
    launch = functools.partial(_field_launch, m, w_cp=w_cp, params=params, h_in=h_in)
    launch(x0, k=ka, x_next=x1, c_next=coefs[1])
    launch(x1, kprev=ka, k=kb, x_next=x2, acc_out=acc, c=coefs[1], c_next=coefs[2])
    launch(x2, kprev=kb, acc_in=acc, k=ka, x_next=x1, acc_out=acc, c=coefs[2], c_next=coefs[3])
    launch(x1, kprev=ka, acc_in=acc, m_out=out, c=coefs[3], c_out=sixth)
    return out
