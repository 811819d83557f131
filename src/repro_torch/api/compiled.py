"""compile_plan(SimSpec, ExecPlan) -> CompiledSim: the one execution surface.

All impl dispatch, padding and ensemble batching decisions are made HERE,
once, at plan compilation: "auto" impls resolve through
`kernels.ops.choose_impl` (in-process measured-latency table, then the
platform gate / L2 heuristic); `ExecPlan(measure=True)` times the
candidates for this (N, E) first and pins the winner.

Entry points on the returned CompiledSim (the reference's names):

  drive(u, m0=None)            solo reservoir over an input series
  drive_batch(U, m0=None)      E lanes over shared or per-lane series
  integrate(n_steps, ...)      free-run (u = 0) ensemble integration
  tick(m, u, lane_mask=None)   ONE hold window for a slot batch
  tick_chunk(m, U, ...)        K hold windows in one call — the chunked
                               serving hot path (inference only here)

PyTorch runs eagerly, so there is nothing to compile: `compile_plan` binds
the spec to a device and resolves the impl, and the workers below are plain
functions over the planes layout (3, N, E). The CUDA kernels build at their
first launch (`CompiledSim.warmup` forces it).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core.constants import STOParams
from repro_torch.core.ensemble import broadcast_params
from repro_torch.core.reservoir import coerce_input_series
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels import ref as kref

from repro_torch.api.plan import ExecPlan
from repro_torch.api.spec import SimSpec, validate_topology

KERNEL_IMPLS = ("fused", "tiled", "chunk")


# ---------------------------------------------------------------------------
# workers — kernel (3, N, E) planes layout ("ref"/"fused"/"tiled"/"chunk")
# ---------------------------------------------------------------------------


def _input_field(w_in, u, a_in, precision):
    """h_in = A_in * (W^in u) per lane, honoring the precision policy.

    u may be a single tick (E, N_in) or a chunk block (K, E, N_in).
    """
    eq = "ni,ei->ne" if u.ndim == 2 else "ni,kei->kne"
    scale = a_in[None, :] if u.ndim == 2 else a_in[None, None, :]
    return ops.input_field_einsum(eq, w_in, u, precision) * scale


def _lane_terms(params_e, e, m_planes):
    """Packed (NP, E) params and the (E,) input gains A_in."""
    pv = kref.pack_params(params_e, e, m_planes.dtype)
    a_in = params_e.a_in.reshape(-1).to(m_planes.dtype).expand(e)
    return pv, a_in


def _drive_planes(
    params_e, w_cp, w_in, m0_planes, u_seq_e,
    *, dt, hold_steps, impl, n_inner, block_n, block_e, interpret,
    precision="highest",
):
    """Ensemble drive through the kernel layout: per input sample, one
    hold-window integrate with the resolved impl."""
    e = m0_planes.shape[-1]
    pv, a_in = _lane_terms(params_e, e, m0_planes)
    m, states = m0_planes, []
    for u_t in u_seq_e:  # (E, N_in)
        h = _input_field(w_in, u_t, a_in, precision)
        m = ops._integrate_planes(
            m, w_cp, pv, h, None,
            dt=dt, n_steps=hold_steps, impl=impl, n_inner=n_inner,
            block_n=block_n, block_e=block_e, interpret=interpret,
            precision=precision,
        )
        states.append(m[0])
    return m, torch.stack(states).transpose(1, 2)  # (3, N, E), (T, E, N)


def _tick_planes(
    params_e, w_cp, w_in, m_planes, u, mask,
    *, dt, hold_steps, impl, n_inner, block_n, block_e, interpret,
    precision="highest",
):
    """One hold window for a slot batch in the kernel layout; masked lanes
    come back bit-identical (partial-batch masking in kernels/ops.py)."""
    e = m_planes.shape[-1]
    pv, a_in = _lane_terms(params_e, e, m_planes)
    h = _input_field(w_in, u, a_in, precision)
    m_new = ops._integrate_planes(
        m_planes, w_cp, pv, h, mask,
        dt=dt, n_steps=hold_steps, impl=impl, n_inner=n_inner,
        block_n=block_n, block_e=block_e, interpret=interpret,
        precision=precision,
    )
    return m_new, m_new[0]


def _tick_chunk_planes(
    params_e, w_cp, w_in, m_planes, u_block, mask_block,
    *, dt, hold_steps, impl, n_inner, block_n, block_e, interpret,
    precision="highest",
):
    """K serving ticks in the kernel layout.

    impl="chunk" computes the whole (K, N, E) input-field block with ONE GEMM
    and runs the K x hold_steps x 4-stage loop in one launch; the per-window
    impls run `_tick_planes`' body per tick. Returns ((3, N, E), (K, N, E)).
    """
    e = m_planes.shape[-1]
    pv, a_in = _lane_terms(params_e, e, m_planes)
    if impl == "chunk":
        h_block = _input_field(w_in, u_block, a_in, precision)  # (K, N, E)
        return ops._tick_chunk_planes(
            m_planes, w_cp, pv, h_block, mask_block,
            dt=dt, hold_steps=hold_steps, impl=impl, n_inner=n_inner,
            block_n=block_n, block_e=block_e, interpret=interpret,
            precision=precision,
        )
    m, states = m_planes, []
    for u_t, mask_t in zip(u_block, mask_block):
        h = _input_field(w_in, u_t, a_in, precision)
        m = ops._integrate_planes(
            m, w_cp, pv, h, mask_t,
            dt=dt, n_steps=hold_steps, impl=impl, n_inner=n_inner,
            block_n=block_n, block_e=block_e, interpret=interpret,
            precision=precision,
        )
        states.append(m[0])
    return m, torch.stack(states)  # (3, N, E), (K, N, E)


def _integrate_planes(
    params_e, w_cp, m0_planes,
    *, dt, n_steps, save_every, impl, n_inner, block_n, block_e, interpret,
    precision="highest",
):
    """Free-run (u = 0) integration in the kernel layout."""
    e = m0_planes.shape[-1]
    pv = kref.pack_params(params_e, e, m0_planes.dtype)

    def chunk(m, length):
        return ops._integrate_planes(
            m, w_cp, pv, None, None,
            dt=dt, n_steps=length, impl=impl, n_inner=n_inner,
            block_n=block_n, block_e=block_e, interpret=interpret,
            precision=precision,
        )

    if not save_every:
        return chunk(m0_planes, n_steps), None
    m, traj = m0_planes, []
    for _ in range(n_steps // save_every):
        m = chunk(m, save_every)
        traj.append(m)
    return m, torch.stack(traj)


# ---------------------------------------------------------------------------
# CompiledSim
# ---------------------------------------------------------------------------


class CompiledSim:
    """A SimSpec bound to a device and resolved execution decisions. Build
    via compile_plan."""

    def __init__(self, spec: SimSpec, plan: ExecPlan, impl: str):
        self.spec = spec
        self.plan = plan
        self.impl = impl  # resolved: ref | fused | tiled | chunk
        self.e = plan.ensemble
        self.device = spec.device
        self.topology = spec.topology
        self._block_n = plan.block_n or ops.BLOCK_N
        self._block_e = plan.block_e or ops.BLOCK_E
        self._n_inner = plan.n_inner or spec.hold_steps
        self.precision = ops.normalize_precision(plan.precision)
        self._params_cache: Optional[STOParams] = None

    # -- parameter plumbing ------------------------------------------------

    def ensemble_params(self, params: Optional[STOParams] = None) -> STOParams:
        """Per-lane STOParams with (E, 1) leaves (0-d specs broadcast)."""
        if params is None:
            if self._params_cache is None:
                self._params_cache = self._broadcast(self.spec.params)
            return self._params_cache
        return self._broadcast(params)

    def _broadcast(self, p: STOParams) -> STOParams:
        p = p.to(self.device, self.spec.dtype)
        if p.gamma.ndim == 2 and tuple(p.gamma.shape) == (self.e, 1):
            return p
        return broadcast_params(p, self.e)

    def _planes_kw(self) -> dict:
        return dict(
            dt=float(self.spec.dt), hold_steps=self.spec.hold_steps, impl=self.impl,
            n_inner=self._n_inner, block_n=self._block_n, block_e=self._block_e,
            interpret=self.plan.interpret, precision=self.precision,
        )

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=self.spec.dtype).to(self.device, non_blocking=True)

    def _coerce_batch_u(self, u) -> torch.Tensor:
        """(T, N_in) shared or (T, E, N_in) per lane -> (T, E, N_in)."""
        spec = self.spec
        u = self._tensor(u)
        if u.ndim == 2 and u.shape[1] == spec.n_in:
            return u[:, None, :].expand(u.shape[0], self.e, spec.n_in)
        if u.ndim == 3 and tuple(u.shape[1:]) == (self.e, spec.n_in):
            return u
        raise ValueError(
            f"batch input series must have shape (T, {spec.n_in}) — shared "
            f"across lanes — or (T, {self.e}, {spec.n_in}) per lane; got "
            f"{tuple(u.shape)}"
        )

    def _coerce_batch_m0(self, m0) -> torch.Tensor:
        spec = self.spec
        if m0 is None:
            return spec.m0.expand(self.e, spec.n, 3)
        m0 = self._tensor(m0)
        if tuple(m0.shape) == (spec.n, 3):
            return m0.expand(self.e, spec.n, 3)
        if tuple(m0.shape) != (self.e, spec.n, 3):
            raise ValueError(
                f"m0 must have shape ({spec.n}, 3) or ({self.e}, {spec.n}, 3); "
                f"got {tuple(m0.shape)}"
            )
        return m0

    def _coerce_tick_mask(self, lane_mask, k: int) -> torch.Tensor:
        """(E,) or (K, E) bool -> (K, E) mask block (None = all active)."""
        if lane_mask is None:
            return torch.ones((k, self.e), dtype=torch.bool, device=self.device)
        lane_mask = torch.as_tensor(lane_mask, dtype=torch.bool).to(self.device, non_blocking=True)
        if tuple(lane_mask.shape) == (self.e,):
            return lane_mask[None, :].expand(k, self.e)
        if tuple(lane_mask.shape) == (k, self.e):
            return lane_mask
        raise ValueError(
            f"lane_mask must have shape ({k}, {self.e}) or ({self.e},); "
            f"got {tuple(lane_mask.shape)}"
        )

    # -- entry points ------------------------------------------------------

    def drive(self, u_seq, m0=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Solo drive: input series (T, N_in) -> (final m (N, 3), states (T, N)).

        Requires ensemble == 1."""
        spec = self.spec
        if self.e != 1:
            raise ValueError(
                "drive() is the solo entry point (ensemble == 1); use "
                "drive_batch() for ensemble plans"
            )
        u_seq = coerce_input_series(u_seq, spec.n_in, spec.dtype).to(self.device)
        m_start = spec.m0 if m0 is None else self._tensor(m0)
        if m_start.shape != spec.m0.shape:
            raise ValueError(
                f"m0 must have shape {tuple(spec.m0.shape)}; got {tuple(m_start.shape)}"
            )
        mT, states = _drive_planes(
            self.ensemble_params(), spec.w_cp, spec.w_in,
            ops.to_planes(m_start), u_seq[:, None, :], **self._planes_kw(),
        )
        return ops.from_planes(mT, ()), states[:, 0, :]

    def drive_batch(
        self, u_seq, m0=None, params: Optional[STOParams] = None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Ensemble drive: E lanes, shared (T, N_in) or per-lane
        (T, E, N_in) input -> (mT (E, N, 3), states (T, E, N))."""
        spec = self.spec
        m0_e = self._coerce_batch_m0(m0)
        params_e = self.ensemble_params(params)
        u_e = self._coerce_batch_u(u_seq)
        mT, states = _drive_planes(
            params_e, spec.w_cp, spec.w_in, ops.to_planes(m0_e), u_e, **self._planes_kw()
        )
        return ops.from_planes(mT, (self.e,)), states

    def integrate(
        self, n_steps: int, m0=None, save_every: int = 0, params: Optional[STOParams] = None
    ):
        """Free-run (u = 0) integration of the E-lane ensemble.

        Returns (mT (E, N, 3), traj or None) — traj has shape
        (n_steps // save_every, E, N, 3) when save_every > 0.
        """
        m0_e = self._coerce_batch_m0(m0)
        params_e = self.ensemble_params(params)
        if save_every and n_steps % save_every:
            raise ValueError(f"n_steps ({n_steps}) must be a multiple of save_every ({save_every})")
        kw = self._planes_kw()
        del kw["hold_steps"]
        mT, traj = _integrate_planes(
            params_e, self.spec.w_cp, ops.to_planes(m0_e),
            n_steps=n_steps, save_every=save_every, **kw,
        )
        mT = ops.from_planes(mT, (self.e,))
        if traj is not None:
            traj = torch.stack([ops.from_planes(mp, (self.e,)) for mp in traj])
        return mT, traj

    def tick(
        self,
        m_planes: torch.Tensor,  # (3, N, E) slot-store layout
        u,  # (E, N_in) this tick's input row per lane
        lane_mask=None,  # (E,) bool; None = all active
        params: Optional[STOParams] = None,  # per-lane STOParams, (E, 1) leaves
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """ONE hold window for a slot batch. Returns (m_planes' (3, N, E),
        states plane (N, E)); lanes where lane_mask is False come back
        bit-identical."""
        spec = self.spec
        mask = self._coerce_tick_mask(lane_mask, 1)[0]
        return _tick_planes(
            self.ensemble_params(params), spec.w_cp, spec.w_in, m_planes,
            self._tensor(u), mask, **self._planes_kw(),
        )

    def tick_chunk(
        self,
        m_planes: torch.Tensor,  # (3, N, E) slot-store layout
        u_block,  # (K, E, N_in) input rows for K ticks
        lane_mask=None,  # (K, E) or (E,) bool
        params: Optional[STOParams] = None,  # per-lane STOParams, (E, 1) leaves
        targets=None,
        learn_state=None,
        learn_mask=None,
    ):
        """K serving ticks (K hold windows) for a slot batch in one call.

        Returns (m_planes' (3, N, E), states (K, N, E)). lane_mask may be per
        tick (K, E) — a lane masked False for rows [0, k) and True after
        integrates exactly as if admitted at tick k (frozen lanes are
        bit-identical) — or a single (E,) row applied to every tick. Online
        learning (targets / learn_state / learn_mask) is not ported yet.
        """
        if targets is not None or learn_state is not None or learn_mask is not None:
            raise ValueError(
                "targets/learn_state/learn_mask require a learning plan; "
                "this plan is inference-only (online learning is ROADMAP "
                "queue 1 item 6)"
            )
        spec = self.spec
        u_block = self._tensor(u_block)
        if u_block.ndim != 3 or tuple(u_block.shape[1:]) != (self.e, spec.n_in):
            raise ValueError(
                f"u_block must have shape (K, {self.e}, {spec.n_in}); "
                f"got {tuple(u_block.shape)}"
            )
        mask_block = self._coerce_tick_mask(lane_mask, u_block.shape[0])
        return _tick_chunk_planes(
            self.ensemble_params(params), spec.w_cp, spec.w_in, m_planes,
            u_block, mask_block, **self._planes_kw(),
        )

    def warmup(self, n_out: int = 1) -> "CompiledSim":
        """Run ONE all-lanes-masked zero chunk (state-neutral by
        construction), which builds the CUDA kernels of this plan's impl."""
        spec = self.spec
        k = self.plan.chunk_ticks
        m = ops.to_planes(spec.m0.expand(self.e, spec.n, 3)).contiguous()
        u = torch.zeros((k, self.e, spec.n_in), dtype=spec.dtype, device=self.device)
        mask = torch.zeros((k, self.e), dtype=torch.bool, device=self.device)
        self.tick_chunk(m, u, lane_mask=mask)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self


# ---------------------------------------------------------------------------
# compile_plan
# ---------------------------------------------------------------------------


def compile_plan(
    spec: SimSpec, plan: Optional[ExecPlan] = None, device="cuda", **overrides
) -> CompiledSim:
    """Bind a SimSpec to a device and an ExecPlan, resolving every execution
    decision.

    Keyword overrides build/amend the plan: `compile_plan(spec, ensemble=64)`
    == `compile_plan(spec, ExecPlan(ensemble=64))`. The spec's tensors move
    to `device` ("cuda" by default; raises without a card unless the caller
    passes device="cpu").
    """
    if plan is None:
        plan = ExecPlan(**overrides)
    elif overrides:
        plan = dataclasses.replace(plan, **overrides)
    dev = resolve_device(device)
    if spec.device != dev:
        spec = spec.to(dev)
    if spec.tableau != "rk4":
        raise NotImplementedError(
            f"tableau {spec.tableau!r} is not ported yet (ROADMAP queue 1 item 2, "
            "core/integrators.py); this slice integrates classical RK4"
        )
    validate_topology(spec)

    leaf = spec.params.gamma
    if leaf.ndim == 2 and tuple(leaf.shape) != (plan.ensemble, 1):
        raise ValueError(
            f"spec.params carries ensemble leaves of shape {tuple(leaf.shape)} "
            f"but the plan runs ensemble={plan.ensemble}; rebuild the sweep "
            f"with broadcast_params(base, {plan.ensemble}) or set "
            f"ExecPlan(ensemble={int(leaf.shape[0])})"
        )
    if leaf.ndim not in (0, 2):
        raise ValueError(
            f"spec.params leaves must be 0-d or (E, 1) ensemble leaves "
            f"(broadcast_params); got shape {tuple(leaf.shape)}"
        )

    impl = plan.impl
    if impl == "scan":
        raise NotImplementedError(
            "impl='scan' (the core-layout oracle) is not ported yet (ROADMAP "
            "queue 1 item 5); use impl='ref' for the plain PyTorch version"
        )
    itemsize = torch.empty((), dtype=spec.dtype).element_size()
    if impl == "auto":
        if plan.measure:
            ops.measure_impl_latency(
                spec.n, plan.ensemble, dt=float(spec.dt), dtype=spec.dtype,
                precision=plan.effective_precision,
                chunk_ticks=plan.chunk_ticks, device=dev,
            )
        impl = ops.choose_impl(
            spec.n, plan.ensemble, itemsize, platform=dev.type,
            precision=plan.effective_precision,
        )
    if (
        impl in KERNEL_IMPLS
        and dev.type == "cuda"
        and not plan.interpret
        and spec.dtype != torch.float32
    ):
        raise NotImplementedError(
            f"the CUDA kernels take an f32 state; a {spec.dtype} state on CUDA "
            "is not supported yet (ROADMAP queue 1 item 4, f64 kernels) — use "
            "impl='ref' or an f32 spec"
        )
    return CompiledSim(spec, plan, impl)
