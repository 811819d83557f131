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
                               serving hot path; with ExecPlan(learn=...)
                               it also trains per-lane readouts online
                               (targets/learn_state/learn_mask)

PyTorch runs eagerly, so there is nothing to compile: `compile_plan` binds
the spec to a device and resolves the impl, and the workers below are plain
functions. impl="scan" is the exact oracle: the core (E, N, 3) layout, any
tableau, one torch op after another (on the card too). The planes impls
("ref"/"fused"/"tiled"/"chunk") run the (3, N, E) layout and classical RK4
only; their CUDA kernels build at their first launch (`CompiledSim.warmup`
forces it, `CompiledSim.aot_compile` does it without a launch). The learn
tails (kernels/rls.py) are torch code on the same device and stream as the
integrate.

Physics families (SimSpec.topology != "coupled_array") run through one
chunk worker per layout (`_tick_chunk_scan_family`,
`_tick_chunk_planes_family`): every entry point of a family plan is a
chunk of that worker, so serving's per-tick and chunked paths agree by
construction.
Sharded plans (ExecPlan(mesh=...)) run every coupled-array entry point
through `api.sharded`'s bodies: the scan step in the core layout on each
rank's block, SPMD over torch.distributed, global tensors in and out.

time_multiplexed under "chunk" on the card is K x (the feedback product,
one `sto_step.tm_delay_line` launch); under "ref" (and "chunk" on the CPU or
with interpret=True) the plain body `kernels.ref.tm_chunk_planes`.
array_transient under "ref" and "chunk" is one plain body
(`kernels.ref.rk4_chunk_planes_window`, so ref == chunk bit for bit), and
under "fused" / "tiled" splits each hold window through their kernels.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core import integrators, sto
from repro_torch.core.constants import STOParams
from repro_torch.core.ensemble import broadcast_params
from repro_torch.core.reservoir import coerce_input_series
from repro_torch.device import require_full_f32_matmul, resolve_device
from repro_torch.distributed.sharding import axis_size
from repro_torch.kernels import _build, ops, sto_step
from repro_torch.kernels import ref as kref
from repro_torch.kernels import rls as krls

from repro_torch.api import sharded as _sharded
from repro_torch.api.plan import ExecPlan, check_plan_supports_topology
from repro_torch.api.spec import SimSpec, validate_topology

PLANES_IMPLS = ("ref", "fused", "tiled", "chunk")
KERNEL_IMPLS = ("fused", "tiled", "chunk")


# ---------------------------------------------------------------------------
# workers — core (E, N, 3) layout ("scan" impl, the exact oracle)
# ---------------------------------------------------------------------------


def _scan_step(params, w_cp, tableau_name):
    """The tableau's step over the LLG field with an input x-field arg."""

    def field(m, h_in_x):
        return sto.llg_field(m, params, w_cp, h_in_x)

    return integrators.make_step(field, integrators.TABLEAUX[tableau_name])


def _hold(step, m, dt, h_in, hold_steps):
    """One hold window: hold_steps steps under a constant input field."""
    for _ in range(hold_steps):
        m = step(m, dt, h_in)
    return m


def _scan_input_field(params_e, w_in, u):
    """h_in = A_in (W^in u) per lane: u (E, N_in) -> (E, N), full f32."""
    if w_in.is_cuda:
        require_full_f32_matmul()
    return params_e.a_in * torch.einsum("ni,ei->en", w_in, u)


def _drive_scan(params, w_cp, w_in, m0, u_seq, dt, hold_steps, tableau_name="rk4"):
    """Solo drive (scalar params): m0 (N, 3), u_seq (T, N_in) ->
    (mT (N, 3), states (T, N)), the node states being x-components."""
    step = _scan_step(params, w_cp, tableau_name)
    dt = integrators.dt_tensor(dt, m0)
    if w_in.is_cuda:
        require_full_f32_matmul()
    m, states = m0, []
    for u_t in u_seq:
        # input held piecewise-constant over the hold window
        m = _hold(step, m, dt, params.a_in * (w_in @ u_t), hold_steps)
        states.append(m[..., 0])
    return m, torch.stack(states)


def _drive_scan_batch(params_e, w_cp, w_in, m0_e, u_seq_e, dt, hold_steps, tableau_name="rk4"):
    """Ensemble drive in the core layout (per-lane params and inputs):
    m0_e (E, N, 3), u_seq_e (T, E, N_in) -> ((E, N, 3), (T, E, N))."""
    step = _scan_step(params_e, w_cp, tableau_name)
    dt = integrators.dt_tensor(dt, m0_e)
    m, states = m0_e, []
    for u_t in u_seq_e:
        m = _hold(step, m, dt, _scan_input_field(params_e, w_in, u_t), hold_steps)
        states.append(m[..., 0])
    return m, torch.stack(states)


def _tick_chunk_scan(params_e, w_cp, w_in, m_planes, u_block, mask_block, dt,
                     hold_steps, tableau_name="rk4"):
    """K input ticks for all E slots in the core layout: u_block (K, E, N_in),
    mask_block (K, E). Takes and returns the slot store's (3, N, E) planes;
    the layout shuffle is hoisted out of the K loop (pure data movement), so
    a K-chunk is bit-identical to K one-tick calls (`_tick_scan`). The
    per-lane math is `_drive_scan_batch`'s; masked (idle) lanes come back
    bit-identical. Returns ((3, N, E), states (K, N, E))."""
    m = m_planes.permute(2, 1, 0).contiguous()  # (E, N, 3)
    step = _scan_step(params_e, w_cp, tableau_name)
    states = []
    for u_t, mask_t in zip(u_block, mask_block):
        m_new = _hold(step, m, dt, _scan_input_field(params_e, w_in, u_t), hold_steps)
        m = torch.where(mask_t[:, None, None], m_new, m)
        states.append(m[..., 0].T)
    return m.permute(2, 1, 0).contiguous(), torch.stack(states)


def _tick_scan(params_e, w_cp, w_in, m_planes, u, mask, dt, hold_steps, tableau_name="rk4"):
    """ONE input tick for all E slots: the one-tick chunk. Returns
    (m_planes' (3, N, E), states (N, E))."""
    m, states = _tick_chunk_scan(
        params_e, w_cp, w_in, m_planes, u[None], mask[None], dt, hold_steps, tableau_name
    )
    return m, states[0]


# ---------------------------------------------------------------------------
# learn tails — the chunk's (K, N, E) states block -> readout update
# ---------------------------------------------------------------------------


def _features(states):
    """(K, N, E) states -> (K, E, S) feature rows: node states + bias."""
    k, _, e = states.shape
    ones = torch.ones((k, e, 1), dtype=states.dtype, device=states.device)
    return torch.cat([states.permute(0, 2, 1), ones], dim=-1)


def _learn_chunk_tail(states, y_block, lmask_block, p0, w0, lam):
    """The chunked RLS update (`kernels.rls.rls_chunk`) over the chunk's
    features. Returns (P', W', preds (K, E, n_out))."""
    return krls.rls_chunk(p0, w0, _features(states), y_block, lmask_block, lam)


def _lms_chunk_tail(states, y_block, lmask_block, w0, mu):
    """The chunked NLMS update (`kernels.rls.lms_chunk`); no P block.
    Returns (W', preds (K, E, n_out))."""
    return krls.lms_chunk(w0, _features(states), y_block, lmask_block, mu)


def _tick_chunk_scan_rls(params_e, w_cp, w_in, m_planes, u_block, mask_block,
                         y_block, lmask_block, p0, w0, lam, dt, hold_steps,
                         tableau_name="rk4"):
    """`_tick_chunk_scan` + the RLS tail. The integration is the
    inference-only chunk's, bit for bit. lmask_block (K, E) gates which lanes
    learn which ticks. Returns (m', states, P', W', preds)."""
    mT, states = _tick_chunk_scan(
        params_e, w_cp, w_in, m_planes, u_block, mask_block, dt, hold_steps, tableau_name
    )
    return (mT, states, *_learn_chunk_tail(states, y_block, lmask_block, p0, w0, lam))


def _tick_chunk_scan_lms(params_e, w_cp, w_in, m_planes, u_block, mask_block,
                         y_block, lmask_block, w0, mu, dt, hold_steps,
                         tableau_name="rk4"):
    """`_tick_chunk_scan` + the NLMS tail. Returns (m', states, W', preds)."""
    mT, states = _tick_chunk_scan(
        params_e, w_cp, w_in, m_planes, u_block, mask_block, dt, hold_steps, tableau_name
    )
    return (mT, states, *_lms_chunk_tail(states, y_block, lmask_block, w0, mu))


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


def _tick_chunk_planes_rls(
    params_e, w_cp, w_in, m_planes, u_block, mask_block, y_block, lmask_block,
    p0, w0, *, lam, **planes_kw,
):
    """`_tick_chunk_planes` + the RLS tail: the integrate is the impl's
    kernel, the tail the torch `rls_chunk` on the same device and stream. The
    learn recursion runs in the state dtype whatever the precision policy.
    Returns (m', states, P', W', preds)."""
    mT, states = _tick_chunk_planes(
        params_e, w_cp, w_in, m_planes, u_block, mask_block, **planes_kw
    )
    return (mT, states, *_learn_chunk_tail(states, y_block, lmask_block, p0, w0, lam))


def _tick_chunk_planes_lms(
    params_e, w_cp, w_in, m_planes, u_block, mask_block, y_block, lmask_block,
    w0, *, mu, **planes_kw,
):
    """`_tick_chunk_planes` + the NLMS tail. Returns (m', states, W', preds)."""
    mT, states = _tick_chunk_planes(
        params_e, w_cp, w_in, m_planes, u_block, mask_block, **planes_kw
    )
    return (mT, states, *_lms_chunk_tail(states, y_block, lmask_block, w0, mu))


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
# workers — physics families (SimSpec.topology != "coupled_array")
# ---------------------------------------------------------------------------


def _tick_chunk_scan_family(
    params_e, w_cp, w_in, m_planes, u_block, mask_block, dt,
    *, topology, readout_window, hold_steps, tableau_name="rk4",
):
    """K-tick family chunk in the core (E, N, 3) layout: the family oracle.

    array_transient: `_tick_chunk_scan`'s coupled dynamics with the hold
    window split (hold_steps - w) + w, the emitted state the mean of the last
    w substeps' x-components (readout_window=1 is `_tick_chunk_scan` bit for
    bit). time_multiplexed: one oscillator per lane (the uncoupled core
    field); per tick the node drives are the masked input field plus the
    delayed feedback a_cp * (W^cp @ x_prev), then the loop over the N
    virtual nodes is the delay line, row j of the state node j's snapshot.
    Returns ((3, N, E), states (K, N, E))."""
    m = m_planes.permute(2, 1, 0).contiguous()  # (E, N, 3)
    tableau = integrators.TABLEAUX[tableau_name]
    states = []
    if topology == "time_multiplexed":
        step = integrators.make_step(lambda mm, h: sto.llg_field(mm, params_e, None, h), tableau)
        for u_t, mask_t in zip(u_block, mask_block):
            h = _scan_input_field(params_e, w_in, u_t)  # (E, N); checks full f32
            h = h + params_e.a_cp * torch.einsum("nj,ej->en", w_cp, m[..., 0])
            s, snaps = m[:, -1:, :], []  # the carried oscillator (E, 1, 3)
            for j in range(m.shape[1]):
                s = _hold(step, s, dt, h[:, j : j + 1], hold_steps)
                snaps.append(s[:, 0, :])
            m = torch.where(mask_t[:, None, None], torch.stack(snaps, dim=1), m)
            states.append(m[..., 0].T)
        return m.permute(2, 1, 0).contiguous(), torch.stack(states)
    step = _scan_step(params_e, w_cp, tableau_name)
    w = int(readout_window)
    for u_t, mask_t in zip(u_block, mask_block):
        h_in = _scan_input_field(params_e, w_in, u_t)
        m_new = _hold(step, m, dt, h_in, hold_steps - w)
        xs = []
        for _ in range(w):
            m_new = step(m_new, dt, h_in)
            xs.append(m_new[..., 0])
        state = torch.stack(xs).mean(dim=0) if w > 1 else xs[0]
        state = torch.where(mask_t[:, None], state, m[..., 0])
        m = torch.where(mask_t[:, None, None], m_new, m)
        states.append(state.T)
    return m.permute(2, 1, 0).contiguous(), torch.stack(states)


def _tick_chunk_planes_family(
    params_e, w_cp, w_in, m_planes, u_block, mask_block,
    *, topology, readout_window, dt, hold_steps, impl, n_inner, block_n, block_e,
    interpret, precision="highest",
):
    """K-tick family chunk in the kernel (3, N, E) planes layout.

    Every family computes the (K, N, E) input-field block with ONE GEMM a
    chunk and casts W once under the precision policy; for
    time_multiplexed that cast lands on the delayed-feedback product, the
    family's one O(N^2) term. time_multiplexed under "chunk" runs
    `sto_step.tm_chunk` (the delay-line kernel on the card, the plain body on
    the CPU), else the plain body. array_transient under "ref" / "chunk" is
    the plain `rk4_chunk_planes_window`; under "fused" / "tiled" each hold
    window is (hold - w) steps in one `ops._integrate_planes` call and then w
    single steps, whose x-planes are averaged."""
    e = m_planes.shape[-1]
    pv, a_in = _lane_terms(params_e, e, m_planes)
    h_block = _input_field(w_in, u_block, a_in, precision)  # (K, N, E)
    w_c = ops._coupling_operand(w_cp, precision)
    if topology == "time_multiplexed":
        if impl == "chunk" and not interpret:
            return sto_step.tm_chunk(
                m_planes.contiguous(), w_c, pv, dt, hold_steps, h_block, mask_block
            )
        return kref.tm_chunk_planes(m_planes, w_c, pv, dt, hold_steps, h_block, mask_block)
    if impl in ("ref", "chunk"):
        return kref.rk4_chunk_planes_window(
            m_planes, w_c, pv, dt, hold_steps, readout_window, h_block, mask_block
        )
    w = int(readout_window)
    kw = dict(
        dt=dt, impl=impl, block_n=block_n, block_e=block_e, interpret=interpret,
        precision=precision,
    )
    m, states = m_planes, []
    for h_t, mask_t in zip(h_block, mask_block):
        m_new = m
        if hold_steps > w:
            m_new = ops._integrate_planes(
                m, w_cp, pv, h_t, None, n_steps=hold_steps - w,
                n_inner=min(n_inner, hold_steps - w), **kw,
            )
        xs = []
        for _ in range(w):
            m_new = ops._integrate_planes(m_new, w_cp, pv, h_t, None, n_steps=1, n_inner=1, **kw)
            xs.append(m_new[0])
        state = torch.stack(xs).mean(dim=0) if w > 1 else xs[0]
        state = torch.where(mask_t[None, :], state, m[0])
        m = torch.where(mask_t[None, None, :], m_new, m)
        states.append(state)
    return m, torch.stack(states)  # (3, N, E), (K, N, E)


def _family_learn_tail(mT, states, y_block, lmask_block, p0, w0, learn, knob):
    """The learn tails are topology-blind: they take the (K, N, E) states
    block whatever physics made it (learn="rls": knob = lam; "lms": knob =
    mu, p0 None)."""
    if learn == "lms":
        return (mT, states, *_lms_chunk_tail(states, y_block, lmask_block, w0, knob))
    return (mT, states, *_learn_chunk_tail(states, y_block, lmask_block, p0, w0, knob))


def _tick_chunk_scan_family_learn(
    params_e, w_cp, w_in, m_planes, u_block, mask_block, y_block, lmask_block, p0, w0, dt,
    *, learn, knob, **family_kw,
):
    """`_tick_chunk_scan_family` + the learn tail. Returns (m', states, P',
    W', preds) for RLS, (m', states, W', preds) for NLMS."""
    mT, states = _tick_chunk_scan_family(
        params_e, w_cp, w_in, m_planes, u_block, mask_block, dt, **family_kw
    )
    return _family_learn_tail(mT, states, y_block, lmask_block, p0, w0, learn, knob)


def _tick_chunk_planes_family_learn(
    params_e, w_cp, w_in, m_planes, u_block, mask_block, y_block, lmask_block, p0, w0,
    *, learn, knob, **family_kw,
):
    """`_tick_chunk_planes_family` + the learn tail, which runs in the state
    dtype whatever the precision policy."""
    mT, states = _tick_chunk_planes_family(
        params_e, w_cp, w_in, m_planes, u_block, mask_block, **family_kw
    )
    return _family_learn_tail(mT, states, y_block, lmask_block, p0, w0, learn, knob)


# ---------------------------------------------------------------------------
# CompiledSim
# ---------------------------------------------------------------------------


class CompiledSim:
    """A SimSpec bound to a device and resolved execution decisions. Build
    via compile_plan."""

    def __init__(self, spec: SimSpec, plan: ExecPlan, impl: str):
        self.spec = spec
        self.plan = plan
        self.impl = impl  # resolved: scan | ref | fused | tiled | chunk
        self.e = plan.ensemble
        self.device = spec.device
        self.topology = spec.topology
        self._readout_window = int(spec.readout_window)
        self._block_n = plan.block_n or ops.BLOCK_N
        self._block_e = plan.block_e or ops.BLOCK_E
        self._n_inner = plan.n_inner or spec.hold_steps
        # scan's dt: a 0-d tensor of the state dtype (integrators module note)
        self._dt_scan = integrators.dt_tensor(spec.dt, spec.m0)
        self.precision = ops.normalize_precision(plan.precision)
        # the sharded coupling path's wire dtype (precision subsumes gather_dtype)
        self._gather_dtype = _sharded.torch_dtype(plan.effective_gather_dtype)
        # the learners' knobs, Python floats (RLS: lam == 1 skips the P
        # rescale; LMS: mu is the gain's numerator)
        self._lam = float(plan.learn_lam) if plan.learn else None
        self._mu = float(plan.learn_mu) if plan.learn == "lms" else None
        self._params_cache: Optional[STOParams] = None

    def init_learn_state(self) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
        """Fresh learn_state lanes for the plan's learner, S = N + 1 (states
        + bias), n_out = 1, on the plan's device.

        learn="rls": (P (E, S, S) = I / learn_reg, W (E, S, 1) = 0).
        learn="lms": (None, W (E, S, 1) = 0); the None keeps the (P, W)
        contract uniform. For n_out != 1 call kernels.rls.rls_init /
        lms_init directly."""
        if self.plan.learn is None:
            raise ValueError("init_learn_state() requires ExecPlan(learn=...)")
        s, dt, dev = self.spec.n + 1, self.spec.dtype, self.device
        if self.plan.learn == "lms":
            return None, krls.lms_init(self.e, s, 1, dt, device=dev)
        return krls.rls_init(self.e, s, 1, self.plan.learn_reg, dt, device=dev)

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

    def _sharded_kw(self) -> dict:
        return dict(
            ensemble_axes=tuple(self.plan.ensemble_axes), model_axis=self.plan.model_axis,
            tableau_name=self.spec.tableau, gather_dtype=self._gather_dtype,
            precision=self.precision,
        )

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=self.spec.dtype).to(self.device, non_blocking=True)

    def _coerce_batch_u(self, u, keep_shared: bool = False) -> torch.Tensor:
        """(T, N_in) shared or (T, E, N_in) per lane -> (T, E, N_in).

        keep_shared=True returns a valid shared series as it is: the sharded
        path contracts it once a sample instead of once a lane."""
        spec = self.spec
        u = self._tensor(u)
        if u.ndim == 2 and u.shape[1] == spec.n_in:
            if keep_shared:
                return u
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

        Requires ensemble == 1 and an unsharded plan."""
        spec = self.spec
        if self.e != 1 or self.plan.sharded:
            raise ValueError(
                "drive() is the solo entry point (ensemble == 1, no mesh); "
                "use drive_batch() for ensemble/sharded plans"
            )
        u_seq = coerce_input_series(u_seq, spec.n_in, spec.dtype).to(self.device)
        m_start = spec.m0 if m0 is None else self._tensor(m0)
        if m_start.shape != spec.m0.shape:
            raise ValueError(
                f"m0 must have shape {tuple(spec.m0.shape)}; got {tuple(m_start.shape)}"
            )
        if self.topology != "coupled_array":
            # families drive through their chunk worker: T ticks, one lane
            mT, states = self._family_chunk_infer(
                self.ensemble_params(), ops.to_planes(m_start), u_seq[:, None, :],
                torch.ones((u_seq.shape[0], 1), dtype=torch.bool, device=self.device),
            )
            return ops.from_planes(mT, ()), states[:, :, 0]
        if self.impl == "scan":
            # a (1, 1)-leaved ensemble-of-one spec is legal; the solo scan
            # math takes 0-d leaves (the same values)
            params = STOParams(
                *(x.reshape(()) for x in spec.params.to(self.device, spec.dtype))
            )
            return _drive_scan(
                params, spec.w_cp, spec.w_in, m_start, u_seq, self._dt_scan,
                spec.hold_steps, spec.tableau,
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
        if self.plan.sharded:
            # a shared series stays (T, N_in), contracted once a sample
            return _sharded.drive_sharded(
                self.plan.mesh, params_e, spec.w_cp, spec.w_in, m0_e,
                self._coerce_batch_u(u_seq, keep_shared=True), self._dt_scan,
                spec.hold_steps, **self._sharded_kw(),
            )
        u_e = self._coerce_batch_u(u_seq)
        if self.topology != "coupled_array":
            mT, states = self._family_chunk_infer(
                params_e, ops.to_planes(m0_e), u_e,
                torch.ones((u_e.shape[0], self.e), dtype=torch.bool, device=self.device),
            )
            return ops.from_planes(mT, (self.e,)), states.transpose(1, 2)
        if self.impl == "scan":
            return _drive_scan_batch(
                params_e, spec.w_cp, spec.w_in, m0_e, u_e, self._dt_scan,
                spec.hold_steps, spec.tableau,
            )
        mT, states = _drive_planes(
            params_e, spec.w_cp, spec.w_in, ops.to_planes(m0_e), u_e, **self._planes_kw()
        )
        return ops.from_planes(mT, (self.e,)), states

    def integrate(
        self, n_steps: int, m0=None, save_every: int = 0, params: Optional[STOParams] = None
    ):
        """Free-run (u = 0) integration of the E-lane ensemble.

        Returns (mT (E, N, 3), traj or None) — traj has shape
        (n_steps // save_every, E, N, 3) when save_every > 0. A
        time_multiplexed plan refuses; array_transient free-runs as the
        coupled array (its readout window only shapes the emitted states).
        """
        if self.topology == "time_multiplexed":
            raise ValueError(
                "integrate() free-runs the coupled array; a time_multiplexed "
                "reservoir has no input-free virtual-node evolution — drive "
                "it with a zero input series instead"
            )
        m0_e = self._coerce_batch_m0(m0)
        params_e = self.ensemble_params(params)
        if self.plan.sharded:
            if save_every:
                raise NotImplementedError("save_every on sharded plans")
            mT = _sharded.integrate_sharded(
                self.plan.mesh, params_e, self.spec.w_cp, m0_e, self._dt_scan, n_steps,
                **self._sharded_kw(),
            )
            return mT, None
        if save_every and n_steps % save_every:
            raise ValueError(f"n_steps ({n_steps}) must be a multiple of save_every ({save_every})")
        if self.impl == "scan":

            def field(m, _):
                return sto.llg_field(m, params_e, self.spec.w_cp)

            return integrators.integrate_scan(
                field, m0_e, self._dt_scan, n_steps, None,
                integrators.TABLEAUX[self.spec.tableau], save_every=save_every,
            )
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
        if self.topology != "coupled_array":
            # a tick is a one-tick chunk: one body per family keeps serving's
            # per-tick and chunked paths bit-identical
            mT, states = self._family_chunk_infer(
                self.ensemble_params(params), m_planes, self._tensor(u)[None], mask[None]
            )
            return mT, states[0]
        if self.plan.sharded:
            m_new, states = _sharded.tick_sharded(
                self.plan.mesh, self.ensemble_params(params), spec.w_cp, spec.w_in,
                m_planes.permute(2, 1, 0), self._tensor(u), mask, self._dt_scan,
                spec.hold_steps, **self._sharded_kw(),
            )
            return m_new.permute(2, 1, 0).contiguous(), states.T.contiguous()
        if self.impl == "scan":
            return _tick_scan(
                self.ensemble_params(params), spec.w_cp, spec.w_in, m_planes,
                self._tensor(u), mask, self._dt_scan, spec.hold_steps, spec.tableau,
            )
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
        targets=None,  # (K, E, n_out) learn targets
        learn_state=None,  # (P, W); P is None for learn="lms"
        learn_mask=None,  # (K, E) or (E,) bool
    ):
        """K serving ticks (K hold windows) for a slot batch in one call.

        Returns (m_planes' (3, N, E), states (K, N, E)). lane_mask may be per
        tick (K, E) — a lane masked False for rows [0, k) and True after
        integrates exactly as if admitted at tick k (frozen lanes are
        bit-identical) — or a single (E,) row applied to every tick. On the
        scan impl a K-chunk is bit-identical to K `tick` calls.

        With `ExecPlan(learn="rls" | "lms")` the chunk also LEARNS: pass
        `learn_state=(P (E, S, S), W (E, S, n_out))` (see
        `init_learn_state`; P is None for LMS) and `targets` (K, E, n_out).
        `learn_mask` (default: lane_mask) gates which lanes learn which
        ticks; masked ticks leave P/W value-frozen. Returns (m', states,
        (P', W'), preds (K, E, n_out)), preds being the a-priori
        (pre-update) predictions. The integration is the inference-only
        chunk's on every impl.
        """
        spec = self.spec
        params_e = self.ensemble_params(params)
        u_block = self._tensor(u_block)
        if u_block.ndim != 3 or tuple(u_block.shape[1:]) != (self.e, spec.n_in):
            raise ValueError(
                f"u_block must have shape (K, {self.e}, {spec.n_in}); "
                f"got {tuple(u_block.shape)}"
            )
        k = u_block.shape[0]
        mask_block = self._coerce_tick_mask(lane_mask, k)
        if self.plan.learn is None:
            if targets is not None or learn_state is not None or learn_mask is not None:
                raise ValueError(
                    "targets/learn_state/learn_mask require an "
                    "ExecPlan(learn='rls') plan; this plan is inference-only"
                )
            return self._tick_chunk_infer(params_e, m_planes, u_block, mask_block)
        if learn_state is None or targets is None:
            raise ValueError(
                f"ExecPlan(learn={self.plan.learn!r}) tick_chunk needs "
                "learn_state=(P, W) (P is None for learn='lms') and targets "
                "(K, E, n_out); for an inference-only chunk compile a plan "
                "with learn=None"
            )
        p0, w0 = learn_state
        n_out = w0.shape[-1]
        targets = self._tensor(targets)
        if tuple(targets.shape) != (k, self.e, n_out):
            raise ValueError(
                f"targets must have shape ({k}, {self.e}, {n_out}) to match "
                f"the u block and learn_state W lanes; got {tuple(targets.shape)}"
            )
        if tuple(w0.shape[:2]) != (self.e, spec.n + 1):
            raise ValueError(
                f"learn_state W must have shape ({self.e}, {spec.n + 1}, "
                f"n_out); got {tuple(w0.shape)}"
            )
        lmask_block = (
            mask_block if learn_mask is None else self._coerce_tick_mask(learn_mask, k)
        )
        if self.topology != "coupled_array":
            return self._family_chunk_learn(
                params_e, m_planes, u_block, mask_block, targets, lmask_block, p0, w0
            )
        if self.plan.learn == "lms":
            if p0 is not None:
                raise ValueError(
                    "learn='lms' carries no P block; pass learn_state="
                    "(None, W) (see init_learn_state)"
                )
            if self.impl == "scan":
                mT, states, wT, preds = _tick_chunk_scan_lms(
                    params_e, spec.w_cp, spec.w_in, m_planes, u_block, mask_block,
                    targets, lmask_block, w0, self._mu, self._dt_scan,
                    spec.hold_steps, spec.tableau,
                )
            else:
                mT, states, wT, preds = _tick_chunk_planes_lms(
                    params_e, spec.w_cp, spec.w_in, m_planes, u_block, mask_block,
                    targets, lmask_block, w0, mu=self._mu, **self._planes_kw(),
                )
            return mT, states, (None, wT), preds
        if p0 is None or tuple(p0.shape) != (self.e, spec.n + 1, spec.n + 1):
            raise ValueError(
                f"learn_state must be (P ({self.e}, {spec.n + 1}, "
                f"{spec.n + 1}), W ({self.e}, {spec.n + 1}, n_out)); got "
                f"P={None if p0 is None else tuple(p0.shape)}"
            )
        if self.plan.sharded:
            m_new, states, pT, wT, preds = _sharded.tick_chunk_sharded_rls(
                self.plan.mesh, params_e, spec.w_cp, spec.w_in, m_planes.permute(2, 1, 0),
                u_block, mask_block, targets, lmask_block, p0, w0, self._lam,
                self._dt_scan, spec.hold_steps, **self._sharded_kw(),
            )
            # states arrive (K, E, N): the (K, N, E) block contract
            return (
                m_new.permute(2, 1, 0).contiguous(),
                states.permute(0, 2, 1).contiguous(),
                (pT, wT),
                preds,
            )
        if self.impl == "scan":
            mT, states, pT, wT, preds = _tick_chunk_scan_rls(
                params_e, spec.w_cp, spec.w_in, m_planes, u_block, mask_block,
                targets, lmask_block, p0, w0, self._lam, self._dt_scan,
                spec.hold_steps, spec.tableau,
            )
        else:
            mT, states, pT, wT, preds = _tick_chunk_planes_rls(
                params_e, spec.w_cp, spec.w_in, m_planes, u_block, mask_block,
                targets, lmask_block, p0, w0, lam=self._lam, **self._planes_kw(),
            )
        return mT, states, (pT, wT), preds

    def _family_kw(self) -> dict:
        return dict(topology=self.topology, readout_window=self._readout_window)

    def _family_chunk_infer(self, params_e, m_planes, u_block, mask_block):
        """Inference chunk of a non-coupled family."""
        spec = self.spec
        if self.impl == "scan":
            return _tick_chunk_scan_family(
                params_e, spec.w_cp, spec.w_in, m_planes, u_block, mask_block, self._dt_scan,
                hold_steps=spec.hold_steps, tableau_name=spec.tableau, **self._family_kw(),
            )
        return _tick_chunk_planes_family(
            params_e, spec.w_cp, spec.w_in, m_planes, u_block, mask_block,
            **self._family_kw(), **self._planes_kw(),
        )

    def _family_chunk_learn(
        self, params_e, m_planes, u_block, mask_block, targets, lmask_block, p0, w0
    ):
        """Learning chunk of a non-coupled family (the (P, W) / preds contract
        of the coupled learn paths)."""
        spec, learn = self.spec, self.plan.learn
        if learn == "lms":
            if p0 is not None:
                raise ValueError(
                    "learn='lms' carries no P block; pass learn_state="
                    "(None, W) (see init_learn_state)"
                )
            knob = self._mu
        else:
            if p0 is None or tuple(p0.shape) != (self.e, spec.n + 1, spec.n + 1):
                raise ValueError(
                    f"learn_state must be (P ({self.e}, {spec.n + 1}, "
                    f"{spec.n + 1}), W ({self.e}, {spec.n + 1}, n_out)); got "
                    f"P={None if p0 is None else tuple(p0.shape)}"
                )
            knob = self._lam
        args = (params_e, spec.w_cp, spec.w_in, m_planes, u_block, mask_block, targets,
                lmask_block, p0, w0)
        if self.impl == "scan":
            out = _tick_chunk_scan_family_learn(
                *args, self._dt_scan, learn=learn, knob=knob, hold_steps=spec.hold_steps,
                tableau_name=spec.tableau, **self._family_kw(),
            )
        else:
            out = _tick_chunk_planes_family_learn(
                *args, learn=learn, knob=knob, **self._family_kw(), **self._planes_kw()
            )
        if learn == "lms":
            mT, states, wT, preds = out
            return mT, states, (None, wT), preds
        mT, states, pT, wT, preds = out
        return mT, states, (pT, wT), preds

    def _tick_chunk_infer(self, params_e, m_planes, u_block, mask_block):
        """Inference-only chunk body (plan.learn is None)."""
        spec = self.spec
        if self.topology != "coupled_array":
            return self._family_chunk_infer(params_e, m_planes, u_block, mask_block)
        if self.plan.sharded:
            m_new, states = _sharded.tick_chunk_sharded(
                self.plan.mesh, params_e, spec.w_cp, spec.w_in, m_planes.permute(2, 1, 0),
                u_block, mask_block, self._dt_scan, spec.hold_steps, **self._sharded_kw(),
            )
            # states arrive (K, E, N): the (K, N, E) block contract
            return m_new.permute(2, 1, 0).contiguous(), states.permute(0, 2, 1).contiguous()
        if self.impl == "scan":
            return _tick_chunk_scan(
                params_e, spec.w_cp, spec.w_in, m_planes, u_block, mask_block,
                self._dt_scan, spec.hold_steps, spec.tableau,
            )
        return _tick_chunk_planes(
            params_e, spec.w_cp, spec.w_in, m_planes, u_block, mask_block,
            **self._planes_kw(),
        )

    def warmup(self, n_out: int = 1) -> "CompiledSim":
        """Run ONE all-lanes-masked zero chunk (state-neutral by
        construction) on the current stream and wait for it: it pays every
        first-dispatch cost of this plan at its width (the library's build
        or load, the kernel's module load and shared-memory attribute, the
        caching allocator's growth, cuBLAS's handles). The CUDA kernels
        compute every lane before the mask, so on the card this costs about
        one chunk. Learn plans run it with fresh (P, W) lanes of width
        n_out."""
        spec = self.spec
        k = self.plan.chunk_ticks
        m = ops.to_planes(spec.m0.expand(self.e, spec.n, 3)).contiguous()
        u = torch.zeros((k, self.e, spec.n_in), dtype=spec.dtype, device=self.device)
        mask = torch.zeros((k, self.e), dtype=torch.bool, device=self.device)
        if self.plan.learn is None:
            self.tick_chunk(m, u, lane_mask=mask)
        else:
            s, dt, dev = spec.n + 1, spec.dtype, self.device
            if self.plan.learn == "lms":
                state = (None, krls.lms_init(self.e, s, n_out, dt, device=dev))
            else:
                state = krls.rls_init(self.e, s, n_out, self.plan.learn_reg, dt, device=dev)
            targets = torch.zeros((k, self.e, n_out), dtype=dt, device=dev)
            self.tick_chunk(
                m, u, lane_mask=mask, targets=targets, learn_state=state, learn_mask=mask
            )
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self

    def aot_compile(self, n_out: int = 1) -> "CompiledSim":
        """Do now, without launching anything, what the first dispatch of
        this plan's kernels does before its launch: build or load the CUDA
        kernel library (`_build.load`), resolve the launch configuration of
        the padded (N, E) and the coupling's dtype (its occupancy query,
        cached per process), and with it set the kernel's shared-memory
        attribute, which also loads the kernel's module. Launches nothing
        (`_build.LAUNCHES` unchanged). What only a launch pays (the caching
        allocator's growth, cuBLAS's handles for the readout and learn
        GEMMs, the module of round_bf16_kernel, which takes no attribute)
        stays with the first chunk; `warmup` pays it all. scan / ref /
        interpret plans and CPU plans have nothing to build. n_out is
        accepted for `warmup`'s signature: the learn tails are torch code.

        Raises NotImplementedError for a sharded or a family plan, as the
        reference's AOT lowering does: such a plan warms by one masked chunk
        (compile_plan(aot=True) and PLAN_CACHE.warm(aot=True) catch it)."""
        if self.plan.sharded:
            raise NotImplementedError(
                "aot_compile covers unsharded plans; sharded plans warm by "
                "executing one masked chunk (CompiledSim.warmup)"
            )
        if self.topology != "coupled_array":
            raise NotImplementedError(
                "aot_compile covers coupled_array plans; family plans warm by "
                "executing one masked chunk (CompiledSim.warmup)"
            )
        if self.impl not in KERNEL_IMPLS or self.device.type != "cuda" or self.plan.interpret:
            return self
        _build.load()
        n_p = ops._round_up(self.spec.n, self._block_n)
        e_p = ops._round_up(self.e, self._block_e)
        w_dtype = torch.bfloat16 if self.precision in ops.REDUCED_COUPLING else self.spec.dtype
        config = (
            sto_step.field_launch_config if self.impl == "tiled" else sto_step.coop_launch_config
        )
        config(n_p, e_p, w_dtype, self.device)
        return self


# ---------------------------------------------------------------------------
# compile_plan
# ---------------------------------------------------------------------------


def family_auto_impl(topology: str, impl: str, device_type: str) -> str:
    """`auto`'s impl for a physics family, given the dispatch table's choice
    `impl`. The table ranks the coupled array's impls. The time-multiplexed
    delay line's kernel is "chunk" on the card, its plain body "ref"
    elsewhere (the reference picks "ref": on the TPU its ref and chunk are
    one compiled body, while the port's "ref" is eager torch). For
    array_transient, "chunk" is the eager plain body
    (`rk4_chunk_planes_window`), not the chunk kernel, so on the card the
    table's "chunk" becomes "fused", the same kernel at K = 1."""
    if topology == "time_multiplexed":
        return "chunk" if device_type == "cuda" else "ref"
    if topology == "array_transient" and impl == "chunk" and device_type == "cuda":
        return "fused"
    return impl


def auto_impl(
    topology: str,
    tableau: str,
    dtype: torch.dtype,
    n: int,
    e: int,
    precision: Optional[str],
    device_type: str,
) -> str:
    """What impl="auto" resolves to for a spec's topology, tableau and state
    dtype at (N, E, precision) on a device type.

    A tableau other than RK4 runs the scan oracle: the table's impls
    integrate classical RK4. On the card, a state that is not f32 runs
    "ref", the reference's rule off its kernel platform: the CUDA kernels
    take an f32 state, and "ref" runs any dtype. Otherwise the dispatch
    table's choice (`ops.choose_impl`), mapped to the family's impl
    (`family_auto_impl`)."""
    if tableau != "rk4":
        return "scan"
    if device_type == "cuda" and dtype != torch.float32:
        return "ref"
    itemsize = torch.empty((), dtype=dtype).element_size()
    impl = ops.choose_impl(n, e, itemsize, platform=device_type, precision=precision)
    return family_auto_impl(topology, impl, device_type)


def _check_sharded(spec: SimSpec, plan: ExecPlan, dev: torch.device) -> torch.device:
    """A mesh plan's device and decomposition: the device agrees with the
    mesh's device type (on CUDA the rank's card is the current device, which
    the caller set from LOCAL_RANK), this rank lies in the mesh, and E and N
    divide by the ensemble-axis and model-axis sizes. Returns the device."""
    mesh = plan.mesh
    if dev.type != mesh.device_type:
        raise ValueError(
            f"compile_plan(device={str(dev)!r}) does not agree with the mesh's "
            f"device type {mesh.device_type!r}; pass device={mesh.device_type!r}"
        )
    if mesh.get_coordinate() is None:
        raise ValueError(f"this rank is not in the plan's mesh {mesh!r}")
    e_axes = axis_size(mesh, tuple(plan.ensemble_axes))
    if plan.ensemble % e_axes:
        raise ValueError(
            f"ensemble={plan.ensemble} does not divide over the mesh's ensemble axes "
            f"{tuple(plan.ensemble_axes)} of size {e_axes}"
        )
    n_axis = axis_size(mesh, plan.model_axis)
    if spec.n % n_axis:
        raise ValueError(
            f"N={spec.n} does not divide over the mesh's model axis "
            f"{plan.model_axis!r} of size {n_axis}"
        )
    if dev.type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def compile_plan(
    spec: SimSpec, plan: Optional[ExecPlan] = None, device="cuda", **overrides
) -> CompiledSim:
    """Bind a SimSpec to a device and an ExecPlan, resolving every execution
    decision.

    Keyword overrides build/amend the plan: `compile_plan(spec, ensemble=64)`
    == `compile_plan(spec, ExecPlan(ensemble=64))`. The spec's tensors move
    to `device` ("cuda" by default; raises without a card unless the caller
    passes device="cpu"). "auto" impls resolve against the dispatch table
    (the platform's persisted JSON included); `measure=True` first times
    the candidates at this (N, E) through the process-wide PLAN_CACHE's
    memo and pins the winner; `aot=True` then runs `aot_compile`; a
    `compilation_cache_dir` pins the kernel library's build directory. A
    mesh plan resolves to impl="scan" before any of that, on the rank's
    device of the mesh's type (`_check_sharded`).
    """
    if plan is None:
        plan = ExecPlan(**overrides)
    elif overrides:
        plan = dataclasses.replace(plan, **overrides)
    if plan.compilation_cache_dir:
        from repro_torch.api import cache as _cache  # deferred: cache imports us

        _cache.enable_persistent_cache(plan.compilation_cache_dir)
    dev = resolve_device(device)
    if spec.device != dev:
        spec = spec.to(dev)
    if spec.tableau not in integrators.TABLEAUX:
        raise ValueError(
            f"unknown tableau {spec.tableau!r}; choose from {sorted(integrators.TABLEAUX)}"
        )
    # the spec's family invariants, then the plan/family pairing
    # (api/plan.FAMILY_IMPLS: the coupled-array kernels cannot express the
    # time-multiplexed delay line)
    validate_topology(spec)
    check_plan_supports_topology(plan, spec.topology)

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
    if plan.sharded:
        dev = _check_sharded(spec, plan, dev)
        if spec.device != dev:
            spec = spec.to(dev)
        impl = "scan"  # a mesh plan integrates in the core layout (api/sharded.py)
    elif impl == "auto":
        if plan.measure and (dev.type != "cuda" or spec.dtype == torch.float32):
            # memoized: one (device, N, E, dtype, precision, K) key is timed
            # once; the card's candidates are kernels, which take f32 only
            from repro_torch.api import cache as _cache

            _cache.PLAN_CACHE.measure(
                spec.n, plan.ensemble, dt=float(spec.dt), dtype=spec.dtype,
                precision=plan.effective_precision, chunk_ticks=plan.chunk_ticks, device=dev,
            )
        impl = auto_impl(
            spec.topology, spec.tableau, spec.dtype, spec.n, plan.ensemble,
            plan.effective_precision, dev.type,
        )
    if impl in PLANES_IMPLS and spec.tableau != "rk4":
        # the reference's "ref" body integrates RK4 whatever the tableau; the
        # port refuses that instead of answering with RK4
        raise ValueError(
            f"the planes impls integrate classical RK4 only; impl={impl!r} "
            f"cannot run tableau {spec.tableau!r} (use impl='scan')"
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
            "impl='scan' or 'ref', or an f32 spec"
        )
    sim = CompiledSim(spec, plan, impl)
    if plan.aot:
        try:
            sim.aot_compile()
        except NotImplementedError:  # family plans warm by one masked chunk
            sim.warmup()
    return sim
