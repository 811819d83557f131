"""Drive the PyTorch/CUDA port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card, nvcc and
PyTorch built for CUDA. Phases, each of which raises (and so exits non-zero)
on failure:

1. Build the CUDA kernels from src/repro_torch/kernels/csrc (nvcc) and print
   the build time and the card (name and power limit from nvidia-smi).
2. Hold each kernel against its plain PyTorch version on the card at the
   shapes the serving path gives it (N=2500 padded to 2560, E=256,
   hold_steps=5, K=8, W from make_coupling_matrix(2500, seed=0)): rk4_chunk
   with lanes frozen, retired and admitted mid-chunk (and again with a bf16
   W), rk4_fused with n_inner=5, field_tiled at c = 0, dt/2 and dt. Prints
   each kernel's error, its time, the plain version's time, one torch.matmul
   over the same coupling products (a yardstick only) and the bound.
3. Serve 512 NARMA-10 sessions (16-40 ticks, per-tenant params on some
   lanes, a readout on every session) through ReservoirEngine with
   backend chunk, fused and tiled, launch counters set to 0 before each run
   and read after it; check every result is finite and the chunk run
   against an interpret=True run (the plain versions) of the same engine.
4. Print the kernels line, the card line and, last, the contract line
   {"ok": true, "device": {...}}.

Without a card, or outside a checkout, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py needs a CUDA card (torch.cuda.is_available() is False)")

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

from repro_torch.api import make_spec  # noqa: E402
from repro_torch.core import constants, coupling, tasks  # noqa: E402
from repro_torch.core.reservoir import Readout  # noqa: E402
from repro_torch.kernels import _build, ops, sto_step  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.serve.reservoir import ReservoirEngine, StreamSession  # noqa: E402

N, E, HOLD, K = 2500, 256, 5, 8
DT = constants.DT
SESSIONS = 512
SOURCE = "src/repro_torch/kernels/csrc/sto_rk4.cu"
# the Pallas kernel each CUDA kernel replaces
REPLACES = {
    "rk4_chunk": "src/repro/kernels/sto_step.py:237",
    "rk4_fused": "src/repro/kernels/sto_step.py:95",
    "field_tiled": "src/repro/kernels/sto_step.py:167",
}
# tolerances, kernel vs plain version on the same inputs:
STATE_ATOL = 1e-4  # f32 state over one chunk (FP32 sums in another order)
BF16_ATOL = 5e-3  # bf16-W state (the reference's bf16 NARMA guardrail scale)
SLOPE_RTOL = 1e-5  # field_tiled slopes (~1e10 Oe/s) relative to their max
# LLG epilogue + stage algebra, FLOPs per (oscillator, lane, stage)
EPILOGUE_FLOPS = 60
# published peaks (NVIDIA H100 data sheet, dense): FP32 outside the tensor
# cores, bf16 tensor cores, HBM bandwidth
PEAKS = {  # name fragment -> (fp32 FLOP/s, bf16 tensor FLOP/s, bytes/s)
    "PCIe": (51.2e12, 756e12, 2.0e12),
    "NVL": (60e12, 835e12, 3.9e12),
    "": (67e12, 989e12, 3.35e12),  # SXM
}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def peaks(name: str):
    for frag, vals in PEAKS.items():
        if frag in name:
            return vals
    raise AssertionError("unreachable")


def bound_ms(name, gemm_flops, epi_flops, nbytes, bf16):
    fp32, tensor, bw = peaks(name)
    t_ops = gemm_flops / (tensor if bf16 else fp32) + epi_flops / fp32
    t_bytes = nbytes / bw
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def time_ms(fn, reps):
    """Median ms of fn over reps, each timed with CUDA events, after one
    untimed call."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return sorted(times)[len(times) // 2]


def kernel_inputs(dev):
    """The serving path's padded operands: N=2500 -> 2560, E=256."""
    g = torch.Generator().manual_seed(0)
    w = torch.as_tensor(coupling.make_coupling_matrix(N, seed=0))
    m = constants.initial_magnetization(N, device="cpu").expand(E, N, 3)
    m = m + 0.05 * torch.randn((E, N, 3), generator=g)
    m = m / m.norm(dim=-1, keepdim=True)
    pv = kref.pack_params(constants.default_params(device="cpu"), E)
    h = 0.5 * torch.rand((K, N, E), generator=g)
    m, w, pv, _, _, _ = ops._pad_planes(ops.to_planes(m), w, pv, None, ops.BLOCK_N, ops.BLOCK_E)
    n_p = m.shape[1]
    h = torch.nn.functional.pad(h, (0, 0, 0, n_p - N))
    # lanes 0-63 frozen for the whole chunk, 64-95 retire after tick 3,
    # 96-127 admitted at tick 4, the rest live throughout
    mask = torch.ones((K, E))
    mask[:, :64] = 0
    mask[4:, 64:96] = 0
    mask[:4, 96:128] = 0
    return [t.to(dev).contiguous() for t in (m, w, pv, h, mask)]


def check_kernels(name):
    dev = torch.device("cuda")
    m, w, pv, h, mask = kernel_inputs(dev)
    e = E
    state_bytes = 3 * N * e * 4
    plane = N * e * 4
    rows = {}

    # -- rk4_chunk, f32 and bf16 W --------------------------------------------
    for wdt, tol in ((torch.float32, STATE_ATOL), (torch.bfloat16, BF16_ATOL)):
        w_k = w.to(wdt)
        mk, sk = sto_step.rk4_chunk(m, w_k, pv, DT, HOLD, h, mask)
        mp, sp = kref.rk4_chunk_planes(m, w_k, pv, DT, HOLD, h, mask > 0.5)
        torch.cuda.synchronize()
        err = max((mk - mp).abs().max().item(), (sk - sp).abs().max().item())
        assert err <= tol, f"rk4_chunk ({wdt}) differs from its plain version by {err}"
        assert torch.equal(mk[:, :, :64], m[:, :, :64]), "frozen lanes changed"
        assert torch.equal(sk[:, :, :64], m[0, :, :64].expand(K, -1, -1)), "frozen states"
        assert all(torch.equal(sk[t, :, 64:96], sk[3, :, 64:96]) for t in range(4, K)), (
            "lanes retired after tick 3 moved"
        )
        assert all(torch.equal(sk[t, :, 96:128], m[0, :, 96:128]) for t in range(4)), (
            "lanes admitted at tick 4 moved before it"
        )
        assert not torch.equal(sk[4, :, 96:128], m[0, :, 96:128]), "admitted lanes never ran"
        gemm = 2.0 * N * N * e * 4 * HOLD * K
        epi = EPILOGUE_FLOPS * N * e * 4 * HOLD * K
        nbytes = N * N * w_k.element_size() + 2 * state_bytes + 10 * e * 4 + 2 * K * plane + K * e * 4
        b_ms, b_by = bound_ms(name, gemm, epi, nbytes, wdt == torch.bfloat16)
        x = torch.rand((w.shape[0], 4 * HOLD * K * e), device=dev).to(wdt)
        row = dict(
            max_abs_err=err,
            ms=time_ms(lambda: sto_step.rk4_chunk(m, w_k, pv, DT, HOLD, h, mask), 5),
            plain_ms=time_ms(lambda: kref.rk4_chunk_planes(m, w_k, pv, DT, HOLD, h, mask > 0.5), 3),
            bound_ms=b_ms,
            bound_by=b_by,
            library_ms=time_ms(lambda: torch.matmul(w_k, x), 5),
        )
        del x
        if wdt == torch.float32:
            rows["rk4_chunk"] = row
        else:
            rows["rk4_chunk"]["bf16_w"] = row
        print(f"kernel rk4_chunk W={wdt}: " + json.dumps(row), flush=True)

    # -- rk4_fused, n_inner = hold_steps -------------------------------------
    h0 = h[0].contiguous()
    mf = sto_step.rk4_fused(m, w, pv, DT, n_inner=HOLD, h_in=h0)
    mfp = kref.rk4_multi_step_planes(m, w, pv, DT, HOLD, h0)
    torch.cuda.synchronize()
    err = (mf - mfp).abs().max().item()
    assert err <= STATE_ATOL, f"rk4_fused differs from its plain version by {err}"
    gemm = 2.0 * N * N * e * 4 * HOLD
    epi = EPILOGUE_FLOPS * N * e * 4 * HOLD
    nbytes = N * N * 4 + 2 * state_bytes + 10 * e * 4 + plane
    b_ms, b_by = bound_ms(name, gemm, epi, nbytes, False)
    x = torch.rand((w.shape[0], 4 * HOLD * e), device=dev)
    rows["rk4_fused"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: sto_step.rk4_fused(m, w, pv, DT, n_inner=HOLD, h_in=h0), 10),
        plain_ms=time_ms(lambda: kref.rk4_multi_step_planes(m, w, pv, DT, HOLD, h0), 5),
        bound_ms=b_ms,
        bound_by=b_by,
        library_ms=time_ms(lambda: torch.matmul(w, x), 10),
    )
    print("kernel rk4_fused: " + json.dumps(rows["rk4_fused"]), flush=True)

    # -- field_tiled at c = 0, dt/2, dt --------------------------------------
    kprev = kref.llg_field_planes(m, w, pv, h0)
    errs, rel = [], []
    for c in (0.0, 0.5 * DT, DT):
        yx = (m[0] + c * kprev[0]).contiguous()
        kt = sto_step.field_tiled(m, yx, kprev, w, pv, c, h_in=h0)
        ktp = sto_step.field_tiled_plain(m, yx, kprev, w, pv, c, h0)
        torch.cuda.synchronize()
        errs.append((kt - ktp).abs().max().item())
        rel.append(errs[-1] / ktp.abs().max().item())
        assert rel[-1] <= SLOPE_RTOL, f"field_tiled (c={c}) differs by {rel[-1]} (relative)"
    yx = (m[0] + 0.5 * DT * kprev[0]).contiguous()
    gemm = 2.0 * N * N * e
    epi = EPILOGUE_FLOPS * N * e
    nbytes = N * N * 4 + 3 * state_bytes + 2 * plane + 10 * e * 4
    b_ms, b_by = bound_ms(name, gemm, epi, nbytes, False)
    rows["field_tiled"] = dict(
        max_abs_err=max(errs),
        max_rel_err=max(rel),
        ms=time_ms(lambda: sto_step.field_tiled(m, yx, kprev, w, pv, 0.5 * DT, h_in=h0), 20),
        plain_ms=time_ms(lambda: sto_step.field_tiled_plain(m, yx, kprev, w, pv, 0.5 * DT, h0), 10),
        bound_ms=b_ms,
        bound_by=b_by,
        library_ms=time_ms(lambda: torch.matmul(w, yx), 20),
    )
    print("kernel field_tiled: " + json.dumps(rows["field_tiled"]), flush=True)
    return rows


def make_sessions(rng):
    """512 NARMA-10 streams of 16-40 ticks (disjoint windows of one series),
    per-tenant params on every fourth, a readout (random, from the seed) on
    every one."""
    base = constants.default_params(device="cpu")
    u_all, _ = tasks.narma_series(SESSIONS * 40, order=10, seed=0)
    sessions = []
    for sid in range(SESSIONS):
        t = int(rng.integers(16, 41))
        u = u_all[sid * 40 : sid * 40 + t]
        params = None
        if sid % 4 == 0:
            params = base._replace(
                current=torch.tensor(rng.uniform(2.0e-3, 3.0e-3)),
                a_in=torch.tensor(rng.uniform(0.5, 1.5)),
            )
        w_out = rng.normal(0.0, 1.0 / math.sqrt(N), (N + 1, 1)).astype(np.float32)
        sessions.append(
            StreamSession(sid=sid, u_seq=u, params=params, readout=Readout(torch.from_numpy(w_out), 0))
        )
    return sessions


def serve(spec, backend, interpret=False):
    eng = ReservoirEngine(
        spec, num_slots=E, chunk_ticks=K, backend=backend, interpret=interpret, device="cuda"
    )
    sessions = make_sessions(np.random.default_rng(0))
    sto_step.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = eng.run(sessions)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(sto_step.LAUNCHES)
    assert len(results) == SESSIONS, f"{backend}: {len(results)} of {SESSIONS} sessions returned"
    for sess in sessions:
        r = results[sess.sid]
        assert r.error is None, r.error
        assert r.states.shape == (sess.u_seq.shape[0], N), (sess.sid, r.states.shape)
        assert r.outputs.shape == (sess.u_seq.shape[0], 1)
        for a in (r.states, r.outputs, r.final_m):
            assert np.isfinite(a).all(), f"{backend}: session {sess.sid} not finite"
    return results, seconds, launches, sessions


def main():
    name_power = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"card: {name_power}", flush=True)

    t0 = time.perf_counter()
    _build.load()
    print(f"build: {time.perf_counter() - t0:.3f} s ({_build.BUILD_DIR})", flush=True)
    if _build.BUILD_LOG:
        print(_build.BUILD_LOG.strip(), flush=True)

    rows = check_kernels(name)

    spec = make_spec(N, n_in=1, seed=0, hold_steps=HOLD, device="cuda")
    impl_kernel = {"chunk": "rk4_chunk", "fused": "rk4_fused", "tiled": "field_tiled"}
    served = {}
    for backend, kern in impl_kernel.items():
        results, seconds, launches, sessions = serve(spec, backend)
        assert launches[kern] > 0, f"backend {backend} never launched {kern}: {launches}"
        rows[kern]["launches"] = launches[kern]
        served[backend] = results
        print(
            f"serve backend={backend}: {SESSIONS} sessions in {seconds:.3f} s = "
            f"{SESSIONS / seconds:.1f} sessions/s, launches {launches} ({name_power})",
            flush=True,
        )

    # the chunk run against the plain versions of the same engine
    ref, seconds, launches, sessions = serve(spec, "chunk", interpret=True)
    assert not any(launches.values()), f"interpret run launched kernels: {launches}"
    worst_state = worst_out = 0.0
    for sess in sessions:
        a, b = served["chunk"][sess.sid], ref[sess.sid]
        ds = np.abs(a.states - b.states).max()
        dm = np.abs(a.final_m - b.final_m).max()
        do = np.abs(a.outputs - b.outputs).max()
        # outputs: |dy| <= ||w_out||_1 * max|dx|
        out_tol = STATE_ATOL * np.abs(sess.readout.w_out.numpy()).sum()
        assert max(ds, dm) <= STATE_ATOL, f"session {sess.sid}: chunk vs plain state {ds}, {dm}"
        assert do <= out_tol, f"session {sess.sid}: chunk vs plain output {do} > {out_tol}"
        worst_state, worst_out = max(worst_state, ds, dm), max(worst_out, do)
    print(
        f"serve chunk vs interpret (plain versions): max |state| diff {worst_state:.3e} "
        f"(atol {STATE_ATOL}), max |output| diff {worst_out:.3e}; plain run "
        f"{SESSIONS / seconds:.1f} sessions/s",
        flush=True,
    )

    kernels = [
        dict(name=k, route="cuda", source=SOURCE, replaces=REPLACES[k], **rows[k])
        for k in ("rk4_chunk", "rk4_fused", "field_tiled")
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(name_power, flush=True)
    device = {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}), flush=True)


if __name__ == "__main__":
    main()
