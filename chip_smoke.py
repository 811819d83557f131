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
   over the same coupling products (a yardstick only) and the bound; for
   rk4_chunk and rk4_fused also the share of the bound, the time over the
   library's, the launch configuration of the work split (blocks, cluster
   size = contraction slices, tile rows, rounds) and ptxas's registers,
   stack and spills for the kernel, read from the build log. Each of these
   rows is held a second time on the coupling's share of the state alone,
   f(W) - f(0), and a plain version with a fault planted in the product
   (none of it; one contraction slice of the split dropped or summed twice)
   must fail that measure (and, for rk4_chunk, the row's atol).
3. Serve 512 NARMA-10 sessions (16-40 ticks, per-tenant params on some
   lanes, a readout on every session) through ReservoirEngine with
   backend chunk, fused and tiled, launch counters set to 0 before each run
   and read after it; check every result is finite and the chunk run
   against an interpret=True run (the plain versions) of the same engine.
4. Hold the flash-attention kernel against its plain version at the shapes
   h2o-danube-1.8b's prefill gives it (B=1, H=32, KVH=8, D=80, causal,
   window 4096; bf16 at Sq=Sk=129, 1024, 4608 and Sq=512 < Sk=1536; f32 at
   Sq=Sk=1024 without a window). Each case is held by two measures: the
   largest absolute error, and the largest over rows (one position of one
   head) of max|out - plain| / max|plain|, which is scale-free, so a
   4096-key row (|out| ~ 0.03) counts as much as a one-key row (|out| ~ 1).
   At 4608 the plain version with a fault planted (the window one key too
   wide; the 64-key tile holding the window's first key dropped) must fail
   the row measure, which shows the check can see a wrong band. Prints each
   case's errors, the kernel's time, the plain version's, one
   scaled_dot_product_attention call with the same mask (a yardstick only)
   and the bound.
5. Serve 8 requests (prompts of 4608 ... 129 tokens, 32 new tokens each)
   through the LM Engine at the full width of h2o-danube-1.8b (24 layers,
   d_model 2560, bf16, random weights from seed 0) with 4 slots, counters
   set to 0 before the run: every request returns 32 tokens in [0, vocab),
   the flash kernel launched 24 x 8 times and no STO kernel. Then each
   request alone (prefill + decode at batch 1), teacher-forced on the
   engine's tokens: each chosen token's logit within LOGIT_MARGIN of the
   step's maximum, and at most MAX_OFF_ARGMAX of the steps choosing another
   token than that step's argmax. Prints prefill and decode tokens/s, the
   peak device memory, one 4608-token prefill's time (CUDA events) and,
   from a profiler trace of it, the flash kernel's share of its device time.
6. Print the kernels line, the card line and, last, the contract line
   {"ok": true, "device": {...}}.

Without a card, or outside a checkout, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py needs a CUDA card (torch.cuda.is_available() is False)")

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

from repro_torch.api import make_spec  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import constants, coupling, tasks  # noqa: E402
from repro_torch.core.reservoir import Readout  # noqa: E402
from repro_torch.kernels import _build, ops, sto_step  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.models import build_model, counting, transformer  # noqa: E402
from repro_torch.serve.engine import Engine, Request  # noqa: E402
from repro_torch.serve.reservoir import ReservoirEngine, StreamSession  # noqa: E402

N, E, HOLD, K = 2500, 256, 5, 8
DT = constants.DT
SESSIONS = 512
SOURCE = {
    "rk4_chunk": "src/repro_torch/kernels/csrc/sto_rk4.cu",
    "rk4_fused": "src/repro_torch/kernels/csrc/sto_rk4.cu",
    "field_tiled": "src/repro_torch/kernels/csrc/sto_rk4.cu",
    "flash_attention": "src/repro_torch/kernels/csrc/flash_attention.cu",
}
# the Pallas kernel each CUDA kernel replaces
REPLACES = {
    "rk4_chunk": "src/repro/kernels/sto_step.py:237",
    "rk4_fused": "src/repro/kernels/sto_step.py:95",
    "field_tiled": "src/repro/kernels/sto_step.py:167",
    "flash_attention": "src/repro/kernels/flash_attention.py:35",
}
STO_KERNELS = ("rk4_chunk", "rk4_fused", "field_tiled")
# tolerances, kernel vs plain version on the same inputs:
STATE_ATOL = 1e-4  # f32 state over one chunk (FP32 sums in another order)
# bf16-W state: both versions round the x-plane operand to bf16 and sum the
# exact products in f32, so they differ as the f32 ones do (3.0e-7 read on an
# H100 for either W)
BF16_ATOL = 1e-5
# the coupling's share of the state, f(W) - f(0), kernel vs plain version,
# relative to its largest magnitude: here the coupling moves the live lanes
# by ~2.3e-3 over a chunk and f32 rounding moves that share by ~3e-4 of
# itself (a float64 run of the plain version on the CPU), while a
# contraction slice dropped or summed twice moves it by ~0.4 of itself
COUPLING_RTOL = 2e-3
SLOPE_RTOL = 1e-5  # field_tiled slopes (~1e10 Oe/s) relative to their max
# flash attention vs its plain version: bf16 3e-2 (the reference's bf16
# flash test; bf16 probabilities in P.V), f32 5e-6 (its f32 tests); and per
# row, max|err| / max|plain| (row_rel_err): in bf16 the two may round the
# row's largest element to neighbouring values, at most 2^-7 = 7.8e-3 of
# it, so 1e-2 admits that and no second ulp; in f32 ~6x the 3.5e-6 read on
# an H100 at 1024 keys.
FLASH_ATOL = {torch.bfloat16: 3e-2, torch.float32: 5e-6}
FLASH_RTOL = {torch.bfloat16: 1e-2, torch.float32: 2e-5}
FLASH_TILE = 64  # the kernel's KV tile (BK in flash_attention.cu)

# the LM path: h2o-danube-1.8b at full width
LM_ARCH = "h2o-danube-1.8b"
PROMPTS = (4608, 4097, 2048, 1536, 1024, 777, 512, 129)
MAX_NEW = 32
LM_SLOTS = 4
CAPACITY = 4640
# (Sq, Sk, dtype, window) of the flash phase; 4608 exceeds the window
FLASH_CASES = (
    (129, 129, torch.bfloat16, 4096),
    (1024, 1024, torch.bfloat16, 4096),
    (4608, 4608, torch.bfloat16, 4096),
    (1024, 1024, torch.float32, 0),
    (512, 1536, torch.bfloat16, 4096),
)
# Engine (batch 4) vs each request alone (batch 1), teacher-forced: the
# chosen token's logit may sit this far below the step's maximum, and only
# this share of the steps may choose another token than the argmax. bf16
# activations through 24 layers round differently when cuBLAS takes another
# GEMM for 4 rows than for 1; the top two of 32000 logits of the random
# model lie ~0.2 apart, so a stale row or a wrong splice that nudges the
# logits flips far more steps than rounding does.
LOGIT_MARGIN = 0.05
MAX_OFF_ARGMAX = 0.03
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


def ptxas_info(log, fragment):
    """Registers, stack and spills ptxas printed for the entry function whose
    mangled name holds `fragment`; None without a build log (cached build)."""
    if not log:
        return None
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and fragment in line:
            block = []
            for nxt in lines[i + 1 :]:
                if "Compiling entry function" in nxt:
                    break
                block.append(nxt)
            text = "\n".join(block)
            num = lambda pat: int(m.group(1)) if (m := re.search(pat, text)) else None  # noqa: E731
            return dict(
                registers=num(r"Used (\d+) registers"),
                stack_bytes=num(r"(\d+) bytes stack frame"),
                spill_store_bytes=num(r"(\d+) bytes spill stores"),
                spill_load_bytes=num(r"(\d+) bytes spill loads"),
            )
    raise AssertionError(f"no ptxas entry for {fragment} in the build log")


# rk4_coop_kernel<float> and <__nv_bfloat16>, as mangled in the build log
COOP_MANGLED = {
    torch.float32: "rk4_coop_kernelIf",
    torch.bfloat16: "rk4_coop_kernelI13__nv_bfloat16",
}


def launch_config(w_dtype):
    """The work split rk4_chunk / rk4_fused launch at the padded serving
    shape, with the kernel's resources."""
    split = sto_step.coop_launch_config(
        ops._round_up(N, ops.BLOCK_N), E, w_dtype, torch.device("cuda")
    )
    return dict(
        blocks=split.blocks,
        cluster=split.cluster,
        slices=split.cluster,
        clusters=split.clusters,
        tile_rows=split.rows,
        tiles=split.items,
        rounds=split.rounds,
        dynamic_smem_bytes=sto_step.coop_smem_bytes(w_dtype),
        ptxas=ptxas_info(_build.BUILD_LOG, COOP_MANGLED[w_dtype]),
    )


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


def coupling_check(label, kern, plain, w_k, atol=None):
    """The coupling product's share of the result, f(W) - f(0), kernel vs
    plain version (COUPLING_RTOL); then the plain version with a fault
    planted in the product (none of it; the last rank's contraction slice
    of the launch's split dropped, or summed twice) must fail this measure,
    which shows it can see a split fault, and, where `atol` is given, the
    row's absolute tolerance too. Over one hold window (rk4_fused) a dropped
    slice moves the state by less than STATE_ATOL, so there only the
    coupling measure can see it."""
    n_p = w_k.shape[0]
    split = sto_step.coop_launch_config(n_p, E, w_k.dtype, torch.device("cuda"))
    zero = torch.zeros_like(w_k)
    p0 = plain(zero)
    d_plain = plain(w_k) - p0
    scale = d_plain.abs().max().item()
    rel = lambda d: (d - d_plain).abs().max().item() / scale  # noqa: E731
    err = rel(kern(w_k) - kern(zero))
    assert err <= COUPLING_RTOL, f"{label}: coupling share differs by {err} (relative)"
    k0, k1 = next(sto_step.coop_block_work(split, n_p, E, split.cluster - 1)).k
    faults = {}
    for fault, gain in (("coupling dropped", None), ("last slice dropped", 0.0),
                        ("last slice summed twice", 2.0)):
        w_f = zero if gain is None else w_k.clone()
        if gain is not None:
            w_f[:, k0:k1] *= gain
        d = plain(w_f) - p0
        faults[fault] = dict(coupling_rel_err=rel(d), max_abs_err=(d - d_plain).abs().max().item())
        assert faults[fault]["coupling_rel_err"] > COUPLING_RTOL, (label, fault, faults[fault])
        assert atol is None or faults[fault]["max_abs_err"] > atol, (label, fault, faults[fault])
    return dict(coupling_rel_err=err, coupling_max=scale, coupling_faults=faults)


def _flat(*ts):
    return torch.cat([t.flatten() for t in ts])


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
        coupling = coupling_check(
            f"rk4_chunk ({wdt})",
            lambda w_: _flat(*sto_step.rk4_chunk(m, w_, pv, DT, HOLD, h, mask)),
            lambda w_: _flat(*kref.rk4_chunk_planes(m, w_, pv, DT, HOLD, h, mask > 0.5)),
            w_k, tol,
        )
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
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        row["vs_library"] = row["ms"] / row["library_ms"]
        row.update(coupling)
        row["launch"] = launch_config(wdt)
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
    coupling = coupling_check(
        "rk4_fused",
        lambda w_: sto_step.rk4_fused(m, w_, pv, DT, n_inner=HOLD, h_in=h0),
        lambda w_: kref.rk4_multi_step_planes(m, w_, pv, DT, HOLD, h0),
        w,
    )
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
    fused = rows["rk4_fused"]
    fused["share_of_bound"] = fused["bound_ms"] / fused["ms"]
    fused["vs_library"] = fused["ms"] / fused["library_ms"]
    fused.update(coupling)
    fused["launch"] = launch_config(torch.float32)
    print("kernel rk4_fused: " + json.dumps(fused), flush=True)

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


def unmasked_pairs(sq, sk, causal, window):
    """(q, k) pairs the causal/window band leaves unmasked (last q on last k)."""
    p = np.arange(sq, dtype=np.int64) + (sk - sq)
    hi = np.minimum(p, sk - 1) if causal else np.full(sq, sk - 1)
    lo = np.maximum(p - window + 1, 0) if window > 0 else np.zeros(sq, np.int64)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def plain_bshd(q, k, v, window):
    t = lambda x: x.transpose(1, 2)  # noqa: E731
    return t(fa.flash_attention_plain(t(q), t(k), t(v), True, window))


def row_rel_err(out, ref):
    """The largest over rows (one position of one head) of max|out - ref| /
    max|ref|; rows of ref that are all zero count against 1e-30."""
    o, r = out.float(), ref.float()
    return ((o - r).abs().amax(-1) / r.abs().amax(-1).clamp_min(1e-30)).max().item()


def plain_masked(q, k, v, mask):
    """Plain attention (model layout, f32 sums) under an explicit (Sq, Sk)
    key mask, for the planted faults."""
    b, sq, h, d = q.shape
    kvh = k.shape[2]
    qg = q.float().reshape(b, sq, kvh, h // kvh, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * d**-0.5
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    return torch.einsum("bhgqk,bkhd->bqhgd", p, v.float()).reshape(b, sq, h, d).to(q.dtype)


def check_planted_faults(q, k, v, ref, window, dtype):
    """The plain version with a wrong band must fail the row measure: the
    window one key too wide, and the KV tile holding each row's first
    window key dropped (a loop that starts one tile late)."""
    sq, sk = q.shape[1], k.shape[1]
    qi = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
    ki = torch.arange(sk, device=q.device)[None, :]
    first = qi - window + 1
    band = (ki <= qi) & (ki >= first)
    faults = {
        "window one key too wide": (ki <= qi) & (ki >= first - 1),
        "edge tile dropped": band & ~((first > 0) & (ki // FLASH_TILE == first // FLASH_TILE)),
    }
    out = {}
    for label, mask in faults.items():
        bad = plain_masked(q, k, v, mask)
        out[label] = dict(row_rel_err=row_rel_err(bad, ref),
                          max_abs_err=(bad.float() - ref.float()).abs().max().item())
        del bad
        assert out[label]["row_rel_err"] > FLASH_RTOL[dtype], (
            f"planted fault '{label}' passes the row measure: {out[label]}"
        )
    print(f"flash {sq}x{sk} planted faults vs plain (each must exceed rtol "
          f"{FLASH_RTOL[dtype]}): " + json.dumps(out), flush=True)
    return out


def check_flash(name):
    """The flash kernel vs its plain version at h2o-danube's prefill shapes.
    Returns the kernels-line row: the 4608-token bf16 case's numbers, the
    largest error over the cases, and every case under "cases"."""
    dev = torch.device("cuda")
    cfg = get_config(LM_ARCH)
    h, kvh, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    fp32, tensor, bw = peaks(name)
    cases = []
    for sq, sk, dtype, window in FLASH_CASES:
        g = torch.Generator(device=dev).manual_seed(sq * 7 + sk)
        q = torch.randn((1, sq, h, d), generator=g, device=dev).to(dtype)
        k = torch.randn((1, sk, kvh, d), generator=g, device=dev).to(dtype)
        v = torch.randn((1, sk, kvh, d), generator=g, device=dev).to(dtype)
        out = fa.flash_attention_bshd(q, k, v, causal=True, window=window)
        ref = plain_bshd(q, k, v, window)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        rel = row_rel_err(out, ref)
        assert err <= FLASH_ATOL[dtype] and rel <= FLASH_RTOL[dtype], (
            f"flash {sq}x{sk} {dtype}: max abs error {err} (atol {FLASH_ATOL[dtype]}), "
            f"row error {rel} (rtol {FLASH_RTOL[dtype]})"
        )
        faults = None
        if sq > window > 0:  # the band bites
            faults = check_planted_faults(q, k, v, ref, window, dtype)
        del ref
        flops = 4.0 * h * d * unmasked_pairs(sq, sk, True, window)
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        rate = tensor if dtype == torch.bfloat16 else fp32
        t_ops, t_bytes = flops / rate, nbytes / bw
        qi = torch.arange(sq, device=dev)[:, None] + (sk - sq)
        ki = torch.arange(sk, device=dev)[None, :]
        mask = (ki <= qi) & ((ki > qi - window) if window else True)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, attn_mask=mask, enable_gqa=True
        )
        case = dict(
            sq=sq, sk=sk, dtype=str(dtype).split(".")[-1], window=window, max_abs_err=err,
            row_rel_err=rel, atol=FLASH_ATOL[dtype], rtol=FLASH_RTOL[dtype],
            ms=time_ms(lambda: fa.flash_attention_bshd(q, k, v, causal=True, window=window), 10),
            plain_ms=time_ms(lambda: plain_bshd(q, k, v, window), 3),
            bound_ms=1e3 * max(t_ops, t_bytes),
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            library_ms=time_ms(sdpa, 10),
        )
        if faults:
            case["planted_faults"] = faults
        cases.append(case)
        print("kernel flash_attention: " + json.dumps(case), flush=True)
        del q, k, v, out, mask
        torch.cuda.empty_cache()
    main = next(c for c in cases if c["sq"] == max(PROMPTS) and c["dtype"] == "bfloat16")
    row = {k: main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
    row["max_abs_err"] = max(c["max_abs_err"] for c in cases)
    row["row_rel_err"] = max(c["row_rel_err"] for c in cases)
    row["cases"] = cases
    return row


def teacher_forced_margins(model, params, cfg, req, tokens):
    """Run `req` alone (batch 1) teacher-forced on `tokens`; per step, the gap
    between the step's maximum logit and the chosen token's (0 where the
    chosen token is the argmax)."""
    last, caches = model.prefill(params, {"tokens": req.prompt[None].cuda()})
    caches = transformer.pad_caches(cfg, caches, CAPACITY)
    logits, gaps = last[0, -1, : cfg.vocab_size], []
    for j, tok in enumerate(tokens):
        assert torch.isfinite(logits).all(), f"request {req.rid}: logits not finite"
        gaps.append((logits.max() - logits[tok]).item())
        if j + 1 < len(tokens):
            lg, caches = model.decode_step(
                params, torch.tensor([[tok]], device="cuda"), caches,
                torch.tensor([len(req.prompt) + j], device="cuda"),
            )
            logits = lg[0, -1, : cfg.vocab_size]
    return gaps


def serve_lm(name_power):
    """Phase 5; returns the flash kernel's launches in the engine run."""
    cfg = get_config(LM_ARCH)
    model = build_model(cfg, device="cuda")
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    sizes = []
    transformer.tree_map(lambda t: sizes.append(t.numel()), params)
    n_params = sum(sizes)
    print(
        f"lm {LM_ARCH}: {n_params} parameters (count_params {counting.count_params(cfg)}), "
        f"init on the card {time.perf_counter() - t0:.3f} s",
        flush=True,
    )
    rng = np.random.default_rng(0)
    reqs = [
        Request(i, torch.from_numpy(rng.integers(0, cfg.vocab_size, n)), MAX_NEW)
        for i, n in enumerate(PROMPTS)
    ]
    # warm-up (cuBLAS handles, allocator) on two short requests, not counted
    Engine(cfg, params, num_slots=2, capacity=64, device="cuda").run(
        [Request(0, reqs[-1].prompt[:32], 2), Request(1, reqs[-1].prompt[:16], 2)]
    )
    eng = Engine(cfg, params, num_slots=LM_SLOTS, capacity=CAPACITY, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sto_step.reset_launches()
    t0 = time.perf_counter()
    results = eng.run(list(reqs))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(sto_step.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    assert sorted(results) == [r.rid for r in reqs], f"served {sorted(results)}"
    for r in reqs:
        toks = results[r.rid]
        assert len(toks) == MAX_NEW and all(0 <= t < cfg.vocab_size for t in toks), (r.rid, toks)
    want = cfg.num_layers * len(PROMPTS)
    assert launches["flash_attention"] == want, f"flash launches {launches} != {want}"
    assert not any(launches[k] for k in STO_KERNELS), f"STO kernels launched: {launches}"
    st = eng.stats
    print(
        f"serve lm {LM_ARCH}: {len(reqs)} requests, {sum(map(len, results.values()))} tokens in "
        f"{seconds:.3f} s; prefill {st.prefill_tokens} tokens in {st.prefill_seconds:.3f} s = "
        f"{st.prefill_tokens / st.prefill_seconds:.1f} tok/s; decode {st.decode_steps} steps, "
        f"{st.decode_tokens} tokens in {st.decode_seconds:.3f} s = "
        f"{st.decode_tokens / st.decode_seconds:.1f} tok/s; peak memory {peak / 2**30:.3f} GiB; "
        f"launches {launches} ({name_power})",
        flush=True,
    )

    gaps = [g for r in reqs for g in teacher_forced_margins(model, params, cfg, r, results[r.rid])]
    worst = max(gaps)
    off = sum(g > 0 for g in gaps) / len(gaps)
    print(f"serve lm vs each request alone (teacher-forced): worst logit margin {worst:.4e} "
          f"(tolerance {LOGIT_MARGIN}); steps off the argmax {sum(g > 0 for g in gaps)} of "
          f"{len(gaps)} = {off:.4f} (at most {MAX_OFF_ARGMAX})", flush=True)
    assert worst <= LOGIT_MARGIN, f"engine vs per-request margin {worst} > {LOGIT_MARGIN}"
    assert off <= MAX_OFF_ARGMAX, f"engine off the per-request argmax on {off:.4f} of steps"

    # one 4608-token prefill: its time (CUDA events), then where its device
    # time goes, the flash kernel's share measured inside it (profiler)
    batch = {"tokens": reqs[0].prompt[None].cuda()}
    prefill_ms = time_ms(lambda: model.prefill(params, batch), 3)
    print(f"prefill {len(reqs[0].prompt)} tokens: {prefill_ms:.3f} ms ({name_power})", flush=True)
    busy_us, flash_us = trace("prefill 4608 tokens", lambda: model.prefill(params, batch),
                              name_power, match="flash")
    print(
        f"prefill {len(reqs[0].prompt)} tokens, traced: flash kernel {flash_us / 1e3:.3f} ms of "
        f"{busy_us / 1e3:.3f} ms device time = {100 * flash_us / busy_us:.1f} % ({name_power})",
        flush=True,
    )
    tokens = torch.ones((LM_SLOTS, 1), dtype=torch.long, device="cuda")
    pos = torch.tensor([n - 1 for n in PROMPTS[:LM_SLOTS]], device="cuda")  # a full batch
    decode_ms = time_ms(lambda: model.decode_step(params, tokens, eng.caches, pos), 5)
    print(f"decode step, batch {LM_SLOTS}, capacity {CAPACITY}: {decode_ms:.3f} ms ({name_power})",
          flush=True)
    trace(f"decode step batch {LM_SLOTS}", lambda: model.decode_step(params, tokens, eng.caches, pos),
          name_power)
    return launches["flash_attention"]


def trace(label, fn, name_power, top=8, match=None):
    """torch.profiler over one call of fn after a warm-up: host wall time,
    the device's busy time (sum of kernel self times, one stream) and share,
    and the kernels that take the most device time. The profiler adds host
    overhead, so the busy share is a lower bound. Returns the busy time and
    the device time of the kernels whose name holds `match` (us)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    dev_us = lambda e: getattr(e, "self_device_time_total", None) or getattr(  # noqa: E731
        e, "self_cuda_time_total", 0.0
    )
    # device-side events only (kernels, memcpy, memset): an operator's own
    # device time repeats that of the kernels it launched
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    busy_us = sum(dev_us(e) for e in events)
    kernels = sorted(events, key=dev_us, reverse=True)[:top]
    print(
        f"trace {label}: wall {wall_us / 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} ms "
        f"({100 * busy_us / wall_us:.1f} %), {sum(e.count for e in events)} device ops; top: "
        + "; ".join(f"{e.key[:60]} x{e.count} {dev_us(e) / 1e3:.3f} ms" for e in kernels)
        + f" ({name_power})",
        flush=True,
    )
    matched = sum(dev_us(e) for e in events if match and match in e.key)
    return busy_us, matched


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

    rows["flash_attention"] = check_flash(name)
    rows["flash_attention"]["launches"] = serve_lm(name_power)

    kernels = [
        dict(name=k, route="cuda", source=SOURCE[k], replaces=REPLACES[k], **rows[k])
        for k in (*STO_KERNELS, "flash_attention")
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(name_power, flush=True)
    device = {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}), flush=True)


if __name__ == "__main__":
    main()
