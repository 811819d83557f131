"""Time field_tiled's kernel at every cluster size, on the card.

    python3 tools/field_split_sweep.py [--variant NAME ...] [--n N ...]

Builds src/repro_torch/kernels/csrc/sto_rk4.cu into build/ once as it
stands and once per --variant, a copy of the source with one textual change
(VARIANTS below; the change must match exactly once), all builds in
parallel. Then, at E = 256 and each padded N (default 2560 and 10048), for
each W type and each cluster size C = 1..8, it launches field_stage_kernel
as field_tiled does (c = dt/2) with that C forced and prints: the
co-resident clusters (cudaOccupancyMaxActiveClusters), the waves of one
cluster per output tile, sto_step.split_cost (what field_split minimises),
the median time of one launch (CUDA events over 10 back-to-back launches),
and the largest slope error against field_tiled_plain relative to the
largest slope. The C that sto_step.field_split picks is marked "*". Each
build's ptxas registers and spills for the kernel, torch.matmul's time over
the same product and the card's name and power limit are printed too. W is
made on the card from a torch.Generator (zero diagonal, scaled like
make_coupling_matrix).
"""

from __future__ import annotations

import argparse
import ctypes
import os
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (exits without a card)
from repro_torch.kernels import _build, sto_step  # noqa: E402

SOURCE = ROOT / "src/repro_torch/kernels/csrc/sto_rk4.cu"
MANGLED = {torch.float32: "field_stage_kernelIf", torch.bfloat16: "field_stage_kernelI13__nv_bfloat16"}
# name -> (text, replacement) in a copy of the source
VARIANTS = {
    # two blocks an SM asked of ptxas: at most 128 registers a thread (the
    # 3-deep ring's shared memory still holds one block an SM)
    "regs128": (
        "__launch_bounds__(Product<WT>::THREADS, 1) field_stage_kernel(",
        "__launch_bounds__(Product<WT>::THREADS, 2) field_stage_kernel(",
    ),
}


def build(variants):
    """One library per variant name; "default" is the source as it stands."""
    out = _build.BUILD_DIR / f"field_split_sweep_{os.getpid()}"
    out.mkdir(parents=True, exist_ok=True)
    procs = []
    for tag in variants:
        src = SOURCE.read_text()
        if tag != "default":
            text, repl = VARIANTS[tag]
            if src.count(text) != 1:
                raise ValueError(f"variant {tag}: text not found exactly once: {text!r}")
            src = src.replace(text, repl)
        cu = out / f"sto_rk4_{tag}.cu"
        cu.write_text(src)
        so = out / f"libsto_rk4_{tag}.so"
        cmd = [_build._nvcc(), *_build.ARCH_FLAGS, *_build.NVCC_FLAGS, "-shared", "-o", str(so),
               str(cu)]
        procs.append((tag, so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
    libs = []
    for tag, so, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {tag}:\n{log}")
        lib = ctypes.CDLL(str(so))
        for name in ("sto_field_stage", "sto_field_max_clusters", "sto_field_smem"):
            args, res = _build._SIGNATURES[name]
            getattr(lib, name).argtypes, getattr(lib, name).restype = list(args), res
        libs.append((tag, lib, log))
    return libs


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", action="append", choices=sorted(VARIANTS), default=[])
    ap.add_argument("--n", action="append", type=int, default=[])
    opts = ap.parse_args()
    dev = torch.device("cuda")
    print(f"card: {cs.card_line()}", flush=True)
    libs = build(["default", *opts.variant])
    e, dt = cs.E, float(cs.DT)
    for n in opts.n or (2560, 10048):
        m, w, pv, h = cs.device_inputs(n, n, dev, seed=1)
        kprev = sto_step.field_tiled_plain(m, m[0], m, w, pv, 0.0, h)
        yx = (m[0] + 0.5 * dt * kprev[0]).contiguous()
        for wdt in (torch.float32, torch.bfloat16):
            wk = w.to(wdt)
            x = yx.to(wdt)  # the operand the kernel reads (a yardstick tool: torch rounds it here)
            plain = sto_step.field_tiled_plain(m, yx, kprev, wk, pv, 0.5 * dt, h)
            scale = plain.abs().max().item()
            lib_ms = cs.time_ms(lambda: torch.matmul(wk, x), 10)
            print(f"N={n} E={e} W={str(wdt).split('.')[-1]}: torch.matmul {lib_ms:.4f} ms", flush=True)
            for tag, lib, log in libs:
                bf16 = int(wdt == torch.bfloat16)
                resident = {c: lib.sto_field_max_clusters(bf16, c) for c in range(1, 9)}
                pick = sto_step.field_split(n, e, resident.get, sto_step.COOP_ROWS[wdt])
                print(f"  build {tag}: smem {lib.sto_field_smem(bf16)} B, ptxas "
                      f"{cs.ptxas_info(log, MANGLED[wdt])}, resident clusters {resident}",
                      flush=True)
                rows, units = sto_step.COOP_ROWS[wdt], n // sto_step.SLICE
                tiles = -(-n // rows)
                for c in range(1, 9):
                    if resident[c] < 1 or c > units:
                        continue
                    out = torch.empty_like(m)
                    p = sto_step._ptr

                    def launch(reps=1):
                        for _ in range(reps):
                            err = lib.sto_field_stage(
                                bf16, p(pv), p(wk), p(x), p(h), p(m), p(kprev), None, p(out), None,
                                None, None, 0.5 * dt, 0.0, 0.0, n, e, c, sto_step._stream(dev),
                            )
                            assert err == 0, f"launch failed with cudaError {err}"

                    launch()
                    torch.cuda.synchronize()
                    rel = (out - plain).abs().max().item() / scale
                    ms = cs.time_ms(lambda: launch(10), 10) / 10
                    waves = -(-tiles // resident[c])
                    cost = sto_step.split_cost(n, rows, c, resident[c])
                    mark = "*" if c == pick.cluster else " "
                    print(f"  {mark} C={c} resident={resident[c]} waves={waves} cost={cost} "
                          f"ms={ms:.4f} rel_err={rel:.2e}", flush=True)
            del wk, x
        del m, w, pv, h, kprev, yx
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
