"""Where a stage of the cooperative RK4 kernel spends its time, on the card.

    python3 tools/sto_phase_times.py [--no-l2-hints] [--config f32:5x22 ...]

Builds src/repro_torch/kernels/csrc/sto_rk4.cu into build/ with
-DSTO_PHASE_TIMES, which turns on the kernel's PHASE_MARK timers (thread 0
of every block reads %globaltimer at each phase boundary and adds the
interval to its block's counters), runs rk4_chunk at chip_smoke.py's serving
shape (N = 2500 -> 2560, E = 256, K = 8, hold_steps = 5, lanes frozen,
retired and admitted) for each launch configuration, and prints, per phase,
the mean and the largest over blocks of the time per stage, in us:

  setup     tile bookkeeping before the product
  product   the cp.async ring and the tile product of the block's slice
  csync1    the cluster barrier that makes the partial tiles visible
  epilogue  the reduction over the cluster's partial tiles and the LLG
  csync2    the cluster barrier before a block's next tile reuses the ring
  tail      from the last tile to the grid barrier
  grid      grid.sync(): the barrier and the wait for the slowest block

A block's phases add up to the stage time, so `grid` holds the imbalance
between blocks. The card's SM clock and power draw are sampled (nvidia-smi)
while the kernels run. --no-l2-hints builds with -DSTO_L2_EVICT_NORMAL,
which sets every L2 eviction policy to evict_normal, to compare. A
configuration is dtype:CxG (C blocks per cluster, G clusters); the default
is the split the wrappers pick.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import pathlib
import subprocess
import sys
import threading

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (exits without a card)
from repro_torch.kernels import _build, sto_step  # noqa: E402

SOURCE = ROOT / "src/repro_torch/kernels/csrc/sto_rk4.cu"
# the intervals between the kernel's PHASE_MARK(0..6)
PHASES = ("setup", "product", "csync1", "epilogue", "csync2", "tail", "grid")
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def build(l2_hints: bool) -> ctypes.CDLL:
    """sto_rk4.cu compiled with its phase marks on (-DSTO_PHASE_TIMES)."""
    out = _build.BUILD_DIR / f"sto_phase_times_{os.getpid()}"
    out.mkdir(parents=True, exist_ok=True)
    so = out / "libsto_rk4_timed.so"
    defines = ["-DSTO_PHASE_TIMES"] + ([] if l2_hints else ["-DSTO_L2_EVICT_NORMAL"])
    cmd = [_build._nvcc(), *_build.ARCH_FLAGS, *_build.NVCC_FLAGS, *defines, "-shared", "-o",
           str(so), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    args, res = _build._SIGNATURES["sto_rk4_coop"]
    lib.sto_rk4_coop.argtypes, lib.sto_rk4_coop.restype = list(args), res
    lib.sto_phase_get.argtypes = [ctypes.c_void_p]
    return lib


class ClockSampler(threading.Thread):
    """nvidia-smi's SM clock and power draw every 0.1 s until stopped."""

    def __init__(self):
        super().__init__(daemon=True)
        self.samples, self.stop = [], threading.Event()

    def run(self):
        while not self.stop.is_set():
            out = subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader,nounits"],
                capture_output=True, text=True,
            ).stdout.split(",")
            self.samples.append((float(out[0]), float(out[1])))
            self.stop.wait(0.1)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--no-l2-hints", action="store_true")
    ap.add_argument("--config", action="append", default=[], help="dtype:CxG, e.g. f32:5x22")
    opts = ap.parse_args()
    dev = torch.device("cuda")
    print(f"card: {cs.card_line()}", flush=True)
    m, w, pv, h, mask = cs.kernel_inputs(dev)
    _, n, e = m.shape
    configs = []
    for text in opts.config or []:
        name, cg = text.split(":")
        c, g = map(int, cg.split("x"))
        configs.append((DTYPES[name], c, g))
    if not configs:
        for wdt in DTYPES.values():
            split = sto_step.coop_launch_config(n, e, wdt, dev)
            configs.append((wdt, split.cluster, split.clusters))
    lib = build(not opts.no_l2_hints)
    clocks = ClockSampler()
    clocks.start()
    dt = float(cs.DT)
    for wdt, c, g in configs:
        wk = w.to(wdt)

        def run():
            m_out = m.clone()
            scratch = torch.empty((7, n, e), device=dev)
            states = torch.empty((cs.K, n, e), device=dev)
            p = sto_step._ptr
            err = lib.sto_rk4_coop(
                int(wdt == torch.bfloat16), p(pv), p(wk), p(h), n * e, p(mask), p(m_out),
                p(states), p(scratch), n, e, cs.K, cs.HOLD, dt / 2, dt, dt / 6, c, g,
                sto_step._stream(dev),
            )
            assert err == 0, f"launch failed with cudaError {err}"

        run()
        torch.cuda.synchronize()
        assert lib.sto_phase_zero() == 0
        ms = cs.time_ms(run, 1)  # one untimed and one timed run, both counted
        counters = np.zeros((1024, 8), dtype=np.uint64)
        assert lib.sto_phase_get(counters.ctypes.data) == 0
        stages = 4 * cs.HOLD * cs.K
        per = counters[: c * g, : len(PHASES)].astype(np.float64) / (2 * stages * 1e3)
        print(
            f"{str(wdt).split('.')[-1]} C={c} G={g} blocks={c * g} hints={not opts.no_l2_hints}: "
            f"{ms:.3f} ms per chunk; us per stage (mean, max over blocks): "
            + ", ".join(
                f"{ph} {per[:, i].mean():.2f} ({per[:, i].max():.2f})"
                for i, ph in enumerate(PHASES)
            ),
            flush=True,
        )
    clocks.stop.set()
    clocks.join()
    busy = [s for s in clocks.samples if s[1] > 90.0]  # above the idle draw (~73 W)
    if busy:
        mhz = sorted(s[0] for s in busy)
        print(f"SM clock under load: {len(busy)} samples, median {mhz[len(mhz) // 2]:.0f} MHz "
              f"(min {mhz[0]:.0f}), power {max(s[1] for s in busy):.1f} W at most", flush=True)


if __name__ == "__main__":
    main()
