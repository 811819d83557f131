"""Where the reservoir engine's time goes outside the kernel, for the
repro_torch package of this checkout or of another one.

    python3 tools/engine_host_trace.py [--src OTHER_CHECKOUT/src]

Runs on a machine with one CUDA card, from the root of a checkout. With
--src, `repro_torch` is imported from that directory (an older checkout's
engine) while the trace itself is chip_smoke.py's phase-3 host trace: the
512 NARMA-10 sessions at N = 2500, E = 256, K = 8, hold_steps 5, through a
chunk and a tiled engine, each run once untimed, then with spans around the
engine's boundary methods, its CompiledSim's tick_chunk, the readout and the
host copies (exclusive ms a chunk per span), then under torch.profiler
(device busy share, top host operations per span). Prints which package it
traced and the card's name and power limit.
"""

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=None, help="src/ of the checkout whose repro_torch to trace")
    args = ap.parse_args(argv)
    if args.src:
        # imported before chip_smoke puts this checkout's src/ first on the
        # path: every repro_torch submodule then resolves inside --src
        sys.path.insert(0, os.path.abspath(args.src))
        import repro_torch  # noqa: F401
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    import repro_torch

    name_power = cs.card_line()
    print(f"tracing {os.path.dirname(repro_torch.__file__)} on {name_power}", flush=True)
    cs._build.load()
    spec = cs.make_spec(cs.N, n_in=1, seed=0, hold_steps=cs.HOLD, device="cuda")
    for backend in ("chunk", "tiled"):
        _, seconds, _, _ = cs.serve(spec, backend)
        print(f"serve backend={backend}: {cs.SESSIONS / seconds:.1f} sessions/s ({name_power})",
              flush=True)
        cs.trace_engine(spec, backend, name_power)


if __name__ == "__main__":
    main()
