"""Time field_tiled, rk4_tiled_step and round_bf16 of a checkout's port, on
the card.

    python3 tools/field_tiled_time.py [--src DIR]

Imports repro_torch from DIR (default: this checkout's src/), so an older
checkout unpacked beside this one can be timed in the same call, and times,
at chip_smoke.py's shapes (N = 2500 -> 2560 and 10000 -> 10048, E = 256, W
made on the card as chip_smoke.device_inputs makes it),
field_tiled at c = dt/2 for an f32 and a bf16 W, one rk4_tiled_step for
each, one hold window of HOLD tiled steps (ops.sto_rk4_tick_chunk_planes,
one tick, every lane live) and, for the bf16 W, round_bf16 on the (N, E)
x-plane with the launches of each (the hold window's launches from one
window): per call with CUDA events around one
call (chip_smoke.time_ms, which counts the host's time before the launch),
and queued back to back behind a device-side sleep (chip_smoke.queued_ms,
the card's time). Prints one JSON line per N and W type with the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
NS = (2500, 10000)  # chip_smoke.py's N and N_LARGE


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"), help="directory holding repro_torch")
    opts = ap.parse_args()
    sys.path.insert(0, str(pathlib.Path(opts.src).resolve()))
    import torch
    from repro_torch.kernels import ops, sto_step  # the checkout under test, before chip_smoke's

    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs  # exits without a card

    dev = torch.device("cuda")
    for n in NS:
        n_p = -(-n // 64) * 64
        m, w, pv, h = cs.device_inputs(n_p, n, dev)
        kprev = sto_step.field_tiled_plain(m, m[0], m, w, pv, 0.0, h)
        yx = (m[0] + 0.5 * cs.DT * kprev[0]).contiguous()
        h1 = h[None].contiguous()
        live = torch.ones((1, cs.E), dtype=torch.bool, device=dev)
        for wdt in (torch.float32, torch.bfloat16):
            wk = w.to(wdt)
            prec = "bf16_coupling" if wdt == torch.bfloat16 else None
            field = lambda: sto_step.field_tiled(m, yx, kprev, wk, pv, 0.5 * cs.DT, h_in=h)  # noqa: E731
            step = lambda: sto_step.rk4_tiled_step(m, wk, pv, cs.DT, h_in=h)  # noqa: E731
            window = lambda: ops.sto_rk4_tick_chunk_planes(  # noqa: E731
                m, w, pv, cs.DT, cs.HOLD, h1, live, impl="tiled", precision=prec
            )
            sto_step.reset_launches()
            window()
            launches = dict(sto_step.LAUNCHES)
            row = dict(
                src=opts.src,
                n=n,
                w=str(wdt).split(".")[-1],
                field_tiled_single_call_ms=cs.time_ms(field, 20),
                field_tiled_queued_ms=cs.queued_ms(field, 50)[0],
                rk4_tiled_step_single_call_ms=cs.time_ms(step, 20),
                rk4_tiled_step_queued_ms=cs.queued_ms(step, 50)[0],
                hold_window_steps=cs.HOLD,
                hold_window_single_call_ms=cs.time_ms(window, 50),
                hold_window_queued_ms=cs.queued_ms(window, 8)[0],
                hold_window_launches={k: v for k, v in launches.items() if v},
                card=cs.card_line(),
            )
            if wdt == torch.bfloat16:
                x = m[0].contiguous()
                row["round_bf16_queued_ms"] = cs.queued_ms(lambda: sto_step._round_bf16(x), 50)[0]
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
