"""Time the delay-line kernel of a checkout's port, on the card.

    python3 tools/delay_line_time.py [--src DIR]

Imports repro_torch from DIR (default: this checkout's src/), so an older
checkout unpacked beside this one can be timed in the same call (run it in
the order parent, this, this, parent), and times sto_step.tm_delay_line at
chip_smoke.py's 3f(a) shape (one tick, N = 2500, E = 256, hold_steps 5,
chip_smoke.delay_line_inputs): per call with CUDA events around one call
(chip_smoke.time_ms) and queued back to back behind a device-side sleep
(chip_smoke.queued_ms, the card's time). Prints one JSON line with the
card's name and power limit and the SM clock nvidia-smi reads after the
runs.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"), help="directory holding repro_torch")
    opts = ap.parse_args()
    sys.path.insert(0, str(pathlib.Path(opts.src).resolve()))
    import torch
    from repro_torch.kernels import sto_step  # the checkout under test, before chip_smoke's

    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs  # exits without a card

    m, pv, h = cs.delay_line_inputs(cs.N, torch.device("cuda"), seed=2)
    kern = lambda: sto_step.tm_delay_line(m, h, pv, cs.DT, cs.HOLD)  # noqa: E731
    row = dict(
        src=opts.src,
        single_call_ms=cs.time_ms(kern, 5),
        queued_ms=cs.queued_ms(kern, 6)[0],
        card=cs.card_line(),
        clocks_sm_mhz=subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip(),
    )
    print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
