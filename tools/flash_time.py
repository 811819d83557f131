"""Time the flash-attention kernel of a checkout's port, on the card.

    python3 tools/flash_time.py [--src DIR]

Imports repro_torch from DIR (default: this checkout's src/), so an older
checkout unpacked beside this one can be timed in the same call, and times
flash_attention_bshd at chip_smoke.py's row-4 shape (h2o-danube-1.8b's
prefill: B = 1, H = 32, KVH = 8, D = 80, Sq = Sk = 4608, causal, window
4096, bf16), at that shape without the window (row 4b) and at gemma-7b's
(H = KVH = 16, D = 256, Sq = Sk = 4096, causal; row 4c, skipped where the
checkout's kernel refuses head dim 256): per call with CUDA events around
one call (chip_smoke.time_ms) and queued back to back behind a device-side
sleep (chip_smoke.queued_ms, the card's time). Prints one JSON line per
shape with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
# (label, heads, kv heads, head dim, Sq = Sk, window)
SHAPES = (
    ("row 4", 32, 8, 80, 4608, 4096),
    ("row 4b", 32, 8, 80, 4608, 0),
    ("row 4c", 16, 16, 256, 4096, 0),
)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"), help="directory holding repro_torch")
    opts = ap.parse_args()
    sys.path.insert(0, str(pathlib.Path(opts.src).resolve()))
    import torch
    from repro_torch.kernels import flash_attention as fa  # the checkout under test

    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs  # exits without a card

    dev = torch.device("cuda")
    for label, h, kvh, d, s, window in SHAPES:
        g = torch.Generator(device=dev).manual_seed(s + d)
        q = torch.randn((1, s, h, d), generator=g, device=dev).to(torch.bfloat16)
        k = torch.randn((1, s, kvh, d), generator=g, device=dev).to(torch.bfloat16)
        v = torch.randn((1, s, kvh, d), generator=g, device=dev).to(torch.bfloat16)
        call = lambda: fa.flash_attention_bshd(q, k, v, causal=True, window=window)  # noqa: E731
        row = dict(src=opts.src, shape=label, heads=h, kv_heads=kvh, head_dim=d, seq=s,
                   window=window)
        try:
            call()
        except NotImplementedError as err:
            row["skipped"] = str(err)
        else:
            row.update(single_call_ms=cs.time_ms(call, 20), queued_ms=cs.queued_ms(call, 50)[0])
        row["card"] = cs.card_line()
        print(json.dumps(row), flush=True)
        del q, k, v
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
