"""How far the LM engine's tokens sit from each request run alone, per weight seed.

    python3 tools/lm_flip_stats.py [--src DIR] [--attention kernel|plain] [--seeds 0 1 2]

Imports repro_torch from DIR (default: this checkout's src/), so an older
checkout unpacked beside this one can be measured in the same call. For each
seed it builds h2o-danube-1.8b at full width with random weights from that
seed, serves chip_smoke.py's eight requests through the Engine (4 slots),
and reruns each request alone, teacher-forced on the engine's tokens, in two
geometries, through chip_smoke.teacher_forced_margins: decode at batch 1,
and decode in the engine's own geometry (slot 0 of a 4-row cache). Per
geometry it prints the steps whose chosen token is not the lone run's
argmax, the largest logit gap, and the (request, step) of each flip. A flip
at step 0 would mean a prefill that differs from its lone rerun.
`--attention plain` swaps the flash kernel for its plain version on the
card. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"), help="directory holding repro_torch")
    ap.add_argument("--attention", choices=("kernel", "plain"), default="kernel")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    opts = ap.parse_args()
    sys.path.insert(0, str(pathlib.Path(opts.src).resolve()))
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import attention, build_model
    from repro_torch.serve.engine import Engine, Request

    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs  # exits without a card

    if opts.attention == "plain":
        def plain(q, k, v, *, causal=True, window=0, scale=None):
            t = lambda x: x.transpose(1, 2)  # noqa: E731
            return t(fa.flash_attention_plain(t(q), t(k), t(v), causal, window, scale))

        attention.flash_attention_bshd = plain

    cfg = get_config(cs.LM_ARCH)
    model = build_model(cfg, device="cuda")
    rng = np.random.default_rng(0)
    reqs = [Request(i, torch.from_numpy(rng.integers(0, cfg.vocab_size, n)), cs.MAX_NEW)
            for i, n in enumerate(cs.PROMPTS)]

    for seed in opts.seeds:
        params = model.init(torch.Generator(device="cuda").manual_seed(seed))
        results = Engine(cfg, params, num_slots=cs.LM_SLOTS, capacity=cs.CAPACITY,
                         device="cuda").run(list(reqs))
        row = dict(src=opts.src, attention=opts.attention, seed=seed)
        for label, rows in (("batch_1", 1), ("engine_geometry", cs.LM_SLOTS)):
            per = {r.rid: cs.teacher_forced_margins(model, params, cfg, r, results[r.rid], rows)
                   for r in reqs}
            flips = [(rid, j) for rid, g in per.items() for j, x in enumerate(g) if x > 0]
            row[label] = dict(off=len(flips), steps=sum(map(len, per.values())),
                              worst=max(max(g) for g in per.values()), flips=flips)
        row["card"] = cs.card_line()
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
