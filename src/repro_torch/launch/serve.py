"""Batched LM serving launcher: continuous batching on the transformer
engine (serve/engine.py). Requests stream through a fixed slot pool;
finished slots refill immediately via prefill + cache splice.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch h2o-danube-1.8b \\
        --reduced --requests 8 --slots 4 --gen 16 --device cpu

Without --reduced the model runs at its full published width (on the card:
--device cuda, the default). Weights are random, from seed 0 (torch); the
prompts are random token ids from a numpy generator seeded with 1.

Only the reference launcher's LM mode is ported: --mode reservoir raises
(drive repro_torch.serve.reservoir.ReservoirEngine directly).
"""

import argparse
import time

import numpy as np
import torch


def main_lm(args):
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.models import build_model
    from repro_torch.serve.engine import Engine, Request

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_config(cfg)
    params = build_model(cfg, device=args.device).init(0)
    rng = np.random.default_rng(1)
    reqs = []
    for i in range(args.requests):
        # ragged prompt lengths exercise the scheduler
        length = args.prompt_len - (i % 4)
        reqs.append(Request(i, torch.from_numpy(rng.integers(0, cfg.vocab_size, length)), args.gen))

    capacity = args.prompt_len + args.gen
    eng = Engine(cfg, params, num_slots=args.slots, capacity=capacity, device=args.device)
    t0 = time.time()
    results = eng.run(reqs)
    dt = time.time() - t0
    total_toks = sum(len(v) for v in results.values())
    for rid in sorted(results):
        print(f"  req{rid}: {results[rid]}")
    print(
        f"served {len(results)} requests / {total_toks} tokens in {dt:.2f}s "
        f"({total_toks / dt:.1f} tok/s) with {args.slots} slots on {eng.device}"
    )


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", choices=["lm", "reservoir"], default="lm")
    ap.add_argument("--arch", default="h2o-danube-1.8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.mode == "reservoir":
        raise NotImplementedError(
            "--mode reservoir in the port's launcher (ROADMAP queue 1 item 7); "
            "drive repro_torch.serve.reservoir.ReservoirEngine directly"
        )
    main_lm(args)


if __name__ == "__main__":
    main()
