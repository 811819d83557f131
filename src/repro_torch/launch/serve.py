"""Batched serving launchers. Two engines share the slot-batching idea.

LM mode (default): continuous batching on the transformer engine
(serve/engine.py). Requests stream through a fixed slot pool; finished slots
refill immediately via prefill + cache splice.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch h2o-danube-1.8b \\
        --reduced --requests 8 --slots 4 --gen 16 --device cpu

Without --reduced the model runs at its full published width (on the card:
--device cuda, the default). Weights are random, from seed 0 (torch); the
prompts are random token ids from a numpy generator seeded with 1.

Reservoir mode: the multi-tenant streaming reservoir engine
(serve/reservoir.py). Client streams are slot-batched onto the ensemble axis,
so one batched RK4 integrate advances every session per tick; `--chunk-ticks
K` serves K ticks per launch through the pipelined chunked path, and
`--autoscale` grows and shrinks the slot count under load between
`--min-slots` and `--max-slots`. Without `--learn` every session carries one
NARMA-2 readout trained by ridge regression on the scan oracle's states;
`--learn rls|lms` makes every session an online learner of its own NARMA-2
targets instead.

    PYTHONPATH=src python -m repro_torch.launch.serve --mode reservoir \\
        --n 16 --slots 4 --sessions 8 --ticks 20 --hold-steps 5 --device cpu

Not ported yet: --fleet (ROADMAP queue 1 item 11), --autotune-budget (item
10) and --compilation-cache-dir (item 9) raise.
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


def main_reservoir(args):
    from repro_torch.api import ExecPlan, compile_plan, make_spec
    from repro_torch.core import fit_ridge, tasks
    from repro_torch.serve.reservoir import ReservoirEngine, StreamSession

    spec = make_spec(
        n=args.n, n_in=1, hold_steps=args.hold_steps, dtype=torch.float32, device=args.device
    )
    rng = np.random.default_rng(1)
    if args.learn:
        # online-learning tenants: every session trains its readout on the
        # device against its own NARMA-2 targets while it streams
        sessions = []
        for i in range(args.sessions):
            u_i, y_i = tasks.narma_series(args.ticks, order=2, seed=i)
            sessions.append(
                StreamSession(
                    sid=i,
                    u_seq=u_i[:, None].astype(np.float32),
                    targets=y_i[:, None].astype(np.float32),
                    learn_washout=args.learn_washout,
                    collect_states=False,
                )
            )
    else:
        # one shared readout, trained on the scan oracle's states of a
        # NARMA-2 series
        u_tr, y_tr = tasks.narma_series(args.ticks * 4, order=2, seed=0)
        _, states_tr = compile_plan(spec, impl="scan", device=args.device).drive(
            torch.from_numpy(u_tr[:, None].astype(np.float32))
        )
        readout = fit_ridge(
            states_tr, torch.from_numpy(y_tr[:, None].astype(np.float32)).to(states_tr.device),
            washout=10, reg=1e-6,
        )
        sessions = [
            StreamSession(
                sid=i,
                u_seq=rng.uniform(0.0, 0.5, size=(args.ticks, 1)).astype(np.float32),
                readout=readout,
                collect_states=False,
            )
            for i in range(args.sessions)
        ]

    autoscale_kw = {}
    if args.autoscale:
        autoscale_kw = dict(
            autoscale=True,
            min_slots=args.min_slots or args.slots,
            max_slots=args.max_slots or args.slots,
        )
    eng = ReservoirEngine(
        compile_plan(
            spec,
            ExecPlan(
                impl=args.backend,
                ensemble=args.slots,
                measure=args.measure,
                chunk_ticks=args.chunk_ticks,
                precision=args.precision,
                learn=args.learn,
            ),
            device=args.device,
        ),
        **autoscale_kw,
    )
    t0 = time.time()
    results = eng.run(sessions)
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    dt = time.time() - t0
    st = eng.scheduler.stats
    print(
        f"backend={eng.backend} precision={eng.precision} slots={eng.num_slots} "
        f"N={args.n} hold_steps={args.hold_steps} chunk_ticks={eng.chunk_ticks}"
        + (f" learn={eng.learn}" if eng.learn else "")
        + f" on {eng.device}"
    )
    print(
        f"served {len(results)} sessions / {st.session_ticks} session-ticks in "
        f"{dt:.2f}s ({st.session_ticks / dt:.1f} ticks/s; {st.ticks} wall ticks, "
        f"occupancy {eng.scheduler.occupancy():.2f}, mean queue wait "
        f"{eng.scheduler.mean_queue_wait():.1f} ticks"
        + (
            f", grows {st.grows} shrinks {st.shrinks} cold rescales {st.cold_rescales}"
            if args.autoscale
            else ""
        )
        + ")"
    )
    if args.learn:
        nmses = [r.learn_nmse for r in results.values() if r.learn_nmse is not None]
        print(
            f"online learning: mean nmse {float(np.mean(nmses)):.4f} over {len(nmses)} tenants"
        )
    return results


# reference launcher options that are not ported yet
_WAITING_FLAGS = {
    "fleet": "--fleet (ROADMAP queue 1 item 11, the fleet)",
    "autotune_budget": "--autotune-budget (ROADMAP queue 1 item 10, tune)",
    "compilation_cache_dir": "--compilation-cache-dir (ROADMAP queue 1 item 9, plan cache)",
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", choices=["lm", "reservoir"], default="lm")
    # lm mode
    ap.add_argument("--arch", default="h2o-danube-1.8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=8)
    # reservoir mode
    ap.add_argument("--n", type=int, default=128)
    ap.add_argument("--sessions", type=int, default=16)
    ap.add_argument("--ticks", type=int, default=50)
    ap.add_argument("--hold-steps", type=int, default=20)
    ap.add_argument("--backend", default="auto")
    ap.add_argument(
        "--precision", default=None, choices=["highest", "bf16_coupling", "mixed"],
        help="numerical policy of the coupling GEMMs (default: full f32; see ExecPlan.precision)",
    )
    ap.add_argument("--measure", action="store_true",
                    help="time the backend candidates for this (N, E) first")
    ap.add_argument("--chunk-ticks", type=int, default=8,
                    help="input ticks per serving launch (pipelined chunks)")
    ap.add_argument("--learn", default=None, choices=["rls", "lms"],
                    help="online per-tenant readout learning on NARMA-2 targets (ExecPlan.learn)")
    ap.add_argument("--learn-washout", type=int, default=20,
                    help="ticks before a learner's first update")
    ap.add_argument("--autoscale", action="store_true",
                    help="grow/shrink the slot count under load (QueueDepthPolicy)")
    ap.add_argument("--min-slots", type=int, default=None, help="autoscale floor (default: --slots)")
    ap.add_argument("--max-slots", type=int, default=None, help="autoscale ceiling (default: --slots)")
    # reference options that wait for later slices
    ap.add_argument("--fleet", action="store_true", help="not ported yet")
    ap.add_argument("--autotune-budget", type=int, default=0, help="not ported yet")
    ap.add_argument("--compilation-cache-dir", default=None, help="not ported yet")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    for name, what in _WAITING_FLAGS.items():
        if getattr(args, name):
            raise NotImplementedError(f"{what} is not ported yet")
    if args.mode == "reservoir":
        return main_reservoir(args)
    main_lm(args)


if __name__ == "__main__":
    main()
