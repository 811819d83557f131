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
`--min-slots` and `--max-slots`; `--compilation-cache-dir DIR` builds the
CUDA kernel library into DIR and loads it from there, so a restarted server
skips nvcc. Without `--learn` every session carries one
NARMA-2 readout trained by ridge regression on the scan oracle's states;
`--learn rls|lms` makes every session an online learner of its own NARMA-2
targets instead, and `--autotune-budget B` (with `--learn`) tunes the first
tenant's `--autotune-knobs` on the live engine with B washout probes before
it streams (repro_torch.tune).

    PYTHONPATH=src python -m repro_torch.launch.serve --mode reservoir \\
        --n 16 --slots 4 --sessions 8 --ticks 20 --hold-steps 5 --device cpu

Fleet mode: `--fleet` lifts reservoir serving onto the fleet tier
(serve/fleet/): `--replicas R` engine replicas in the N-pool behind the
asyncio front end, sessions placed least-loaded, `--transport process`
putting each replica in its own OS process (on a card each child loads the
kernel library the parent built), and `--checkpoint-every K` snapshotting
live sessions every K pump rounds so a crashed replica's sessions restore
bit-identically onto a respawned one. The capacity planner calibrates from
`--bench` (BENCH_serve.json by default) only when that grid was measured on
the run's device type; otherwise admission control is off and the launcher
says so.

    PYTHONPATH=src python -m repro_torch.launch.serve --mode reservoir --fleet \\
        --replicas 2 --n 10 --slots 4 --sessions 8 --ticks 23 \\
        --transport process --checkpoint-every 2 --device cpu
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


#: default search ranges for --autotune-budget knobs (lane knobs only: a live
#: engine cannot recompile; see repro_torch.tune.washout_autotune)
AUTOTUNE_RANGES = {
    "drive_current": (0.5e-3, 4.5e-3),
    "spectral_radius": (0.2, 1.2),
    "input_gain": (0.1, 2.0),
}


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
                compilation_cache_dir=args.compilation_cache_dir,
            ),
            device=args.device,
        ),
        **autoscale_kw,
    )

    probe = None
    if args.autotune_budget:
        # washout autotune of the FIRST tenant on the live engine: probes
        # stream its washout prefix on spare lanes, the winner's knobs are
        # frozen into the session, and it queues tuned
        from repro_torch.tune import Float, SearchSpace

        knobs = [k.strip() for k in args.autotune_knobs.split(",") if k.strip()]
        bad = [k for k in knobs if k not in AUTOTUNE_RANGES]
        if bad:
            raise SystemExit(
                f"--autotune-knobs: unknown {bad}; choose from {sorted(AUTOTUNE_RANGES)}"
            )
        space = SearchSpace({k: Float(*AUTOTUNE_RANGES[k]) for k in knobs})
        tuned, sessions = sessions[0], sessions[1:]
        probe = eng.submit_autotuned(tuned, space, budget=args.autotune_budget, seed=0)

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
    if probe is not None:
        best = probe.best
        print(
            f"washout autotune: {len(probe.trials)} probes on the live engine; tenant 0 "
            "served with "
            + ", ".join(f"{k}={v:.4g}" for k, v in best.assignment.items())
            + f" (probe nmse {best.fitness:.4f}, full-stream nmse {results[0].learn_nmse:.4f})"
        )
    return results


def main_fleet(args):
    import asyncio
    import os

    from repro_torch.device import resolve_device
    from repro_torch.serve.fleet import (
        CapacityModel,
        FleetFrontend,
        FleetRouter,
        start_fleet,
        usable_cores,
    )

    device = resolve_device(args.device)
    planner = None
    bench = args.bench or "BENCH_serve.json"
    if not os.path.exists(bench):
        print(f"planner: {bench} not found — admission control disabled")
    else:
        model = CapacityModel.from_bench(bench)
        if model.platform != device.type:
            # a grid timed on another platform says nothing about this one
            print(
                f"planner: {bench} was measured on {model.platform}, not "
                f"{device.type} — admission control disabled"
            )
        else:
            planner = model
            err = planner.prediction_error()
            print(
                f"planner: calibrated from {bench} "
                f"(fit err median {err['median']:.0%} max {err['max']:.0%})"
            )

    router = FleetRouter(planner=planner, checkpoint_every=args.checkpoint_every or None)
    fleet_kw = dict(
        transport=args.transport,
        rpc_timeout_s=args.rpc_timeout,
        rpc_retries=args.rpc_retries,
        n=args.n,
        num_slots=args.slots,
        hold_steps=args.hold_steps,
        backend=args.backend,
        chunk_ticks=args.chunk_ticks,
        precision=args.precision,
        compilation_cache_dir=args.compilation_cache_dir,
        device=args.device,
    )
    replicas = start_fleet(args.replicas, **fleet_kw)

    def respawn():
        # failover replacement: same config, drawn warm through the
        # process-wide plan cache (a process replica loads the kernel
        # library the fleet built)
        (r,) = start_fleet(1, **fleet_kw)
        return r

    for r in replicas:
        router.add_replica(r, respawn=respawn if args.checkpoint_every else None)

    rng = np.random.default_rng(1)
    streams = [
        rng.uniform(0.0, 0.5, size=(args.ticks, 1)).astype(np.float32)
        for _ in range(args.sessions)
    ]

    async def serve():
        async with FleetFrontend(router) as fleet:
            t0 = time.time()
            for u in streams:
                await fleet.submit_stream(args.n, u, collect_states=False)
            results = await fleet.drain_results()
            dt = time.time() - t0
            stats = fleet.stats()[args.n]
            return results, dt, stats, fleet.fault_stats()

    results, dt, stats, faults = asyncio.run(serve())
    ticks = sum(s.session_ticks for s in stats)
    print(
        f"fleet: {args.replicas}x(N={args.n}, E={args.slots}) "
        f"transport={args.transport} cores={usable_cores()} on {device} "
        f"backend={stats[0].backend if stats else args.backend}"
    )
    if planner is not None:
        pred = planner.fleet_sessions_per_sec(args.n, args.slots, replicas=args.replicas)
        print(f"planner-predicted capacity: {pred:.1f} ref-sessions/s")
    print(
        f"served {len(results)} sessions / {ticks} session-ticks in "
        f"{dt:.2f}s ({ticks / dt:.1f} ticks/s incl. compile; per-replica "
        f"occupancy {[round(s.occupancy, 2) for s in stats]})"
    )
    if args.checkpoint_every or any(faults.values()):
        print("fault tolerance: " + ", ".join(f"{k}={v}" for k, v in sorted(faults.items())))
    return results


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
    ap.add_argument("--autotune-budget", type=int, default=0,
                    help="washout autotune of the first tenant on the live engine with this "
                         "many probe candidates (requires --learn; repro_torch.tune)")
    ap.add_argument("--autotune-knobs", default="drive_current,spectral_radius",
                    help=f"comma-separated lane knobs to search (from {sorted(AUTOTUNE_RANGES)})")
    ap.add_argument("--autoscale", action="store_true",
                    help="grow/shrink the slot count under load (QueueDepthPolicy)")
    ap.add_argument("--min-slots", type=int, default=None, help="autoscale floor (default: --slots)")
    ap.add_argument("--max-slots", type=int, default=None, help="autoscale ceiling (default: --slots)")
    ap.add_argument("--compilation-cache-dir", default=None,
                    help="directory to build the CUDA kernel library into and load it from: "
                         "a restarted server skips nvcc")
    # fleet tier (reservoir mode only)
    ap.add_argument("--fleet", action="store_true",
                    help="serve through the fleet tier (replicated engines behind the asyncio "
                         "front end)")
    ap.add_argument("--replicas", type=int, default=2, help="engine replicas in the N-pool (fleet mode)")
    ap.add_argument("--transport", choices=["local", "process"], default="local",
                    help="replica transport: in-process, or one OS process per replica (pipe, "
                         "chunk batches)")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="snapshot live fleet sessions every K router rounds (0: failover off); "
                         "a crashed replica's sessions then restore bit-identically onto a "
                         "respawned replacement")
    ap.add_argument("--rpc-timeout", type=float, default=120.0,
                    help="per-RPC reply deadline for process replicas; a hung child trips it "
                         "and is treated as dead")
    ap.add_argument("--rpc-retries", type=int, default=3,
                    help="send-side RPC retries (exponential backoff) before a process replica "
                         "is declared dead")
    ap.add_argument("--bench", default=None,
                    help="BENCH_serve.json to calibrate the capacity planner from (default: "
                         "./BENCH_serve.json if present; used only if measured on --device's type)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.autotune_budget and not args.learn:
        ap.error("--autotune-budget requires --learn (probe fitness is the learner's nmse)")
    if args.mode == "reservoir":
        if args.fleet:
            return main_fleet(args)
        return main_reservoir(args)
    if args.fleet:
        ap.error("--fleet requires --mode reservoir")
    main_lm(args)


if __name__ == "__main__":
    main()
