"""Analytical capacity planner for the fleet serving tier.

Sizes replica fleets from a MODEL, not from reactive queue depth: a
roofline-flavored per-chunk cost

    t_chunk(N, E) = c0 + c1 * E + c2 * N^2*K*H + c3 * N*E*K*H + c4 * N^2*E*K*H

whose five terms are the fixed dispatch overhead, the per-lane host
assembly cost, an ensemble-independent weight-traffic term, the
elementwise/bytes term (LLGS physics, ~N*E state touched K*H times per
chunk), and the coupling-GEMM FLOPs term (the 4*2*N^2*E dipole field per
hold step — the same operand `launch/roofline.py` counts). The
coefficients are calibrated by non-negative least squares over the
measured `BENCH_serve.json` grid (relative-error weighting, so the 1 ms
N=16 cells count as much as the 2 s N=1024 cells); non-negativity keeps
every term a COST, so the model extrapolates monotonically to widths the
grid never measured. This is analytical performance modeling in the
Lumos tradition — closed-form capacity from a handful of calibrated
hardware terms — applied to the virtual-reservoir serving tier
(arXiv:2312.01121's thesis, continued past a single device).

Capacity follows from the chunk model: a replica at width E serves
E*K / t_chunk slot-ticks/sec, i.e. sessions/sec for the benchmark's
reference stream length; `learn` and reduced `precision` apply
median-ratio multipliers measured in the same grid. A FLEET of R
replicas on a host with C usable cores scales by min(R, C) — replicas
time-share cores, so scaling is linear exactly until R hits C (the
planner says so rather than pretending pipes add FLOPs).

TWO coefficient families are fit from the same grid, because the grid
records two estimators: `steady_chunk_s` (best-of-reps mid-run chunk —
the optimistic peak a warm, saturated replica can touch) and
`ticks_per_sec_burst` (full drain with admit/retire churn billed — what
a serving drain actually sustains). Peak sizes admission ceilings;
SUSTAINED predicts drain times (`drain_seconds`) and is what
`benchmarks/serve_throughput.bench_fleet` checks against measurement.
Absolute scale drifts with the host (the container's ±40% noise band,
ROADMAP caveat), so `recalibrate()` rescales both families from a cheap
same-run probe: shape offline, scale online.

`plan_fleet(workload)` inverts the model: given per-class offered load
(sessions/sec at a given N, learn, precision), it picks the replica
width and count per N-bucket with the requested headroom, and
`prediction_error()` reports how far the fit sits from the measurements
it was calibrated on — the router compares the same predictions against
live `EngineStats` at serve time.

On one CUDA card the min(R, C) scaling does not hold: R replicas there
are R host processes (or threads) that share the card's SMs, not R cores
each with its own arithmetic, so their chunks queue on one device. The
model is kept as the reference has it, the same numpy arithmetic (the same
grid gives the same coefficients); a grid measured on the card
(`BENCH_serve.json` with `backend_platform` "cuda") is what would
calibrate it for a card, and until one exists a card fleet runs with
admission control off (the launcher's `--fleet` says so).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

# replica widths the planner will propose (matches the engine's bucketed
# plan cache: powers of two keep the compile cache small)
_WIDTHS = (8, 16, 32, 64, 128, 256)


def usable_cores() -> int:
    """Cores this process may actually run on (affinity-aware)."""
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:  # non-Linux
        return os.cpu_count() or 1


def measure_probe_rates(
    pools: Sequence,
    hold_steps: int,
    chunk_ticks: int,
    stream_ticks: int,
    waves: int = 2,
    seed: int = 7,
    device="cuda",
) -> Dict[int, Dict[int, float]]:
    """Same-run probe for `recalibrate`: each (n, e) pool cell re-measured
    ONCE as sustained ticks/sec of a full churn-billed drain on a bare
    engine on `device` — the grid's own burst methodology, outside the
    fleet stack, so the planner error still bills router/replica overhead.

    Probe engines draw from the process-wide plan cache
    (`repro_torch.api.PLAN_CACHE`), so a probe that runs alongside fleet
    spin-up over the same pool shapes re-compiles nothing. The warm pass
    still executes: recalibration wants execution-speed truth. On the card
    each timed drain ends in a `torch.cuda.synchronize`. Returns the
    `{n: {e: rate}}` mapping `recalibrate` consumes."""
    import time

    from repro_torch.api import PLAN_CACHE, ExecPlan, make_spec
    from repro_torch.device import resolve_device
    from repro_torch.serve.reservoir import ReservoirEngine, StreamSession

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    probe: Dict[int, Dict[int, float]] = {}
    for n, e in pools:
        spec = make_spec(n=n, n_in=1, hold_steps=hold_steps, dtype=torch.float32, device=dev)
        eng = ReservoirEngine(
            PLAN_CACHE.get_or_compile(
                spec, ExecPlan(ensemble=e, chunk_ticks=chunk_ticks), device=dev
            ),
            max_retained=e,
        )

        def _drain(num: int, ticks: int, base_sid: int):
            sessions = [
                StreamSession(
                    sid=base_sid + i,
                    u_seq=rng.uniform(0.0, 0.5, size=(ticks, 1)).astype(
                        np.float32
                    ),
                    collect_states=False,
                )
                for i in range(num)
            ]
            t0_ticks = eng.scheduler.stats.session_ticks
            t0 = time.perf_counter()
            eng.run(sessions)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            dt = time.perf_counter() - t0
            return dt, eng.scheduler.stats.session_ticks - t0_ticks

        # warm the full admit/retire shape repertoire before timing
        _drain(waves * e, chunk_ticks, 0)
        dt, served = _drain(waves * e, stream_ticks, 600_000)
        eng.pop_results()
        probe.setdefault(n, {})[e] = served / dt
    return probe


def _nnls(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Non-negative least squares by active-set pruning: solve, drop
    negative coefficients, re-solve on the survivors. Small fixed feature
    count (5), so the loop terminates in <= 5 rounds."""
    active = list(range(x.shape[1]))
    while active:
        coef, *_ = np.linalg.lstsq(x[:, active], y, rcond=None)
        if (coef >= 0).all():
            full = np.zeros(x.shape[1])
            full[active] = coef
            return full
        active = [a for a, c in zip(active, coef) if c > 0]
    return np.zeros(x.shape[1])


@dataclasses.dataclass
class WorkloadClass:
    """One tenant class of the offered load."""

    n: int  # reservoir size
    rate: float  # offered sessions/sec
    learn: bool = False
    precision: Optional[str] = None  # None/"highest" or "mixed"/"bf16_coupling"


@dataclasses.dataclass
class ReplicaSpec:
    """One pool's sizing decision: `count` replicas of width `num_slots`."""

    n: int
    num_slots: int
    count: int
    learn: bool
    precision: Optional[str]
    sessions_per_sec: float  # predicted per-replica capacity


@dataclasses.dataclass
class FleetPlan:
    replicas: List[ReplicaSpec]
    total_capacity: float  # predicted sessions/sec across the fleet
    offered: float  # total offered sessions/sec
    headroom: float
    cores: int

    @property
    def utilization(self) -> float:
        return self.offered / max(self.total_capacity, 1e-30)


@dataclasses.dataclass
class CapacityModel:
    """sessions_per_sec(N, E, ...) calibrated from BENCH_serve.json."""

    coef: np.ndarray  # (5,) nonneg peak chunk-cost coefficients, seconds
    chunk_ticks: int
    hold_steps: int
    ref_stream_ticks: int
    platform: str
    learn_overhead: float  # median measured t_learn / t ratio (>= 1)
    precision_speedup: float  # median measured t / t_mixed ratio
    cells: List[dict]  # the grid the model was calibrated on
    # sustained family: fit on burst-drain rates (churn billed); None when
    # the grid predates the ticks_per_sec_burst column
    burst_coef: Optional[np.ndarray] = None
    # host-speed multiplier from recalibrate(): predictions assume the
    # calibration host until a same-run probe says otherwise
    host_scale: float = 1.0

    # -- calibration --------------------------------------------------------

    @staticmethod
    def _features(n, e, k: int, h: int) -> np.ndarray:
        return np.array(
            [
                np.ones_like(np.asarray(n, float)),
                np.asarray(e, float),
                np.asarray(n, float) ** 2 * k * h,
                np.asarray(n, float) * np.asarray(e, float) * k * h,
                np.asarray(n, float) ** 2 * np.asarray(e, float) * k * h,
            ]
        ).T

    @classmethod
    def from_bench(cls, bench: Union[str, dict]) -> "CapacityModel":
        """Calibrate from a BENCH_serve.json path or its parsed dict."""
        if isinstance(bench, str):
            with open(bench) as f:
                bench = json.load(f)
        cells = [c for c in bench["cells"] if "steady_chunk_s" in c]
        if len(cells) < 3:
            raise ValueError(
                f"need >= 3 measured grid cells to calibrate; got {len(cells)}"
            )
        k = int(bench["chunk_ticks"])
        h = int(bench["hold_steps"])
        x = cls._features(
            np.array([c["n"] for c in cells]),
            np.array([c["e"] for c in cells]),
            k,
            h,
        )
        y = np.array([c["steady_chunk_s"] for c in cells])
        # relative-error weighting: divide each row by its observation so
        # the fit minimizes (pred/obs - 1)^2 instead of absolute seconds
        coef = _nnls(x / y[:, None], np.ones_like(y))
        burst_coef = None
        burst = [c for c in cells if c.get("ticks_per_sec_burst")]
        if len(burst) >= 3:
            xb = cls._features(
                np.array([c["n"] for c in burst]),
                np.array([c["e"] for c in burst]),
                k,
                h,
            )
            # sustained effective chunk time: E*K ticks / drain rate
            yb = np.array(
                [c["e"] * k / c["ticks_per_sec_burst"] for c in burst]
            )
            burst_coef = _nnls(xb / yb[:, None], np.ones_like(yb))
        learn = [c["learn_overhead"] for c in cells if "learn_overhead" in c]
        mixed = [
            c["precision_speedup"] for c in cells if "precision_speedup" in c
        ]
        return cls(
            coef=coef,
            chunk_ticks=k,
            hold_steps=h,
            ref_stream_ticks=int(bench.get("ref_stream_ticks", 1)),
            platform=str(bench.get("backend_platform", "cpu")),
            learn_overhead=float(np.median(learn)) if learn else 1.0,
            precision_speedup=float(np.median(mixed)) if mixed else 1.0,
            cells=cells,
            burst_coef=burst_coef,
        )

    # -- the forward model --------------------------------------------------

    def t_chunk(
        self,
        n: int,
        e: int,
        learn: bool = False,
        precision: Optional[str] = None,
        sustained: bool = False,
    ) -> float:
        """Predicted wall seconds per K-tick chunk: the peak (steady
        mid-run) estimate by default, the sustained (churn-billed)
        estimate with `sustained=True` (falls back to peak when the grid
        had no burst column)."""
        coef = (
            self.burst_coef
            if sustained and self.burst_coef is not None
            else self.coef
        )
        t = float(
            self._features(n, e, self.chunk_ticks, self.hold_steps) @ coef
        )
        if learn:
            t *= self.learn_overhead
        if precision not in (None, "highest"):
            t /= max(self.precision_speedup, 1e-30)
        return t / max(self.host_scale, 1e-30)

    def sessions_per_sec(
        self,
        n: int,
        e: int,
        platform: Optional[str] = None,
        precision: Optional[str] = None,
        learn: bool = False,
        sustained: bool = False,
    ) -> float:
        """Predicted reference-stream sessions/sec of ONE replica at width
        E. `platform` must match the calibration platform (a model fit on
        CPU timings says nothing about a GPU fleet)."""
        if platform is not None and platform != self.platform:
            raise ValueError(
                f"model calibrated on {self.platform!r}; re-run the serve "
                f"benchmark on {platform!r} to plan for it"
            )
        ticks = e * self.chunk_ticks / self.t_chunk(
            n, e, learn, precision, sustained=sustained
        )
        return ticks / self.ref_stream_ticks

    def drain_seconds(
        self,
        n: int,
        e: int,
        sessions: int,
        stream_ticks: int,
        replicas: int = 1,
        cores: Optional[int] = None,
        **kw,
    ) -> float:
        """Predicted wall seconds for one pool to drain `sessions` streams
        of `stream_ticks` ticks — the SUSTAINED family (admit/retire churn
        billed), which is the estimator serving drains actually follow."""
        cores = usable_cores() if cores is None else cores
        rate = (
            e * self.chunk_ticks
            / self.t_chunk(n, e, sustained=True, **kw)
            * min(replicas, max(cores, 1))
        )
        return sessions * stream_ticks / rate

    def recalibrate(
        self, measured_ticks_per_sec: Dict[int, Dict[int, float]]
    ) -> float:
        """Rescale BOTH families from a same-run probe: `{n: {e: rate}}`
        of sustained ticks/sec measured NOW with the grid's own burst
        methodology. Sets `host_scale` to the median measured/modeled
        ratio (shape stays from the offline grid; absolute speed follows
        the probe) and returns it. Ratios far from 1 mean the host has
        drifted since BENCH_serve.json was recorded — exactly the
        cross-run noise the ROADMAP says not to trust."""
        self.host_scale = 1.0  # model rates at calibration scale
        ratios = [
            rate / (
                e * self.chunk_ticks / self.t_chunk(n, e, sustained=True)
            )
            for n, by_e in measured_ticks_per_sec.items()
            for e, rate in by_e.items()
        ]
        if not ratios:
            raise ValueError("probe is empty — nothing to recalibrate from")
        self.host_scale = float(np.median(ratios))
        return self.host_scale

    def fleet_sessions_per_sec(
        self,
        n: int,
        e: int,
        replicas: int,
        cores: Optional[int] = None,
        **kw,
    ) -> float:
        """Fleet capacity: replicas time-share cores, so throughput scales
        by min(replicas, cores) — linear until the host runs out. (Not on
        one card, where the replicas share its SMs: see the module
        docstring.)"""
        cores = usable_cores() if cores is None else cores
        return self.sessions_per_sec(n, e, **kw) * min(replicas, max(cores, 1))

    def degraded_fleet_sessions_per_sec(
        self,
        n: int,
        e: int,
        replicas: int,
        cores: Optional[int] = None,
        **kw,
    ) -> float:
        """Sustained capacity with ONE replica removed — the admission
        ceiling a pool should enforce while a replica is unhealthy or
        being respawned (the fleet frontend's degraded mode sheds new
        streams above it rather than queueing behind the recovery)."""
        kw.setdefault("sustained", True)
        return self.fleet_sessions_per_sec(
            n, e, replicas=max(replicas - 1, 1), cores=cores, **kw
        )

    # -- self-assessment ----------------------------------------------------

    def prediction_error(self) -> dict:
        """Relative |pred - measured| / measured on the calibration grid.

        The honest number to publish next to any plan: if the model is off
        by 20% on cells it has SEEN, trust fleet sizing to no better.
        Errors are evaluated at calibration scale (host_scale factored
        out), so recalibrating doesn't flatter or damn the fit."""
        scale = self.host_scale
        errs = {}
        errs_sustained = {}
        for c in self.cells:
            pred = self.t_chunk(c["n"], c["e"]) * scale
            errs[f"n{c['n']}_e{c['e']}"] = abs(pred - c["steady_chunk_s"]) / c[
                "steady_chunk_s"
            ]
            if self.burst_coef is not None and c.get("ticks_per_sec_burst"):
                meas = c["e"] * self.chunk_ticks / c["ticks_per_sec_burst"]
                pred = self.t_chunk(c["n"], c["e"], sustained=True) * scale
                errs_sustained[f"n{c['n']}_e{c['e']}"] = abs(pred - meas) / meas
        vals = np.array(list(errs.values()))
        out = {
            "per_cell": errs,
            "median": float(np.median(vals)),
            "max": float(vals.max()),
        }
        if errs_sustained:
            vals = np.array(list(errs_sustained.values()))
            out.update(
                per_cell_sustained=errs_sustained,
                sustained_median=float(np.median(vals)),
                sustained_max=float(vals.max()),
            )
        return out

    # -- planning -----------------------------------------------------------

    def best_width(
        self,
        n: int,
        widths: Sequence[int] = _WIDTHS,
        **kw,
    ) -> int:
        """Replica width maximizing predicted sessions/sec at this N (the
        chunk cost is dispatch-dominated at small N, so wider wins there;
        at large N the FLOPs term flattens the curve)."""
        return max(widths, key=lambda e: self.sessions_per_sec(n, e, **kw))

    def plan_fleet(
        self,
        workload: Sequence[WorkloadClass],
        headroom: float = 0.2,
        cores: Optional[int] = None,
        max_width: int = 256,
    ) -> FleetPlan:
        """Size one replica pool per workload class: the width that
        maximizes per-replica capacity, then enough replicas to cover the
        offered rate with `headroom` to spare. Replica counts are demand
        math; whether min(R, cores) lets them all run full-rate is the
        fleet-wide capacity number reported back."""
        cores = usable_cores() if cores is None else cores
        replicas: List[ReplicaSpec] = []
        offered = 0.0
        for w in workload:
            offered += w.rate
            kw = dict(learn=w.learn, precision=w.precision)
            widths = [e for e in _WIDTHS if e <= max_width]
            e = self.best_width(w.n, widths, **kw)
            cap = self.sessions_per_sec(w.n, e, **kw)
            count = max(1, math.ceil(w.rate * (1.0 + headroom) / cap))
            replicas.append(
                ReplicaSpec(
                    n=w.n,
                    num_slots=e,
                    count=count,
                    learn=w.learn,
                    precision=w.precision,
                    sessions_per_sec=cap,
                )
            )
        total_replicas = sum(r.count for r in replicas)
        share = min(total_replicas, max(cores, 1)) / max(total_replicas, 1)
        total = sum(r.count * r.sessions_per_sec for r in replicas) * share
        return FleetPlan(
            replicas=replicas,
            total_capacity=total,
            offered=offered,
            headroom=headroom,
            cores=cores,
        )
