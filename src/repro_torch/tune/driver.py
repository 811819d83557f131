"""The tune driver: lane-vectorized hyperparameter search on the serving engine.

The ensemble axis E of ONE CompiledSim is a ready-made vectorized
population. Every candidate becomes a StreamSession whose per-tenant
STOParams lane carries its knob values, the engine slot-batches E of them
into each `tick_chunk` launch (the RK4 kernels on the card), and the online
learner (`ExecPlan.learn`) scores them as they stream: fitness is the
`learn_nmse` the engine already harvests per session, so evaluating E
candidates costs one simulation pass instead of E. Candidates re-seed lanes
at chunk boundaries through the SlotStore admit/retire path; the driver
holds no device code.

Two entry points:

  tune_spec(spec, task, space, budget, plan=..., device="cuda")
      batch search -> ranked TuneResult. Structural knobs (dt, hold_steps,
      learn_*) group candidates into one compiled engine per combination
      (SearchSpace.split), each drawn from PLAN_CACHE on `device`; lane
      knobs sweep within each engine.

  washout_autotune(engine, session, space, ...)
      the serving feature: before a learning tenant's stream starts, probe
      candidates run on the live engine over the tenant's washout prefix
      (spare lanes, negative sids, results popped before tenants see them),
      and the winner's parameters are frozen into the session, which then
      submits normally. Exposed as `ReservoirEngine.submit_autotuned`. Lane
      knobs only: a live engine cannot recompile mid-serve.

Determinism: trial ids follow submission order, finished trials are told to
the strategy in trial-id order at each harvest, and strategies are seeded,
so a fixed-seed run reproduces its trial history exactly.

A candidate that diverges (its lane quarantined by the engine's nan guard,
or a non-finite fitness) comes back as a trial with its raw fitness and is
told PENALTY_FITNESS. A kernel's build or launch error is no divergence: it
raises out of the search.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.api import PLAN_CACHE, ExecPlan, SimSpec
from repro_torch.core.constants import STOParams
from repro_torch.tune.results import Trial, TuneResult
from repro_torch.tune.space import Choice, Float, LogFloat, SearchSpace
from repro_torch.tune.strategies import make_strategy

#: fitness reported to the strategy for diverged/failed candidates — large
#: enough to rank dead last, finite so CMA-ES ranking still works
PENALTY_FITNESS = 1e9


@dataclasses.dataclass
class TuneTask:
    """What a candidate is evaluated on.

    u_seq/targets follow the serving engine's contracts ((T,) accepted for
    width 1). With targets, fitness is the ONLINE learn_nmse of the
    engine's learner — free, no extra passes. Without targets,
    `score(result) -> float` computes fitness from the harvested
    SessionResult (collect_states is forced on); use this for
    non-learning objectives (memory capacity, spectral measures, ...).
    Lower is better either way.
    """

    u_seq: np.ndarray
    targets: Optional[np.ndarray] = None
    learn_washout: int = 0
    score: Optional[Callable] = None
    name: str = ""

    def __post_init__(self):
        if self.targets is None and self.score is None:
            raise ValueError(
                "TuneTask needs targets (online-learning fitness) or a "
                "score callback (custom fitness)"
            )

    @property
    def ticks(self) -> int:
        return int(np.shape(self.u_seq)[0])


def narma_task(
    t: int = 300,
    order: int = 10,
    seed: int = 0,
    learn_washout: int = 40,
    name: str = "",
) -> TuneTask:
    """The paper's benchmark workload as a TuneTask: NARMA-`order` input/
    target series (core.tasks.narma_series), fitness = online NMSE."""
    from repro_torch.core.tasks import narma_series

    u, y = narma_series(t, order=order, seed=seed)
    return TuneTask(
        u_seq=u.astype(np.float32),
        targets=y.astype(np.float32),
        learn_washout=learn_washout,
        name=name or f"narma{order}",
    )


def _engine_key(spec_kw: Dict, plan_kw: Dict) -> str:
    """Canonical label for one structural combination (engine group)."""
    parts = [f"{k}={spec_kw[k]!r}" for k in sorted(spec_kw)]
    parts += [f"{k}={plan_kw[k]!r}" for k in sorted(plan_kw)]
    return ",".join(parts) if parts else "base"


def _candidate_fitness(result, task: TuneTask) -> float:
    """SessionResult -> scalar fitness (may be non-finite for divergence)."""
    if task.score is not None:
        return float(task.score(result))
    if result.learn_nmse is None:
        return float("nan")
    return float(result.learn_nmse)


def _host_params(params: STOParams) -> STOParams:
    """Scalar params with every leaf a Python float of the same value. A
    candidate's lane is built from these, so admitting it reads no leaf off
    the card (one sync per leaf per admission otherwise); the slot store
    rounds each float back to the store's dtype, which gives the leaf's own
    bits."""
    return STOParams(*(float(leaf) for leaf in params))


def tune_spec(
    spec: SimSpec,
    task: TuneTask,
    space: SearchSpace,
    budget: int = 32,
    plan: Optional[ExecPlan] = None,
    strategy="random",
    seed: int = 0,
    device="cuda",
    **strategy_kwargs,
) -> TuneResult:
    """Search `space` for the spec configuration that minimizes `task`
    fitness, evaluating up to ExecPlan.ensemble candidates per simulation
    pass. Returns the full ranked trial history.

    plan defaults to ExecPlan(ensemble=min(budget, 16), chunk_ticks=8);
    the ensemble width IS the search parallelism (lanes per launch), and
    ensemble=1 is the sequential per-candidate baseline. A plan without
    `learn` gets learn="rls" when the task carries targets. Structural knobs
    in the space compile one engine per value combination, each through
    PLAN_CACHE on `device` ("cuda" by default; pass device="cpu" for the
    kernels' plain versions); every engine reuses the plan's width.
    """
    if spec.params.gamma.ndim != 0:
        raise ValueError(
            "tune_spec needs a scalar-leaved template spec — candidates "
            "carry their own per-lane values"
        )
    if plan is None:
        plan = ExecPlan(ensemble=min(budget, 16), chunk_ticks=8)
    if task.targets is not None and plan.learn is None:
        plan = dataclasses.replace(plan, learn="rls")
    strat = make_strategy(strategy, space, budget, seed=seed, **strategy_kwargs)

    u_seq = np.asarray(task.u_seq)
    targets = None if task.targets is None else np.asarray(task.targets)
    collect = task.score is not None

    # structural key -> (live engine, its template params as host floats)
    engines: Dict[str, Tuple[object, STOParams]] = {}
    inflight: Dict[int, Tuple[int, Dict, str]] = {}  # sid -> (token, asgn, key)
    trials: List[Trial] = []
    next_sid = 0
    ask_batch = max(plan.ensemble, 1) * 2  # keep every lane + queue warm
    t0 = time.perf_counter()

    from repro_torch.serve.reservoir import ReservoirEngine, StreamSession

    def _get_engine(spec_kw: Dict, plan_kw: Dict, key: str):
        # one live engine per structural combo per CALL (lanes and sessions
        # are call-local state); the CompiledSim underneath comes from the
        # process-wide PLAN_CACHE, so a revisited combo, or a second
        # tune_spec call over the same space, compiles nothing
        entry = engines.get(key)
        if entry is None:
            spec_g = spec.with_knobs(**spec_kw)
            plan_g = plan.with_knobs(**plan_kw) if plan_kw else plan
            eng = ReservoirEngine(PLAN_CACHE.get_or_compile(spec_g, plan_g, device=device))
            entry = engines[key] = (eng, _host_params(eng.res.params))
        return entry

    while True:
        new = strat.ask(ask_batch)
        for token, genotype in new:
            assignment = space.decode(genotype)
            lane_kw, spec_kw, plan_kw = space.split(assignment)
            key = _engine_key(spec_kw, plan_kw)
            eng, base = _get_engine(spec_kw, plan_kw, key)
            sid = next_sid
            next_sid += 1
            eng.submit(
                StreamSession(
                    sid=sid,
                    u_seq=u_seq.copy(),
                    params=base._replace(**{k: float(v) for k, v in lane_kw.items()}),
                    targets=None if targets is None else targets.copy(),
                    learn_washout=task.learn_washout,
                    collect_states=collect,
                )
            )
            inflight[sid] = (token, assignment, key)

        progressed = False
        for eng, _ in engines.values():
            if eng.step_chunk():
                progressed = True

        finished: List[Tuple[int, object, str]] = []
        for key, (eng, _) in engines.items():
            for sid, result in eng.pop_results().items():
                finished.append((sid, result, key))
        # trial-id (submission) order — the strategies' determinism contract
        for sid, result, key in sorted(finished, key=lambda x: x[0]):
            token, assignment, _ = inflight.pop(sid)
            fitness = _candidate_fitness(result, task)
            strat.tell(token, fitness if np.isfinite(fitness) else PENALTY_FITNESS)
            trials.append(
                Trial(
                    trial_id=sid,
                    assignment=assignment,
                    fitness=fitness,
                    genotype=_genotype_from(assignment, space),
                    engine_key=key,
                    ticks=task.ticks,
                )
            )

        if strat.exhausted and not inflight:
            break
        # a harvest counts as progress even when step_chunk ran dry (the
        # engine's deferred trailing-chunk harvest lands results one
        # iteration after the last productive chunk): fresh tells mean the
        # next ask() may yield a new generation
        if not new and not progressed and not finished and not inflight:
            # the strategy owes candidates (not exhausted) but returned
            # none with nothing running: a protocol violation, not a hang
            raise RuntimeError(
                f"strategy {strat.name!r} stalled: not exhausted, nothing "
                f"in flight, and ask() returned no candidates"
            )

    return TuneResult(
        trials=trials,
        strategy=strat.name,
        space_names=space.names,
        budget=budget,
        seed=seed,
        wall_s=time.perf_counter() - t0,
        sequential=plan.ensemble == 1,
    )


def _genotype_from(assignment: Dict, space: SearchSpace) -> np.ndarray:
    """Best-effort genotype reconstruction for the trial record (the raw
    per-token genotype is strategy-internal); continuous knobs invert
    exactly, Choice knobs record the bucket midpoint."""
    g = np.empty(space.dim)
    for i, name in enumerate(space.names):
        dom = space.knobs[name]
        v = assignment[name]
        if isinstance(dom, Float):
            g[i] = (float(v) - dom.lo) / (dom.hi - dom.lo)
        elif isinstance(dom, LogFloat):
            g[i] = (np.log(float(v)) - np.log(dom.lo)) / (np.log(dom.hi) - np.log(dom.lo))
        else:
            assert isinstance(dom, Choice)
            g[i] = (dom.values.index(v) + 0.5) / len(dom.values)
    return np.clip(g, 0.0, 1.0)


# ---------------------------------------------------------------------------
# serving feature: auto-tune a tenant during its washout window
# ---------------------------------------------------------------------------


def washout_autotune(
    engine,
    session,
    space: SearchSpace,
    budget: int = 8,
    strategy="random",
    seed: int = 0,
    probe_washout: Optional[int] = None,
    **strategy_kwargs,
) -> TuneResult:
    """Tune a learning tenant's lane knobs on the LIVE engine, then submit
    the tenant with the winning parameters. Returns the probe TuneResult;
    the tuned session is queued on the engine when this returns.

    The probes stream the tenant's washout prefix (u_seq/targets rows
    [0, learn_washout)) as ordinary learning sessions with NEGATIVE sids on
    spare lanes of the engine itself: admitted, scored by the learner,
    retired and popped out of `engine.results` before any caller sees them.
    Their params are the session's `params`, else the engine template's;
    a session's own `spec` is not consulted, so the probes run the
    template's physics. Co-resident tenants keep streaming through the same
    launches; their lanes are independent columns. Lane knobs only:
    structural knobs need a recompile, which a live engine cannot do.
    """
    from repro_torch.core.reservoir import coerce_input_series
    from repro_torch.serve.reservoir import StreamSession
    from repro_torch.serve.state_store import _host

    if engine.learn is None:
        raise ValueError(
            "washout_autotune needs a learning engine (ExecPlan.learn) — "
            "probe fitness is the learner's online NMSE"
        )
    if session.targets is None:
        raise ValueError(
            f"session {session.sid}: washout_autotune needs a learning "
            f"session (targets) — the washout prefix is the probe workload"
        )
    w = session.learn_washout
    if not isinstance(w, int) or isinstance(w, bool) or w < 2:
        raise ValueError(
            f"session {session.sid}: learn_washout ({w!r}) is the tuning "
            f"window — it must be an int >= 2 ticks"
        )
    for name in space.names:
        _, spec_kw, plan_kw = space.split({name: None})
        if spec_kw or plan_kw:
            raise ValueError(
                f"washout_autotune tunes lane knobs only (a live engine "
                f"cannot recompile); {name!r} is structural — use "
                f"tune_spec for structural searches"
            )

    dtype = engine.store.np_dtype
    u = coerce_input_series(session.u_seq, engine.store.n_in, dtype, xp=np)
    y = _host(session.targets).astype(dtype)
    if y.ndim == 1:
        y = y[:, None]
    if u.shape[0] < w or y.shape[0] < w:
        raise ValueError(
            f"session {session.sid}: stream shorter than its learn_washout "
            f"({w}) — nothing to probe on"
        )
    probe_u, probe_y = u[:w], y[:w]
    pw = max(1, w // 4) if probe_washout is None else probe_washout
    if not 0 <= pw < w:
        raise ValueError(f"probe_washout must be in [0, {w}); got {pw}")

    strat = make_strategy(strategy, space, budget, seed=seed, **strategy_kwargs)
    base_params = session.params if session.params is not None else engine.res.params
    probe_base = _host_params(base_params)

    # probe sids: negative, engine-unique, invisible to tenant numbering
    probe_sid = getattr(engine, "_tune_probe_sid", 0)
    # probe results must survive until they are popped, whatever max_retained is
    saved_retained, engine.max_retained = engine.max_retained, None

    inflight: Dict[int, Tuple[int, Dict]] = {}
    trials: List[Trial] = []
    order = 0
    t0 = time.perf_counter()
    try:
        while True:
            new = strat.ask(max(engine.num_slots, 1))
            for token, genotype in new:
                assignment = space.decode(genotype)
                lane_kw, _, _ = space.split(assignment)
                probe_sid -= 1
                engine.submit(
                    StreamSession(
                        sid=probe_sid,
                        u_seq=probe_u.copy(),
                        params=probe_base._replace(
                            **{k: float(v) for k, v in lane_kw.items()}
                        ),
                        targets=probe_y.copy(),
                        learn_washout=pw,
                        collect_states=False,
                    )
                )
                inflight[probe_sid] = (token, assignment)

            progressed = engine.step_chunk()

            done = [sid for sid in list(engine.results) if sid in inflight]
            # negative sids: descending sid order is submission order
            for sid in sorted(done, reverse=True):
                result = engine.results.pop(sid)
                token, assignment = inflight.pop(sid)
                fitness = (
                    float(result.learn_nmse) if result.learn_nmse is not None else float("nan")
                )
                strat.tell(token, fitness if np.isfinite(fitness) else PENALTY_FITNESS)
                trials.append(
                    Trial(
                        trial_id=order,
                        assignment=assignment,
                        fitness=fitness,
                        genotype=_genotype_from(assignment, space),
                        engine_key="live",
                        ticks=w,
                    )
                )
                order += 1

            if strat.exhausted and not inflight:
                break
            if not new and not progressed and not done and not inflight:
                raise RuntimeError(f"strategy {strat.name!r} stalled during washout autotune")
    finally:
        engine.max_retained = saved_retained
        engine._tune_probe_sid = probe_sid

    result = TuneResult(
        trials=trials,
        strategy=strat.name,
        space_names=space.names,
        budget=budget,
        seed=seed,
        wall_s=time.perf_counter() - t0,
    )
    winner_lane_kw, _, _ = space.split(result.best.assignment)
    session.params = base_params._replace(**{k: float(v) for k, v in winner_lane_kw.items()})
    engine.submit(session)
    return result
