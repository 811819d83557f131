"""The port's tune subsystem (repro_torch.tune) on the CPU, against the
reference's (repro.tune).

Restates every case of tests/test_tune.py (TestSearchSpace, TestStrategies,
TestTuneSpec, TestNonPerturbation, TestWashoutAutotune) on the port, with
device="cpu" and impl="scan" at the reference's sizes (N = 24, E = 4), and
adds parity with the reference:

  - SimSpec.with_knobs / ExecPlan.with_knobs give the reference's values and
    its validation messages;
  - decode / split of the same genotypes give equal assignments;
  - each strategy, with the same seed and the same canned tells, gives
    np.array_equal genotypes (numpy on both sides: bit for bit);
  - tune_spec with grid and random gives the same assignments in the same
    trial order with the same engine keys, and washout_autotune the same
    probe assignments and the same winner. Fitness is held within
    FITNESS_RTOL in the stable grid (drive_current in {1, 2, 3} mA,
    spectral_radius in {0.3, 0.6, 0.9}) with learn_reg = 1e-2: the two
    packages' f32 states differ by float rounding, which an RLS readout
    carries into its online NMSE; at learn_reg = 1e-2 the largest gap read
    on these runs is 5.3e-6 of the NMSE (8.7e-6 on a 60-tick grid), so
    FITNESS_RTOL = 1e-4, ~10x that. At the plan's default learn_reg = 1e-6
    the inverse-Gram is ill-conditioned: the random case below differs by
    up to 11 % and another draw by 58x, so no value is compared there,
    assignments only;
  - a diverging candidate (drive current far out of range: its lane goes
    non-finite, the nan guard quarantines it before any learned tick) comes
    back as a trial with a non-finite fitness, and the strategy is told
    PENALTY_FITNESS, in both packages;
  - a session's own spec is ignored by the probes in both packages: they
    run on the template's params.
"""

import inspect

import numpy as np
import pytest
import torch

import repro.tune as jtune
from repro.api import ExecPlan as JPlan
from repro.api import compile_plan as jcompile
from repro.api import make_spec as jmake_spec
from repro.core import broadcast_params as jbroadcast
from repro.serve.reservoir import ReservoirEngine as JEngine
from repro.serve.reservoir import StreamSession as JSession
from repro_torch.api import ExecPlan, compile_plan, make_spec
from repro_torch.core.ensemble import broadcast_params
from repro_torch.core.tasks import narma_series
from repro_torch.serve.reservoir import ReservoirEngine, StreamSession
from repro_torch.tune import (
    CMAES,
    PENALTY_FITNESS,
    Choice,
    Float,
    GridSearch,
    LogFloat,
    RandomSearch,
    SearchSpace,
    Strategy,
    TuneTask,
    make_strategy,
    narma_task,
    tune_spec,
    washout_autotune,
)

torch.set_num_threads(2)

FITNESS_RTOL = 1e-4
CPU = dict(device="cpu")
STABLE = {"drive_current": (1e-3, 2e-3, 3e-3), "spectral_radius": (0.3, 0.6, 0.9)}


def _space():
    return SearchSpace({
        "drive_current": Float(0.5e-3, 4.5e-3),
        "spectral_radius": Float(0.2, 1.2),
    })


def _jspace():
    return jtune.SearchSpace({
        "drive_current": jtune.Float(0.5e-3, 4.5e-3),
        "spectral_radius": jtune.Float(0.2, 1.2),
    })


def _stable_spaces():
    return (
        SearchSpace({k: Choice(v) for k, v in STABLE.items()}),
        jtune.SearchSpace({k: jtune.Choice(v) for k, v in STABLE.items()}),
    )


def _spec(n=24):
    return make_spec(n=n, n_in=1, hold_steps=5, seed=1, **CPU)


def _jspec(n=24):
    return jmake_spec(n=n, n_in=1, hold_steps=5, seed=1)


def _plan(e=4, learn="rls", **kw):
    return ExecPlan(impl="scan", ensemble=e, chunk_ticks=8, learn=learn, **kw)


def _jplan(e=4, learn="rls", **kw):
    return JPlan(impl="scan", ensemble=e, chunk_ticks=8, learn=learn, **kw)


def _same_assignment(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k] == b[k] and type(a[k]) is type(b[k]), (k, a[k], b[k])


def _recorder(base):
    """A strategy of `base`'s package that wraps another and records every
    tell (the penalty check)."""

    class Recorder(base):
        def __init__(self, inner):
            self.inner, self.tells = inner, []
            self.space, self.name = inner.space, inner.name

        def ask(self, n):
            return self.inner.ask(n)

        def tell(self, token, fitness):
            self.tells.append((token, fitness))
            self.inner.tell(token, fitness)

        @property
        def exhausted(self):
            return self.inner.exhausted

    return Recorder


# -- the tunable registries and with_knobs -------------------------------------------


class TestKnobs:
    def test_registries_match_reference(self):
        from repro.api import LANE_TUNABLE as JL
        from repro.api import PLAN_TUNABLE as JP
        from repro.api import STRUCT_TUNABLE as JS
        from repro_torch.api import LANE_TUNABLE, PLAN_TUNABLE, STRUCT_TUNABLE

        assert (LANE_TUNABLE, STRUCT_TUNABLE, PLAN_TUNABLE) == (JL, JS, JP)

    def test_spec_with_knobs_matches_reference(self):
        knobs = dict(current=3.25e-3, a_cp=0.7, dt=5e-12, hold_steps=3)
        got, want = _spec().with_knobs(**knobs), _jspec().with_knobs(**knobs)
        assert (got.dt, got.hold_steps) == (want.dt, want.hold_steps)
        for name in got.params._fields:
            leaf = getattr(got.params, name)
            assert leaf.ndim == 0 and leaf.dtype == got.dtype and leaf.device == got.device
            assert leaf.item() == float(np.asarray(getattr(want.params, name))), name
        spec = _spec()
        assert spec.with_knobs() is spec

    @pytest.mark.parametrize("knobs", [
        dict(warp=1.0), dict(hold_steps=0), dict(hold_steps=True), dict(hold_steps=2.0),
        dict(dt=0.0), dict(learn_lam=0.9),
    ])
    def test_spec_with_knobs_refuses_like_reference(self, knobs):
        with pytest.raises(ValueError) as want:
            _jspec().with_knobs(**knobs)
        with pytest.raises(ValueError) as got:
            _spec().with_knobs(**knobs)
        assert str(got.value) == str(want.value)

    def test_spec_with_knobs_refuses_ensemble_leaves_like_reference(self):
        spec, jspec = _spec(), _jspec()
        wide = spec._replace(params=broadcast_params(spec.params, 4))
        jwide = jspec._replace(params=jbroadcast(jspec.params, 4))
        with pytest.raises(ValueError) as want:
            jwide.with_knobs(current=1e-3)
        with pytest.raises(ValueError) as got:
            wide.with_knobs(current=1e-3)
        assert str(got.value) == str(want.value)
        assert wide.with_knobs(hold_steps=2).hold_steps == 2  # structural only: fine

    def test_plan_with_knobs_matches_reference(self):
        got = _plan().with_knobs(learn_reg=1e-2, learn_lam=0.99, learn_mu=0.25)
        want = _jplan().with_knobs(learn_reg=1e-2, learn_lam=0.99, learn_mu=0.25)
        assert (got.learn_reg, got.learn_lam, got.learn_mu) == (
            want.learn_reg, want.learn_lam, want.learn_mu)
        for bad in (dict(hold_steps=2), dict(learn_lam=0.0), dict(learn_reg=-1.0)):
            with pytest.raises(ValueError) as w:
                _jplan().with_knobs(**bad)
            with pytest.raises(ValueError) as g:
                _plan().with_knobs(**bad)
            assert str(g.value) == str(w.value)


# -- tests/test_tune.py, restated on the port -----------------------------------------


class TestSearchSpace:
    def test_sorted_names_and_alias_resolution(self):
        s = _space()
        assert s.names == ("a_cp", "current")  # sorted canonical order
        assert s.dim == 2

    def test_decode_bounds(self):
        s = _space()
        lo = s.decode([0.0, 0.0])
        hi = s.decode([1.0, 1.0])
        assert lo["a_cp"] == 0.2 and hi["a_cp"] == 1.2
        assert lo["current"] == 0.5e-3 and hi["current"] == 4.5e-3

    def test_logfloat_decodes_log_uniform(self):
        s = SearchSpace({"learn_reg": Choice([1e-2]), "current": LogFloat(1e-4, 1e-2)})
        mid = s.decode([0.5, 0.5])["current"]
        assert mid == pytest.approx(1e-3, rel=1e-9)  # geometric midpoint

    def test_choice_bucket_decode_clamps_top(self):
        dom = Choice([10, 20, 30])
        assert dom.decode(0.0) == 10
        assert dom.decode(0.999) == 30
        assert dom.decode(1.0) == 30  # u = 1.0 clamps into the last bucket

    def test_structural_knob_requires_choice(self):
        with pytest.raises(TypeError, match="STRUCTURAL"):
            SearchSpace({"hold_steps": Float(1, 10)})
        with pytest.raises(TypeError, match="STRUCTURAL"):
            SearchSpace({"learn_lam": LogFloat(0.9, 1.0)})
        SearchSpace({"hold_steps": Choice([2, 4])})  # Choice is fine

    def test_unknown_knob_raises_with_valid_list(self):
        with pytest.raises(ValueError, match="valid knobs"):
            SearchSpace({"warp_factor": Float(0, 1)})

    def test_duplicate_via_alias_raises(self):
        with pytest.raises(ValueError, match="duplicate"):
            SearchSpace({"a_cp": Float(0, 1), "spectral_radius": Float(0, 1)})

    def test_split_classifies_lane_struct_plan(self):
        s = SearchSpace({
            "drive_current": Float(1e-3, 4e-3),
            "hold_steps": Choice([2, 4]),
            "learn_lam": Choice([0.99, 1.0]),
        })
        lane, spec_kw, plan_kw = s.split(s.decode([0.0, 0.0, 0.0]))
        assert set(lane) == {"current"}
        assert set(spec_kw) == {"hold_steps"}
        assert set(plan_kw) == {"learn_lam"}

    def test_genotype_validation(self):
        s = _space()
        with pytest.raises(ValueError, match="shape"):
            s.decode([0.5])
        with pytest.raises(ValueError, match=r"\[0, 1\]"):
            s.decode([0.5, 1.5])

    def test_grid_sizes(self):
        assert _space().grid_sizes is None
        s = SearchSpace({"current": Choice([1, 2]), "a_cp": Choice([1, 2, 3])})
        assert s.grid_sizes == (3, 2)  # sorted name order: a_cp, current

    def test_decode_and_split_match_reference(self):
        knobs = lambda m: {  # noqa: E731
            "drive_current": m.Float(0.5e-3, 4.5e-3),
            "input_gain": m.LogFloat(0.1, 2.0),
            "hold_steps": m.Choice([3, 5, 7]),
            "learn_reg": m.Choice([1e-4, 1e-2]),
            "alpha": m.Float(0.001, 0.01),
        }
        import repro_torch.tune as ptune

        s, js = SearchSpace(knobs(ptune)), jtune.SearchSpace(knobs(jtune))
        assert s.names == js.names and s.grid_sizes == js.grid_sizes
        rng = np.random.default_rng(11)
        genotypes = [np.zeros(s.dim), np.ones(s.dim), *rng.uniform(0, 1, (64, s.dim))]
        for g in genotypes:
            a, b = s.decode(g), js.decode(g)
            _same_assignment(a, b)
            for x, y in zip(s.split(a), js.split(b)):
                _same_assignment(x, y)


class TestStrategies:
    def test_random_is_seed_deterministic_and_budget_capped(self):
        a = RandomSearch(_space(), budget=5, seed=7)
        b = RandomSearch(_space(), budget=5, seed=7)
        ga = [g for _, g in a.ask(10)]
        gb = [g for _, g in b.ask(10)]
        assert len(ga) == 5 and a.exhausted
        np.testing.assert_array_equal(np.stack(ga), np.stack(gb))
        assert a.ask(1) == []

    def test_grid_enumerates_choice_product_exactly(self):
        s = SearchSpace({"current": Choice([1e-3, 2e-3]), "a_cp": Choice([0.3, 0.9])})
        g = GridSearch(s, budget=10)
        assert g.grid_size == 4
        out = [s.decode(geno) for _, geno in g.ask(10)]
        assert g.exhausted
        # row-major over sorted names (a_cp outer, current inner)
        assert [(o["a_cp"], o["current"]) for o in out] == [
            (0.3, 1e-3), (0.3, 2e-3), (0.9, 1e-3), (0.9, 2e-3),
        ]

    def test_tell_validates_token_and_finiteness(self):
        s = RandomSearch(_space(), budget=2, seed=0)
        (tok, _), = s.ask(1)
        with pytest.raises(KeyError):
            s.tell(tok + 99, 1.0)
        with pytest.raises(ValueError, match="finite"):
            s.tell(tok, float("nan"))
        s.tell(tok, 1.0)
        with pytest.raises(KeyError):  # double-tell
            s.tell(tok, 1.0)

    def test_cmaes_generation_buffered_ask(self):
        s = CMAES(_space(), budget=20, seed=0, popsize=4)
        first = s.ask(10)
        assert len(first) == 4  # one generation, not the full ask
        assert s.ask(10) == []  # waiting on tells
        for tok, g in first:
            s.tell(tok, float(np.sum(g**2)))
        assert len(s.ask(10)) == 4  # next generation after the update

    def test_cmaes_converges_on_quadratic_surrogate(self):
        target = np.array([0.7, 0.3])
        s = CMAES(_space(), budget=120, seed=2, popsize=8)
        best, first_gen_best = np.inf, None
        while not s.exhausted:
            batch = s.ask(8)
            for tok, g in batch:
                f = float(np.sum((g - target) ** 2))
                s.tell(tok, f)
                best = min(best, f)
            if first_gen_best is None and batch:
                first_gen_best = best
        assert best < 1e-3, f"CMA-ES best {best} did not converge"
        assert best < first_gen_best / 10

    def test_cmaes_seed_determinism(self):
        runs = []
        for _ in range(2):
            s = CMAES(_space(), budget=24, seed=5, popsize=6)
            hist = []
            while not s.exhausted:
                for tok, g in s.ask(6):
                    f = float(np.sum((g - 0.4) ** 2))
                    s.tell(tok, f)
                    hist.append((tok, f))
            runs.append(hist)
        assert runs[0] == runs[1]

    def test_make_strategy_passthrough_and_validation(self):
        s = _space()
        st = RandomSearch(s, budget=3, seed=0)
        assert make_strategy(st, s, 3) is st
        other = SearchSpace({"alpha": Float(0.001, 0.1)})
        with pytest.raises(ValueError, match="different search space"):
            make_strategy(st, other, 3)
        with pytest.raises(ValueError, match="unknown strategy"):
            make_strategy("anneal", s, 3)

    @pytest.mark.parametrize("name,kw", [
        ("random", {}), ("grid", {"points": 4}), ("cmaes", {"popsize": 6}),
        ("cmaes", {"popsize": 5, "sigma0": 0.5, "x0": np.array([0.1, 0.9])}),
    ])
    def test_genotypes_bit_identical_to_reference(self, name, kw):
        """The same seed and the same canned tells (an off-centre quadratic
        with a rank tie in every batch, and a penalty) through both packages:
        every asked genotype np.array_equal, in the same order, and the same
        exhausted flags; CMA-ES's mean, sigma and C equal too."""
        a = make_strategy(name, _space(), 40, seed=13, **kw)
        b = jtune.make_strategy(name, _jspace(), 40, seed=13, **kw)
        rounds = 0
        while not (a.exhausted and b.exhausted):
            ga, gb = a.ask(7), b.ask(7)
            assert [t for t, _ in ga] == [t for t, _ in gb]
            for (tok, x), (_, y) in zip(ga, gb):
                assert np.array_equal(x, y)
            for i, (tok, x) in enumerate(ga):
                f = PENALTY_FITNESS if i == 3 else float(np.sum((x - [0.8, 0.25]) ** 2)) // 1e-3
                a.tell(tok, f)
                b.tell(tok, f)
            assert a.exhausted == b.exhausted
            rounds += 1
            assert rounds < 100
        if name == "cmaes":
            assert np.array_equal(a.m, b.m) and a.sigma == b.sigma and np.array_equal(a.C, b.C)


class TestTuneSpec:
    def test_fixed_seed_trial_history_is_exact(self):
        spec, task = _spec(), narma_task(t=60, seed=0, learn_washout=15)
        runs = []
        for _ in range(2):
            r = tune_spec(spec, task, _space(), budget=6, plan=_plan(), seed=3, **CPU)
            runs.append([
                (t.trial_id, t.fitness, tuple(sorted(t.assignment.items())))
                for t in r.trials
            ])
        assert runs[0] == runs[1]
        assert len(runs[0]) == 6

    def test_cmaes_history_deterministic_through_engine(self):
        spec, task = _spec(), narma_task(t=60, seed=0, learn_washout=15)
        runs = []
        for _ in range(2):
            r = tune_spec(spec, task, _space(), budget=8, plan=_plan(),
                          strategy="cmaes", seed=1, popsize=4, **CPU)
            runs.append([(t.trial_id, t.fitness) for t in r.trials])
        assert runs[0] == runs[1]
        assert len(runs[0]) == 8

    def test_structural_knobs_group_engines(self):
        spec, task = _spec(), narma_task(t=40, seed=0, learn_washout=10)
        space = SearchSpace({
            "drive_current": Float(1e-3, 4e-3),
            "hold_steps": Choice([3, 5]),
        })
        r = tune_spec(spec, task, space, budget=6, plan=_plan(), seed=0, **CPU)
        keys = {t.engine_key for t in r.trials}
        assert keys <= {"hold_steps=3", "hold_steps=5"}
        assert len(keys) == 2  # 6 random draws hit both buckets w.h.p.

    def test_failed_candidates_rank_last_and_tell_penalty(self):
        spec = _spec()
        calls = []

        def score(result):
            calls.append(result.sid)
            return float("inf") if result.sid % 2 == 0 else 1.0

        task = TuneTask(u_seq=np.zeros(24, np.float32), score=score)
        r = tune_spec(spec, task, _space(), budget=4,
                      plan=ExecPlan(impl="scan", ensemble=4, chunk_ticks=8),
                      seed=0, **CPU)
        ranked = r.ranked()
        assert [t.ok for t in ranked] == [True, True, False, False]
        assert r.best.fitness == 1.0
        assert all(not np.isfinite(t.fitness) for t in ranked[2:])
        assert len(calls) == 4

    def test_rejects_ensemble_leaved_template(self):
        spec = _spec()
        wide = spec._replace(params=broadcast_params(spec.params, 4))
        with pytest.raises(ValueError, match="scalar-leaved"):
            tune_spec(wide, narma_task(t=20), _space(), budget=2, **CPU)

    def test_sequential_flag(self):
        spec, task = _spec(), narma_task(t=40, seed=0, learn_washout=10)
        r = tune_spec(spec, task, _space(), budget=2,
                      plan=ExecPlan(impl="scan", ensemble=1, chunk_ticks=8,
                                    learn="rls"), seed=0, **CPU)
        assert r.sequential and len(r.trials) == 2

    def test_task_requires_targets_or_score(self):
        with pytest.raises(ValueError, match="targets.*score|score.*targets"):
            TuneTask(u_seq=np.zeros(10))

    def test_device_defaults_to_the_card_and_passes_through(self, monkeypatch):
        """tune_spec's device defaults to "cuda" (as every entry point of the
        port); a CPU request builds every engine on the CPU."""
        assert inspect.signature(tune_spec).parameters["device"].default == "cuda"
        from repro_torch.tune import driver

        seen = []
        real = driver.PLAN_CACHE.get_or_compile

        def spy(spec, plan, device="cuda", **kw):
            sim = real(spec, plan, device=device, **kw)
            seen.append((device, sim.device.type))
            return sim

        monkeypatch.setattr(driver.PLAN_CACHE, "get_or_compile", spy)
        space = SearchSpace({"drive_current": Float(1e-3, 3e-3), "hold_steps": Choice([3, 5])})
        tune_spec(_spec(), narma_task(t=16, learn_washout=4), space, budget=4,
                  plan=_plan(), seed=0, **CPU)
        assert seen and all(s == ("cpu", "cpu") for s in seen), seen

    @pytest.mark.parametrize("strategy", ["grid", "random"])
    def test_matches_reference(self, strategy):
        """The same search through both packages: the same trial ids,
        assignments and engine keys in the same order; fitness within
        FITNESS_RTOL where it is comparable (the stable grid, learn_reg =
        1e-2); the random draw over the plan's default learn_reg compares
        assignments only (module docstring)."""
        task_kw = dict(t=48, seed=0, learn_washout=12)
        if strategy == "grid":
            space, jspace = _stable_spaces()
            plan, jplan = _plan(learn_reg=1e-2), _jplan(learn_reg=1e-2)
            budget, values = 9, True
        else:
            space = SearchSpace({"drive_current": Float(0.5e-3, 4.5e-3),
                                 "hold_steps": Choice([3, 5])})
            jspace = jtune.SearchSpace({"drive_current": jtune.Float(0.5e-3, 4.5e-3),
                                        "hold_steps": jtune.Choice([3, 5])})
            plan, jplan = _plan(), _jplan()
            budget, values = 10, False
        got = tune_spec(_spec(), narma_task(**task_kw), space, budget=budget, plan=plan,
                        strategy=strategy, seed=4, **CPU)
        want = jtune.tune_spec(_jspec(), jtune.narma_task(**task_kw), jspace, budget=budget,
                               plan=jplan, strategy=strategy, seed=4)
        assert len(got.trials) == len(want.trials) == budget
        for a, b in zip(got.trials, want.trials):
            assert (a.trial_id, a.engine_key, a.ticks) == (b.trial_id, b.engine_key, b.ticks)
            _same_assignment(a.assignment, b.assignment)
            assert np.array_equal(a.genotype, b.genotype)
            if values:
                assert a.ok and b.ok
                assert abs(a.fitness - b.fitness) <= FITNESS_RTOL * abs(b.fitness), (a, b)
        if values:
            assert got.best.trial_id == want.best.trial_id

    def test_diverging_candidate_is_penalised_like_reference(self):
        """A drive current of 1 A (400x the paper's) blows the lane up in its
        first chunk: the nan guard quarantines it with no prediction past the
        washout, so its fitness is NaN, it ranks last, and the strategy is
        told PENALTY_FITNESS; the reference does the same."""
        task_kw = dict(t=40, seed=0, learn_washout=10)
        space = SearchSpace({"drive_current": Choice([1e-3, 1.0, 2e-3])})
        jspace = jtune.SearchSpace({"drive_current": jtune.Choice([1e-3, 1.0, 2e-3])})
        strat = _recorder(Strategy)(GridSearch(space, budget=3))
        jstrat = _recorder(jtune.Strategy)(jtune.GridSearch(jspace, budget=3))
        got = tune_spec(_spec(), narma_task(**task_kw), space, plan=_plan(learn_reg=1e-2),
                        strategy=strat, budget=3, **CPU)
        want = jtune.tune_spec(_jspec(), jtune.narma_task(**task_kw), jspace,
                               plan=_jplan(learn_reg=1e-2), strategy=jstrat, budget=3)
        for res, rec in ((got, strat), (want, jstrat)):
            assert len(res.trials) == 3
            bad = [t for t in res.trials if not t.ok]
            assert [t.assignment["current"] for t in bad] == [1.0]
            assert np.isnan(bad[0].fitness) and res.ranked()[-1] is bad[0]
            assert sorted(f for _, f in rec.tells)[-1] == PENALTY_FITNESS
            assert sum(f == PENALTY_FITNESS for _, f in rec.tells) == 1
        assert [t.trial_id for t in got.trials] == [t.trial_id for t in want.trials]
        assert dict(strat.tells).keys() == dict(jstrat.tells).keys()


class TestNonPerturbation:
    def test_probe_traffic_does_not_perturb_cotenant_bitwise(self):
        """A tenant co-resident with washout-autotune probe lanes is
        bit-identical to the same tenant served alone (scan backend)."""
        spec, plan = _spec(), _plan(e=4)
        u, y = narma_series(96, order=10, seed=0)
        mk = lambda: StreamSession(  # noqa: E731
            sid=0, u_seq=u.copy(), targets=y.copy(), learn_washout=24
        )

        solo_eng = ReservoirEngine(compile_plan(spec, plan, **CPU))
        solo_eng.submit(mk())
        while solo_eng.step_chunk():
            pass
        solo = solo_eng.pop_results()[0]

        eng = ReservoirEngine(compile_plan(spec, plan, **CPU))
        eng.submit(mk())
        u2, y2 = narma_series(96, order=10, seed=5)
        tuned = StreamSession(sid=1, u_seq=u2, targets=y2, learn_washout=24)
        eng.submit_autotuned(tuned, _space(), budget=5, seed=9)
        while eng.step_chunk():
            pass
        shared = eng.pop_results()
        assert set(shared) == {0, 1}  # probe sids (negative) never leak

        assert shared[0].learn_nmse == solo.learn_nmse
        np.testing.assert_array_equal(shared[0].final_m, solo.final_m)
        np.testing.assert_array_equal(shared[0].states, solo.states)
        np.testing.assert_array_equal(
            shared[0].learned_readout.w_out.numpy(), solo.learned_readout.w_out.numpy()
        )


class TestWashoutAutotune:
    def test_end_to_end_winner_frozen_and_served(self):
        spec, plan = _spec(), _plan(e=4)
        eng = ReservoirEngine(compile_plan(spec, plan, **CPU), max_retained=3)
        u, y = narma_series(80, order=10, seed=2)
        session = StreamSession(sid=7, u_seq=u, targets=y, learn_washout=20)
        result = eng.submit_autotuned(session, _space(), budget=5, seed=0)
        assert len(result.trials) == 5
        assert all(t.engine_key == "live" for t in result.trials)
        winner = result.best.assignment
        assert float(session.params.current) == winner["current"]
        assert float(session.params.a_cp) == winner["a_cp"]
        assert eng.max_retained == 3  # restored after the probe phase
        while eng.step_chunk():
            pass
        served = eng.pop_results()
        assert set(served) == {7}
        assert np.isfinite(served[7].learn_nmse)

    def test_probe_history_is_seed_deterministic(self):
        spec, plan = _spec(), _plan(e=4)
        u, y = narma_series(80, order=10, seed=2)
        hists = []
        for _ in range(2):
            eng = ReservoirEngine(compile_plan(spec, plan, **CPU))
            s = StreamSession(sid=0, u_seq=u.copy(), targets=y.copy(), learn_washout=20)
            r = eng.submit_autotuned(s, _space(), budget=5, seed=4)
            hists.append([(t.trial_id, t.fitness) for t in r.trials])
        assert hists[0] == hists[1]

    def test_validation(self):
        spec = _spec()
        u, y = narma_series(40, order=10, seed=0)

        plain_eng = ReservoirEngine(
            compile_plan(spec, ExecPlan(impl="scan", ensemble=4, chunk_ticks=8), **CPU)
        )
        with pytest.raises(ValueError, match="learning engine"):
            plain_eng.submit_autotuned(
                StreamSession(sid=0, u_seq=u, targets=y, learn_washout=10),
                _space(), budget=2,
            )

        eng = ReservoirEngine(compile_plan(spec, _plan(e=4), **CPU))
        with pytest.raises(ValueError, match="targets"):
            eng.submit_autotuned(
                StreamSession(sid=0, u_seq=u, learn_washout=10), _space(),
                budget=2,
            )
        with pytest.raises(ValueError, match="learn_washout"):
            eng.submit_autotuned(
                StreamSession(sid=0, u_seq=u, targets=y, learn_washout=0),
                _space(), budget=2,
            )
        struct_space = SearchSpace({"hold_steps": Choice([2, 4])})
        with pytest.raises(ValueError, match="lane knobs only"):
            eng.submit_autotuned(
                StreamSession(sid=0, u_seq=u, targets=y, learn_washout=10),
                struct_space, budget=2,
            )
        with pytest.raises(ValueError, match="shorter than"):
            washout_autotune(
                eng,
                StreamSession(sid=0, u_seq=u[:5], targets=y[:5], learn_washout=10),
                _space(), budget=2,
            )

    def _both(self, session_spec=False, budget=9):
        """The stable grid probed on a live engine of each package with one
        co-tenant; returns (port result, reference result, port session,
        reference session, port results, reference results)."""
        space, jspace = _stable_spaces()
        u, y = narma_series(64, order=10, seed=2)
        u0, y0 = narma_series(48, order=10, seed=6)
        eng = ReservoirEngine(compile_plan(_spec(), _plan(learn_reg=1e-2), **CPU))
        jeng = JEngine(jcompile(_jspec(), _jplan(learn_reg=1e-2)))
        kw = dict(targets=y.copy(), learn_washout=24)
        s = StreamSession(sid=1, u_seq=u.copy(),
                          spec=_spec().with_knobs(alpha=0.01) if session_spec else None, **kw)
        js = JSession(sid=1, u_seq=u.copy(),
                      spec=_jspec().with_knobs(alpha=0.01) if session_spec else None, **kw)
        eng.submit(StreamSession(sid=0, u_seq=u0.copy(), targets=y0.copy(), learn_washout=8))
        jeng.submit(JSession(sid=0, u_seq=u0.copy(), targets=y0.copy(), learn_washout=8))
        got = eng.submit_autotuned(s, space, budget=budget, strategy="grid")
        want = jeng.submit_autotuned(js, jspace, budget=budget, strategy="grid")
        return got, want, s, js, eng.run(), jeng.run()

    def test_probes_and_winner_match_reference(self):
        """Grid probes over the stable grid: the same probe assignments in
        the same order on both packages' live engines, probe fitness within
        FITNESS_RTOL, the same winner frozen into session.params, and the
        tuned tenant and its co-tenant served by both."""
        got, want, s, js, res, jres = self._both()
        assert len(got.trials) == len(want.trials) == 9
        for a, b in zip(got.trials, want.trials):
            assert (a.trial_id, a.engine_key, a.ticks) == (b.trial_id, b.engine_key, b.ticks)
            _same_assignment(a.assignment, b.assignment)
            assert a.ok and abs(a.fitness - b.fitness) <= FITNESS_RTOL * abs(b.fitness)
        _same_assignment(got.best.assignment, want.best.assignment)
        for name in s.params._fields:
            assert float(getattr(s.params, name)) == float(np.asarray(getattr(js.params, name)))
        assert sorted(res) == sorted(jres) == [0, 1]
        for sid in (0, 1):
            assert abs(res[sid].learn_nmse - jres[sid].learn_nmse) <= FITNESS_RTOL * abs(
                jres[sid].learn_nmse)

    def test_session_spec_is_ignored_like_reference(self):
        """A tenant carrying its own spec (the template's structure, alpha
        0.01 instead of 0.005): both packages probe on the template's
        params, not the spec's, and freeze the winner over the template's,
        so the tenant then runs with the template's alpha (the reference's
        behaviour, kept): the probe history is bit-identical to the same
        tenant without a spec."""
        got, want, s, js, _, _ = self._both(session_spec=True)
        plain, _, s_plain, _, _, _ = self._both(session_spec=False)
        template_alpha = float(_spec().params.alpha)
        assert float(s.params.alpha) == template_alpha
        assert float(np.asarray(js.params.alpha)) == template_alpha
        assert [(t.trial_id, t.fitness) for t in got.trials] == [
            (t.trial_id, t.fitness) for t in plain.trials]
        for a, b in zip(got.trials, want.trials):
            _same_assignment(a.assignment, b.assignment)
        _same_assignment(got.best.assignment, want.best.assignment)
