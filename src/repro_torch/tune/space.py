"""Search spaces over SimSpec/ExecPlan knobs, encoded for lane-vectorized
evaluation.

A `SearchSpace` maps knob names to `Float` / `LogFloat` / `Choice` domains
and owns the genotype encoding every strategy speaks: a candidate is a
point in the unit cube [0, 1]^d (one coordinate per knob, in the space's
sorted name order), and `decode` turns it into a concrete knob assignment.
Strategies never see knob semantics — random search samples the cube,
CMA-ES adapts a Gaussian on it — and the space alone knows how a
coordinate becomes a drive current or a hold_steps value.

Knob names resolve against the unified API's tunable-leaf registry
(repro_torch.api.spec / repro_torch.api.plan):

  LANE knobs    any STOParams field (current, a_cp, a_in, alpha, ...).
                These vary PER ENSEMBLE LANE of one CompiledSim — E
                candidates with different values ride ONE dispatch through
                the serving engine's per-tenant params columns. a_cp is the
                effective spectral radius (W^cp is normalized to rho = 1).
                Aliases: spectral_radius -> a_cp, drive_current -> current,
                input_gain -> a_in.
  STRUCT knobs  dt / hold_steps (SimSpec) and learn_lam / learn_reg /
                learn_mu (ExecPlan). Structural: static in the compiled
                workers, so each distinct value means a different compiled
                engine. They must be `Choice` domains — the tune driver
                groups candidates per structural combination and compiles
                one engine per group, so a continuous structural knob would
                explode the compile cache one engine per trial.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.api.plan import PLAN_TUNABLE
from repro_torch.api.spec import LANE_TUNABLE, STRUCT_TUNABLE

#: friendly name -> STOParams field
ALIASES = {
    "spectral_radius": "a_cp",
    "drive_current": "current",
    "input_gain": "a_in",
}


@dataclasses.dataclass(frozen=True)
class Float:
    """Uniform continuous domain [lo, hi]."""

    lo: float
    hi: float

    def __post_init__(self):
        if not (math.isfinite(self.lo) and math.isfinite(self.hi)):
            raise ValueError(f"Float bounds must be finite; got [{self.lo}, {self.hi}]")
        if not self.lo < self.hi:
            raise ValueError(f"Float needs lo < hi; got [{self.lo}, {self.hi}]")

    def decode(self, u: float) -> float:
        # convex form: exact at both endpoints (u=0 -> lo, u=1 -> hi)
        u = float(u)
        return (1.0 - u) * self.lo + u * self.hi


@dataclasses.dataclass(frozen=True)
class LogFloat:
    """Log-uniform continuous domain [lo, hi] (lo > 0) — the natural scale
    for knobs spanning decades (learn_reg-style regularizers, currents)."""

    lo: float
    hi: float

    def __post_init__(self):
        if not 0.0 < self.lo < self.hi:
            raise ValueError(
                f"LogFloat needs 0 < lo < hi; got [{self.lo}, {self.hi}]"
            )

    def decode(self, u: float) -> float:
        return float(
            math.exp(math.log(self.lo) + float(u) * (math.log(self.hi) - math.log(self.lo)))
        )


@dataclasses.dataclass(frozen=True)
class Choice:
    """Discrete domain: a fixed tuple of values. The only legal domain for
    structural knobs (dt, hold_steps, learn_*) — see the module docstring."""

    values: Tuple

    def __init__(self, values: Sequence):
        object.__setattr__(self, "values", tuple(values))
        if not self.values:
            raise ValueError("Choice needs at least one value")

    def decode(self, u: float):
        # u in [0, 1] -> bucket index; u == 1.0 clamps into the last bucket
        i = min(int(float(u) * len(self.values)), len(self.values) - 1)
        return self.values[i]


class SearchSpace:
    """An ordered set of named knob domains + the [0, 1]^d genotype codec.

    >>> space = SearchSpace({"current": Float(1e-3, 4e-3),
    ...                      "spectral_radius": Float(0.2, 1.2)})
    >>> space.names  # aliases resolve; sorted canonical order is the codec
    ('a_cp', 'current')
    >>> a = space.decode([1.0, 0.0])
    >>> (a["current"], a["a_cp"])
    (0.001, 1.2)
    """

    def __init__(self, knobs: Dict[str, object]):
        if not knobs:
            raise ValueError("SearchSpace needs at least one knob")
        resolved: Dict[str, object] = {}
        for name, dom in knobs.items():
            canon = ALIASES.get(name, name)
            if canon in resolved:
                raise ValueError(
                    f"duplicate knob {name!r} (resolves to {canon!r})"
                )
            if canon in LANE_TUNABLE:
                if not isinstance(dom, (Float, LogFloat, Choice)):
                    raise TypeError(
                        f"knob {name!r} domain must be Float/LogFloat/Choice; "
                        f"got {dom!r}"
                    )
            elif canon in STRUCT_TUNABLE or canon in PLAN_TUNABLE:
                if not isinstance(dom, Choice):
                    raise TypeError(
                        f"knob {name!r} is STRUCTURAL (each value is a "
                        f"separately compiled engine) and must be a Choice "
                        f"of discrete values; got {dom!r}"
                    )
            else:
                valid = sorted(
                    set(LANE_TUNABLE) | set(STRUCT_TUNABLE) | set(PLAN_TUNABLE)
                    | set(ALIASES)
                )
                raise ValueError(
                    f"unknown knob {name!r}; valid knobs: {valid}"
                )
            resolved[canon] = dom
        # sorted order pins the genotype axis assignment independent of dict
        # insertion order — trial histories stay comparable across runs
        self.knobs: Dict[str, object] = {k: resolved[k] for k in sorted(resolved)}
        self.names: Tuple[str, ...] = tuple(self.knobs)

    @property
    def dim(self) -> int:
        return len(self.names)

    def decode(self, genotype: Sequence[float]) -> Dict[str, object]:
        """[0, 1]^d point -> {knob name: concrete value}."""
        g = np.asarray(genotype, dtype=np.float64)
        if g.shape != (self.dim,):
            raise ValueError(
                f"genotype must have shape ({self.dim},) for knobs "
                f"{self.names}; got {tuple(g.shape)}"
            )
        if not ((g >= 0.0) & (g <= 1.0)).all():
            raise ValueError(f"genotype coordinates must lie in [0, 1]; got {g}")
        return {
            name: self.knobs[name].decode(g[i])
            for i, name in enumerate(self.names)
        }

    def split(
        self, assignment: Dict[str, object]
    ) -> Tuple[Dict[str, object], Dict[str, object], Dict[str, object]]:
        """Assignment -> (lane_kw, spec_struct_kw, plan_kw).

        lane_kw are STOParams overrides that ride a candidate's session
        lane; spec_struct_kw (dt/hold_steps) and plan_kw (learn_*) select
        which compiled engine the candidate groups into.
        """
        lane_kw, spec_kw, plan_kw = {}, {}, {}
        for name, value in assignment.items():
            canon = ALIASES.get(name, name)
            if canon in LANE_TUNABLE:
                lane_kw[canon] = value
            elif canon in STRUCT_TUNABLE:
                spec_kw[canon] = value
            elif canon in PLAN_TUNABLE:
                plan_kw[canon] = value
            else:  # pragma: no cover - decode() only emits known names
                raise ValueError(f"unknown knob {name!r}")
        return lane_kw, spec_kw, plan_kw

    @property
    def grid_sizes(self) -> Optional[Tuple[int, ...]]:
        """Per-knob grid cardinality when every knob is a Choice (the grid
        strategy's domain); None if any knob is continuous."""
        sizes = []
        for name in self.names:
            dom = self.knobs[name]
            if not isinstance(dom, Choice):
                return None
            sizes.append(len(dom.values))
        return tuple(sizes)

    def __repr__(self) -> str:
        inner = ", ".join(f"{k}={v!r}" for k, v in self.knobs.items())
        return f"SearchSpace({inner})"
