"""The plan cache's structural-hash guard in the port (repro_torch.api.cache).

Restates tests/conformance/test_hash_guard.py's nine cases:

  1. FENCE: `spec_structural_hash` refuses (TypeError) a spec whose field
     set it does not cover.
  2. SEPARATION: specs differing ONLY in a physics field (topology tag,
     readout_window, coupling contents) hash apart, while scalar param
     VALUES (per-lane inputs) do not move the hash.

The port serves only the coupled_array family (time_multiplexed and
array_transient wait for ROADMAP queue 1 item 8), but a SimSpec of another
family can be built and hashed without running it: the family specs here
are the reference's makers restated (and each hashes as the reference's
own), and the end-to-end case checks that the port's cache keeps the
families apart and refuses to compile the unported one. No tolerance is
involved.
"""

import collections

import numpy as np
import pytest
import torch

from repro.api import make_array_transient_spec as jmake_array_transient_spec
from repro.api import make_spec as jmake_spec
from repro.api import make_time_multiplexed_spec as jmake_time_multiplexed_spec
from repro.api import spec_structural_hash as jhash
from repro_torch.api import ExecPlan, PlanCache, SimSpec, make_spec, spec_structural_hash
from repro_torch.core import constants


def _coupled(n, hold_steps, seed=0):
    return make_spec(n, hold_steps=hold_steps, seed=seed, device="cpu")


def _time_multiplexed(n_virtual, hold_steps, seed=0):
    """The reference's make_time_multiplexed_spec: a +-1 input mask from
    numpy's generator, identity feedback mixing, the paper's m0."""
    rng = np.random.default_rng(seed)
    mask = rng.choice((-1.0, 1.0), size=(n_virtual, 1))
    return SimSpec(
        constants.default_params(torch.float32, device="cpu"),
        torch.eye(n_virtual, dtype=torch.float32),
        torch.as_tensor(mask, dtype=torch.float32),
        constants.initial_magnetization(n_virtual, dtype=torch.float32, device="cpu"),
        constants.DT, hold_steps, "rk4", topology="time_multiplexed", readout_window=0,
    )


def _array_transient(n, readout_window, hold_steps):
    """The reference's make_array_transient_spec: a coupled array read over
    its last `readout_window` substeps."""
    return _coupled(n, hold_steps)._replace(
        topology="array_transient", readout_window=readout_window
    )


class TestFence:
    def test_uncovered_field_raises_typerror(self):
        """A spec with a field the hash doesn't know is rejected loudly."""
        spec = _coupled(4, 3)
        plus = collections.namedtuple("SimSpecPlus", spec._fields + ("stray_physics_knob",))
        fake = plus(*spec, 0.5)
        with pytest.raises(TypeError, match="stray_physics_knob"):
            spec_structural_hash(fake)

    def test_error_names_the_fix(self):
        spec = _coupled(4, 3)
        plus = collections.namedtuple("SimSpecPlus", spec._fields + ("zz",))
        with pytest.raises(TypeError, match="_STRUCTURAL_FIELDS"):
            spec_structural_hash(plus(*spec, None))


class TestSeparation:
    def test_families_hash_apart(self):
        """The three families over comparable shapes never share a line, and
        each hashes as the reference's spec of that family."""
        specs = {
            "coupled_array": (_coupled(6, 4), jmake_spec(6, hold_steps=4)),
            "time_multiplexed": (_time_multiplexed(6, 4), jmake_time_multiplexed_spec(6, hold_steps=4)),
            "array_transient": (
                _array_transient(6, 2, 4), jmake_array_transient_spec(6, readout_window=2, hold_steps=4)
            ),
        }
        hashes = {spec_structural_hash(port) for port, _ in specs.values()}
        assert len(hashes) == 3
        for family, (port, ref) in specs.items():
            assert spec_structural_hash(port) == jhash(ref), family

    def test_topology_tag_alone_moves_the_hash(self):
        """Same arrays, same scalars, same window: ONLY the family tag differs."""
        ca = _coupled(6, 4)
        tm = ca._replace(topology="time_multiplexed")
        assert spec_structural_hash(ca) != spec_structural_hash(tm)

    def test_readout_window_alone_moves_the_hash(self):
        a = _array_transient(6, 2, 4)
        b = _array_transient(6, 3, 4)
        assert spec_structural_hash(a) != spec_structural_hash(b)

    def test_scalar_param_values_do_not_move_the_hash(self):
        spec = _coupled(6, 4)
        tweaked = spec._replace(
            params=spec.params._replace(a_cp=torch.tensor(0.123), a_in=torch.tensor(4.56))
        )
        assert spec_structural_hash(spec) == spec_structural_hash(tweaked)

    def test_coupling_contents_move_the_hash(self):
        a = _coupled(6, 4, seed=0)
        b = _coupled(6, 4, seed=1)
        assert spec_structural_hash(a) != spec_structural_hash(b)

    def test_hash_is_host_device_agnostic(self):
        """numpy-leaved and torch-leaved twins (checkpoint transport) agree."""
        spec = _time_multiplexed(5, 3)
        host = spec._replace(
            params=type(spec.params)(*[leaf.numpy() for leaf in spec.params]),
            w_cp=spec.w_cp.numpy(),
            w_in=spec.w_in.numpy(),
            m0=spec.m0.numpy(),
        )
        assert spec_structural_hash(spec) == spec_structural_hash(host)


class TestCacheEndToEnd:
    def test_families_never_share_a_cache_line(self):
        """Two same-shape, different-family specs under one plan key to two
        cache lines; the served family compiles once and hits after, the
        unported one is refused at its compile and leaves no entry."""
        cache = PlanCache(capacity=8)
        plan = ExecPlan(impl="ref", ensemble=1, chunk_ticks=2)
        ca = _coupled(5, 3)
        tm = _time_multiplexed(5, 3)
        assert cache.key(ca, plan, "cpu") != cache.key(tm, plan, "cpu")
        sim_ca = cache.get_or_compile(ca, plan, device="cpu")
        with pytest.raises(NotImplementedError, match="item 8"):
            cache.get_or_compile(tm, plan, device="cpu")
        assert len(cache) == 1
        assert cache.stats.misses == 2 and cache.stats.hits == 0
        assert not cache.contains(tm, plan, device="cpu")
        # and the same spec again IS the cached object
        assert cache.get_or_compile(ca, plan, device="cpu") is sim_ca
        assert cache.stats.hits == 1
