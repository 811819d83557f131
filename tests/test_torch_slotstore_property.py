"""Property-based invariants for the port's serve/state_store.SlotStore: the
twin of tests/test_slotstore_property.py, the same fixed scripts and
hypothesis strategies against repro_torch's store, on the CPU, bit for bit.

The slot store is the serving engine's ground truth: whatever interleaving
of admissions, retirements, and autoscale resizes the scheduler produces,
every resident session's lane must keep exactly ITS state — magnetization
column, params column, readout row, and (learning stores) P/Wl learning
columns — and the active mask must agree with occupancy. A violated
invariant here is a cross-tenant data leak in production.

The harness drives a SlotStore and a pure-python mirror model through the
same operation script and compares bit-for-bit after every step. With
hypothesis installed (`pip install -r requirements-dev.txt`) the scripts
are drawn from the strategy below; without it those tests skip and the
deterministic replays (fixed scripts through the same harness) still run.
"""

import numpy as np
import pytest
import torch
from _hypothesis_compat import HAS_HYPOTHESIS, given, settings, st

from repro_torch.api import make_spec
from repro_torch.serve.state_store import SlotStore

E0 = 4  # initial store width
_SPEC = make_spec(3, hold_steps=2, seed=0, device="cpu")
_TEMPLATE_M = np.asarray(_SPEC.m0)


def _payload(sid: int, learn):
    """Session sid's unique, recognizable lane contents."""
    rng = np.random.default_rng(100 + sid)
    m0 = rng.standard_normal((_SPEC.n, 3)).astype(np.float32)
    a_cp = np.float32(0.1 + 0.01 * sid)
    params = _SPEC.params._replace(a_cp=torch.tensor(a_cp, dtype=_SPEC.dtype))
    w = np.full((_SPEC.n + 1, 1), float(sid), np.float32)
    if learn is None:
        return (m0, params, w, None, None), a_cp
    lw = np.full((_SPEC.n + 1, 1), sid + 0.5, np.float32)
    lp = (
        np.eye(_SPEC.n + 1, dtype=np.float32) * (sid + 1)
        if learn == "rls"
        else None
    )
    return (m0, params, w, lw, lp), a_cp


def _check(store: SlotStore, model: dict, payloads: dict, learn) -> None:
    """Every invariant, bit-for-bit, after one operation."""
    expected_mask = [s in model for s in range(store.num_slots)]
    assert np.asarray(store.active_mask).tolist() == expected_mask
    assert store.num_active == len(model)
    assert store.free_slots() == [
        s for s in range(store.num_slots) if s not in model
    ]
    w_out = np.asarray(store.w_out)
    params_e = store.params_ensemble
    wl = None if store.Wl is None else np.asarray(store.Wl)
    p = None if store.P is None else np.asarray(store.P)
    eye_reg = np.eye(store.n_state, dtype=np.float32) / store.learn_reg
    for slot in range(store.num_slots):
        if slot in model:
            (m0, _, w, lw, lp), a_cp = payloads[model[slot]]
            np.testing.assert_array_equal(
                np.asarray(store.state_column(slot)), m0
            )
            assert np.float32(params_e.a_cp[slot, 0]) == a_cp
            np.testing.assert_array_equal(w_out[slot], w)
            if learn is not None:
                np.testing.assert_array_equal(wl[slot], lw)
            if learn == "rls":
                np.testing.assert_array_equal(p[slot], lp)
        else:
            # retired / never-admitted lanes carry the template, always
            np.testing.assert_array_equal(
                np.asarray(store.state_column(slot)), _TEMPLATE_M
            )
            assert np.float32(params_e.a_cp[slot, 0]) == np.float32(
                np.asarray(_SPEC.params.a_cp)
            )
            np.testing.assert_array_equal(
                w_out[slot], np.zeros((store.n + 1, 1), np.float32)
            )
            if learn is not None:
                np.testing.assert_array_equal(
                    wl[slot], np.zeros((store.n_state, 1), np.float32)
                )
            if learn == "rls":
                np.testing.assert_array_equal(p[slot], eye_reg)


def run_script(script, learn) -> None:
    """Drive store + mirror model through (op, arg) steps, checking after
    each. Ops: 'admit' (1-2 sessions into free slots), 'retire' (1-2
    residents), 'resize' (toggle width, compacting occupied lanes low —
    exactly the engine's autoscale slot_map)."""
    store = SlotStore(_SPEC, E0, n_out=1, learn=learn)
    model: dict = {}  # slot -> sid
    payloads: dict = {}  # sid -> (payload, a_cp)
    next_sid = 0
    for op, arg in script:
        if op == "admit":
            free = store.free_slots()
            take = free[: 1 + arg % 2]
            items = []
            for slot in take:
                payloads[next_sid] = _payload(next_sid, learn)
                (m0, params, w, lw, lp), _ = payloads[next_sid]
                items.append((slot, m0, params, w, lw, lp))
                model[slot] = next_sid
                next_sid += 1
            store.admit_many(items)
        elif op == "retire":
            occupied = sorted(model)
            if not occupied:
                continue
            start = arg % len(occupied)
            victims = occupied[start : start + 1 + arg % 2]
            store.retire_many(victims)
            for slot in victims:
                del model[slot]
        elif op == "resize":
            new_e = E0 if store.num_slots != E0 else 2 * E0
            if len(model) > new_e:
                continue
            slot_map = {old: new for new, old in enumerate(sorted(model))}
            store = store.resized(new_e, slot_map)
            model = {slot_map[old]: sid for old, sid in model.items()}
        _check(store, model, payloads, learn)


# -- deterministic replays (run with or without hypothesis) -----------------

_FIXED_SCRIPTS = [
    [("admit", 1), ("admit", 0), ("retire", 0), ("admit", 1), ("resize", 0)],
    [
        ("admit", 1), ("resize", 0), ("admit", 1), ("retire", 1),
        ("admit", 0), ("resize", 0), ("retire", 0), ("admit", 1),
        ("resize", 0), ("retire", 2), ("admit", 1),
    ],
    [("retire", 0), ("resize", 0), ("resize", 1), ("admit", 1), ("admit", 1)],
    [
        ("admit", 1), ("admit", 1), ("resize", 3), ("admit", 1),
        ("retire", 3), ("retire", 1), ("resize", 0), ("admit", 0),
        ("retire", 0), ("retire", 1), ("admit", 1), ("resize", 1),
    ],
]


@pytest.mark.parametrize("learn", [None, "rls", "lms"])
@pytest.mark.parametrize("script_i", range(len(_FIXED_SCRIPTS)))
def test_fixed_interleavings_preserve_lane_session_mapping(script_i, learn):
    run_script(_FIXED_SCRIPTS[script_i], learn)


# -- hypothesis-drawn scripts (skip when hypothesis is absent) --------------

if HAS_HYPOTHESIS:
    script_strategy = st.lists(
        st.tuples(
            st.sampled_from(["admit", "retire", "resize"]),
            st.integers(min_value=0, max_value=7),
        ),
        min_size=1,
        max_size=12,
    )
else:  # the stub's @given skips these tests individually
    script_strategy = None


@settings(max_examples=25, deadline=None)
@given(script=script_strategy)
def test_arbitrary_interleavings_inference_store(script):
    run_script(script, None)


@settings(max_examples=25, deadline=None)
@given(script=script_strategy)
def test_arbitrary_interleavings_rls_store(script):
    run_script(script, "rls")


@settings(max_examples=15, deadline=None)
@given(script=script_strategy)
def test_arbitrary_interleavings_lms_store(script):
    run_script(script, "lms")
