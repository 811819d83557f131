"""The port's persisted dispatch table (kernels/dispatch_table.py) on the CPU:
save/load round trip, the v1 format's migration, a corrupt file, the lazy
load behind choose_impl, and seed_from_bench on the repo's BENCH_serve.json
against the JAX reference's.

The dispatch table is process-wide in both packages; every test here starts
from empty tables (and the reference's committed dispatch_table.cpu.json
marked as already loaded) and the fixture restores them afterwards. No
tolerance is involved: impl names are compared exactly.
"""

import json
import pathlib
import warnings

import pytest

from repro.kernels import dispatch_table as jdt
from repro.kernels import ops as jops
from repro_torch.kernels import dispatch_table, ops

BENCH = pathlib.Path(__file__).resolve().parent.parent / "BENCH_serve.json"
PRECISIONS = ("highest", "bf16_coupling", "mixed")


@pytest.fixture
def tables(monkeypatch):
    """Empty in-process tables in both packages, restored afterwards."""
    monkeypatch.setattr(ops, "_LATENCY_TABLE", {})
    monkeypatch.setattr(dispatch_table, "_LOADED", set())
    monkeypatch.setattr(jops, "_LATENCY_TABLE", {})
    # the reference lazily loads its committed CPU table: count it as loaded
    monkeypatch.setattr(jdt, "_LOADED", {"cpu"})


def _cells():
    return json.loads(BENCH.read_text())["cells"]


def test_save_load_round_trip(tables, tmp_path):
    ops.register_impl_choice(2500, 256, "tiled", platform="cuda")
    ops.register_impl_choice(2500, 256, "fused", platform="cuda", precision="bf16_coupling")
    ops.register_impl_choice(100, 5, "chunk", platform="cuda", itemsize=8)
    ops.register_impl_choice(16, 8, "ref", platform="cpu")
    path = dispatch_table.save_table(str(tmp_path / "t.json"), platform="cuda")
    payload = json.loads(pathlib.Path(path).read_text())
    assert payload["format"] == "repro-dispatch-table-v2" and payload["platform"] == "cuda"
    assert len(payload["entries"]) == 3  # the cpu entry stays out
    saved = {k: v for k, v in ops.latency_table().items() if k[0] == "cuda"}
    ops.clear_latency_table()
    assert ops.latency_table() == {}
    assert dispatch_table.load_table(path, platform="cuda") == 3
    assert ops.latency_table() == saved
    # keys round to the port's 64-wide granule
    assert ("cuda", 2560, 256, 4, "highest") in saved and ("cuda", 128, 64, 8, "highest") in saved
    assert ops.choose_impl(2500, 256, platform="cuda") == "tiled"
    assert ops.choose_impl(2500, 256, platform="cuda", precision="bf16_coupling") == "fused"
    # "mixed" was never measured: it falls back to the f32 winner
    assert ops.choose_impl(2500, 256, platform="cuda", precision="mixed") == "tiled"


def test_in_process_entries_win_unless_override(tables, tmp_path):
    ops.register_impl_choice(128, 64, "chunk", platform="cuda")
    path = dispatch_table.save_table(str(tmp_path / "t.json"), platform="cuda")
    ops.register_impl_choice(128, 64, "fused", platform="cuda")
    assert dispatch_table.load_table(path, platform="cuda") == 0
    assert ops.choose_impl(128, 64, platform="cuda") == "fused"
    assert dispatch_table.load_table(path, platform="cuda", override=True) == 1
    assert ops.choose_impl(128, 64, platform="cuda") == "chunk"


def test_v1_entries_migrate_to_highest(tables, tmp_path):
    path = tmp_path / "v1.json"
    path.write_text(json.dumps({
        "format": "repro-dispatch-table-v1",
        "platform": "cuda",
        "entries": [
            {"n_pad": 2560, "e_pad": 256, "itemsize": 4, "impl": "fused"},
            {"n_pad": 128, "e_pad": 64, "impl": "chunk"},  # itemsize defaults to 4
            {"n_pad": 64, "e_pad": 64, "itemsize": 4, "impl": "no-such-impl"},
        ],
    }))
    assert dispatch_table.load_table(str(path), platform="cuda") == 2
    assert ops.latency_table() == {
        ("cuda", 2560, 256, 4, "highest"): "fused",
        ("cuda", 128, 64, 4, "highest"): "chunk",
    }


def test_unknown_format_is_refused(tables, tmp_path):
    path = tmp_path / "v9.json"
    path.write_text(json.dumps({"format": "repro-dispatch-table-v9", "entries": []}))
    with pytest.raises(ValueError, match="unknown dispatch-table format"):
        dispatch_table.load_table(str(path), platform="cuda")


def test_ensure_loaded_is_idempotent_and_feeds_choose_impl(tables, tmp_path, monkeypatch):
    ops.register_impl_choice(2500, 256, "chunk", platform="cuda")
    dispatch_table.save_table(str(tmp_path / "dispatch_table.cuda.json"), platform="cuda")
    ops.clear_latency_table()
    monkeypatch.setattr(
        dispatch_table, "table_path",
        lambda platform=None, directory=None: str(tmp_path / f"dispatch_table.{platform}.json"),
    )
    # no table at all for the CPU: nothing registered, and not looked for again
    assert dispatch_table.ensure_loaded("cpu") == 0
    gen = ops.dispatch_generation()
    # choose_impl loads the platform's table before it reads it
    assert ops.choose_impl(2500, 256, platform="cuda") == "chunk"
    assert ops.dispatch_generation() == gen + 1
    assert dispatch_table.ensure_loaded("cuda") == 0
    assert ops.dispatch_generation() == gen + 1 and len(ops.latency_table()) == 1
    dispatch_table.reset_loaded()
    assert dispatch_table.ensure_loaded("cuda") == 0  # the in-process entry wins
    assert dispatch_table.ensure_loaded("cuda") == 0


def test_corrupt_table_warns_once_and_counts_as_missing(tables, tmp_path, monkeypatch):
    bad = tmp_path / "dispatch_table.cuda.json"
    bad.write_text("{ not json")
    monkeypatch.setattr(
        dispatch_table, "table_path",
        lambda platform=None, directory=None: str(tmp_path / f"dispatch_table.{platform}.json"),
    )
    with pytest.warns(RuntimeWarning, match="ignoring unreadable dispatch table"):
        assert dispatch_table.ensure_loaded("cuda") == 0
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert dispatch_table.ensure_loaded("cuda") == 0
        # the platform gate / L2 rule still answers
        assert ops.choose_impl(2500, 256, platform="cuda") == "tiled"
        assert ops.choose_impl(2500, 256, platform="cpu") == "ref"


def test_the_package_ships_no_table():
    here = pathlib.Path(dispatch_table.__file__).resolve().parent
    assert not list(here.glob("dispatch_table.*.json"))
    assert dispatch_table.table_path("cuda") == str(here / "dispatch_table.cuda.json")


def _winners(choose):
    return {
        (c["n"], c["e"], p): choose(c["n"], c["e"], 4, platform="cpu", precision=p)
        for c in _cells()
        for p in PRECISIONS
    }


def test_seed_from_bench_matches_the_reference_rule(tables, monkeypatch):
    """The reference's seed_from_bench run at the port's 64-wide granule
    registers the same table, and so the same winner in every cell and
    precision, as the port's."""
    monkeypatch.setattr(jops, "LANE", ops.BLOCK_N)
    assert ops.BLOCK_N == ops.BLOCK_E == 64
    n_port = dispatch_table.seed_from_bench(str(BENCH))
    n_ref = jdt.seed_from_bench(str(BENCH))
    assert n_port == n_ref > 0
    assert ops.latency_table() == jops.latency_table()
    assert _winners(ops.choose_impl) == _winners(jops.choose_impl)


def test_seed_from_bench_against_the_reference_granule(tables):
    """At the reference's own 128-wide lane, cells that one 128-wide key
    merges but two 64-wide keys keep apart may take their winner from
    another cell there. Everywhere else the two packages register the same
    winner; and where they differ, that is why."""
    dispatch_table.seed_from_bench(str(BENCH))
    jdt.seed_from_bench(str(BENCH))
    port, ref = _winners(ops.choose_impl), _winners(jops.choose_impl)

    def group(cell, granule):
        key = lambda c: (-(-c["n"] // granule), -(-c["e"] // granule))  # noqa: E731
        return {(c["n"], c["e"]) for c in _cells() if key(c) == key(cell)}

    merged = {
        (c["n"], c["e"]) for c in _cells() if group(c, 64) != group(c, jops.LANE)
    }
    differ = {(n, e) for (n, e, p) in port if port[n, e, p] != ref[n, e, p]}
    assert differ <= merged
    for (n, e, p), impl in port.items():
        if (n, e) not in merged:
            assert impl == ref[n, e, p], (n, e, p)
