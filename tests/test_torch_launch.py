"""The port's serving launcher on the CPU (`python -m repro_torch.launch.serve`):
--mode reservoir at N = 16 with and without --learn rls and --autoscale, the
reference options that once waited and are served since (--fleet,
--compilation-cache-dir, --autotune-budget), and the LM mode's own
invocation.

A reservoir run must serve every session: each result finite, every session
tick counted, and online learning's NMSE finite; no tolerance is involved.
"""

import json

import numpy as np
import pytest
import torch

from repro_torch.api import cache
from repro_torch.kernels import _build
from repro_torch.launch import serve as launch_serve

torch.set_num_threads(2)

BASE = ["--mode", "reservoir", "--n", "16", "--slots", "4", "--sessions", "6", "--ticks", "12",
        "--hold-steps", "3", "--chunk-ticks", "4", "--device", "cpu"]


@pytest.mark.parametrize("extra", [
    [],
    ["--backend", "chunk"],
    ["--learn", "rls", "--learn-washout", "3"],
    ["--autoscale", "--min-slots", "2", "--max-slots", "8"],
    ["--learn", "rls", "--learn-washout", "3", "--autoscale", "--min-slots", "2", "--max-slots", "8"],
])
def test_reservoir_mode_serves_every_session(capsys, extra):
    results = launch_serve.main(BASE + extra)
    out = capsys.readouterr().out
    assert sorted(results) == list(range(6))
    assert "served 6 sessions / 72 session-ticks" in out and "on cpu" in out
    learning = "--learn" in extra
    for r in results.values():
        assert r.error is None and np.isfinite(r.final_m).all()
        if learning:
            assert r.predictions.shape == (12, 1) and np.isfinite(r.learn_nmse)
        else:
            assert r.outputs.shape == (2, 1) and np.isfinite(r.outputs).all()  # washout 10
    assert ("online learning: mean nmse" in out) == learning
    if "--autoscale" in extra:
        assert "grows 1 shrinks" in out and "slots=" in out
    if "--backend" in extra:
        assert "backend=chunk" in out


@pytest.mark.parametrize("flag,item", [
    (["--fleet"], "item 11"),
    (["--autotune-budget", "4"], "item 10"),
    (["--compilation-cache-dir", "cache"], "item 9"),
])
def test_waiting_flags_raise(flag, item, tmp_path, monkeypatch, capsys):
    if flag[0] == "--fleet":
        # served since the fleet (item 11): two local replicas behind the
        # front end, failover on; the planner calibrates from the committed
        # CPU grid on --device cpu, and from a grid measured on another
        # platform not at all
        fleet = flag + ["--replicas", "2", "--checkpoint-every", "2"]
        results = launch_serve.main(BASE + fleet)
        out = capsys.readouterr().out
        assert sorted(results) == list(range(1, 7))  # the router's sids
        assert all(r.error is None and np.isfinite(r.final_m).all() for r in results.values())
        assert "planner: calibrated from BENCH_serve.json" in out
        assert "planner-predicted capacity" in out
        assert "served 6 sessions / 72 session-ticks" in out and "on cpu" in out
        assert "replica_deaths=0" in out and "sessions_lost=0" in out
        bench = json.loads(open("BENCH_serve.json").read())
        bench["backend_platform"] = "cuda"
        other = tmp_path / "bench_cuda.json"
        other.write_text(json.dumps(bench))
        launch_serve.main(BASE + fleet + ["--bench", str(other)])
        out = capsys.readouterr().out
        assert (f"planner: {other} was measured on cuda, not cpu — admission control "
                "disabled") in out
        assert "planner-predicted capacity" not in out
        assert "served 6 sessions" in out
        return
    if flag[0] == "--autotune-budget":
        # served since tune (item 10): the first tenant is tuned by four
        # washout probes on the live engine, then served with the winner
        results = launch_serve.main(BASE + ["--learn", "rls", "--learn-washout", "3"] + flag)
        out = capsys.readouterr().out
        assert sorted(results) == list(range(6))
        assert all(r.error is None and np.isfinite(r.learn_nmse) for r in results.values())
        assert "washout autotune: 4 probes on the live engine; tenant 0 served with a_cp=" in out
        return
    if flag[0] == "--compilation-cache-dir":
        # served since the plan cache (item 9): the flag reaches the plan,
        # which pins the kernel library's build directory (process-wide
        # state, restored afterwards)
        monkeypatch.setattr(_build, "_PINNED_DIR", None)
        monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
        where = tmp_path / flag[1]
        results = launch_serve.main(BASE + [flag[0], str(where)])
        assert sorted(results) == list(range(6))
        assert cache.persistent_cache_dir() == str(where) and where.is_dir()
        return
    raise AssertionError(f"unexpected flag {flag}")


def test_lm_mode_keeps_its_invocation(capsys):
    launch_serve.main(["--arch", "h2o-danube-1.8b", "--reduced", "--requests", "2",
                       "--slots", "2", "--gen", "3", "--prompt-len", "12", "--device", "cpu"])
    assert "served 2 requests / 6 tokens" in capsys.readouterr().out


def test_autotune_flags_are_validated():
    """The reference's checks: --autotune-budget needs --learn, and an
    unknown --autotune-knobs name stops the launcher."""
    with pytest.raises(SystemExit):
        launch_serve.main(BASE + ["--autotune-budget", "4"])
    with pytest.raises(SystemExit, match="unknown"):
        launch_serve.main(BASE + ["--learn", "rls", "--learn-washout", "3", "--autotune-budget", "4",
                                  "--autotune-knobs", "drive_current,warp"])
