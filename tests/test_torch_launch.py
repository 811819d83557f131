"""The port's serving launcher on the CPU (`python -m repro_torch.launch.serve`):
--mode reservoir at N = 16 with and without --learn rls and --autoscale, the
reference options that still wait, and the LM mode's own invocation.

A reservoir run must serve every session: each result finite, every session
tick counted, and online learning's NMSE finite; no tolerance is involved.
"""

import numpy as np
import pytest
import torch

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
def test_waiting_flags_raise(flag, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP queue 1 {item}"):
        launch_serve.main(BASE + flag)


def test_lm_mode_keeps_its_invocation(capsys):
    launch_serve.main(["--arch", "h2o-danube-1.8b", "--reduced", "--requests", "2",
                       "--slots", "2", "--gen", "3", "--prompt-len", "12", "--device", "cpu"])
    assert "served 2 requests / 6 tokens" in capsys.readouterr().out
