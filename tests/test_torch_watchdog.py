"""End-to-end fault tolerance on the port (tests/test_watchdog.py's cases):
the watchdog restarts a crashed `repro_torch.launch.train` subprocess
(--device cpu), which resumes from its checkpoint and completes; plus the
watchdog's command line, its stall path, and the launcher's refusals."""

import os
import subprocess
import sys

import pytest
import torch

from repro_torch.launch import train as launch_train
from repro_torch.train.watchdog import run_supervised

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="2")


def _train_cmd(ckpt, *extra):
    return [
        sys.executable, "-m", "repro_torch.launch.train",
        "--arch", "h2o-danube-1.8b", "--reduced",
        "--steps", "8", "--batch", "2", "--seq", "16",
        "--ckpt-every", "2", "--ckpt-dir", str(ckpt), "--device", "cpu", *extra,
    ]


def test_watchdog_restarts_crashed_training(tmp_path):
    ckpt = tmp_path / "ckpt"
    rc = run_supervised(
        _train_cmd(ckpt, "--fail-at-step", "5"),
        heartbeat=ckpt / "heartbeat.json",
        stall_s=120.0,  # crash path, not stall path
        max_restarts=2,
        poll_s=0.2,
        env=ENV,
    )
    assert rc == 0
    # final checkpoint is the last step
    steps = sorted(d.name for d in ckpt.glob("step_*"))
    assert steps and steps[-1] == "step_00000007"


def test_watchdog_gives_up(tmp_path):
    """A command that always fails exhausts max_restarts and reports it."""
    rc = run_supervised(
        [sys.executable, "-c", "import sys; sys.exit(3)"],
        heartbeat=tmp_path / "none.json",
        stall_s=60.0,
        max_restarts=1,
        poll_s=0.05,
    )
    assert rc == 3


def test_watchdog_kills_a_stalled_run(tmp_path):
    """No heartbeat within stall_s: the run is killed (SIGKILL) and, with no
    restart left, the watchdog returns its exit code."""
    rc = run_supervised(
        [sys.executable, "-c", "import time; time.sleep(60)"],
        heartbeat=tmp_path / "none.json",
        stall_s=0.5,
        max_restarts=0,
        poll_s=0.05,
    )
    assert rc == -9


def test_watchdog_command_line_runs_the_launcher(tmp_path):
    ckpt = tmp_path / "ckpt"
    cmd = [sys.executable, "-m", "repro_torch.train.watchdog",
           "--heartbeat", str(ckpt / "heartbeat.json"), "--stall-s", "120",
           "--max-restarts", "2", "--", *_train_cmd(ckpt, "--fail-at-step", "3")]
    proc = subprocess.run(cmd, env=ENV, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "restart 1/2" in proc.stderr and "done: final loss" in proc.stdout
    assert sorted(d.name for d in ckpt.glob("step_*"))[-1] == "step_00000007"


def test_launcher_trains_and_resumes_in_process(tmp_path, capsys):
    argv = ["--arch", "h2o-danube-1.8b", "--reduced", "--steps", "3", "--batch", "2", "--seq",
            "16", "--ckpt-every", "2", "--ckpt-dir", str(tmp_path), "--device", "cpu"]
    launch_train.main(argv)
    assert "done: final loss" in capsys.readouterr().out
    launch_train.main(argv)  # the final checkpoint is at the last step
    assert "nothing to run" in capsys.readouterr().out


@pytest.mark.parametrize("argv,env,message", [
    (["--virtual-devices", "4"], {}, "no torch counterpart"),
    (["--mesh", "2x1"], {}, "torchrun's environment"),
    (["--mesh", "1x2"], {"RANK": "0", "WORLD_SIZE": "2", "LOCAL_RANK": "0"},
     "item 13b (tensor-parallel training)"),
    (["--mesh", "2x1"], {"RANK": "0", "WORLD_SIZE": "4", "LOCAL_RANK": "0"}, "needs 2 ranks"),
])
def test_launcher_refusals(argv, env, message, tmp_path, monkeypatch, capsys):
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(SystemExit) as exit_info:
        launch_train.main(["--arch", "h2o-danube-1.8b", "--reduced", "--device", "cpu",
                           "--ckpt-dir", str(tmp_path), *argv])
    assert exit_info.value.code == 2
    assert message in capsys.readouterr().err


def test_launcher_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch_train.main(["--arch", "h2o-danube-1.8b", "--reduced", "--steps", "1",
                           "--ckpt-dir", str(tmp_path)])
