"""Training watchdog: supervise a training subprocess, restart on crash or
heartbeat stall (the reference's train/watchdog.py; pure Python, the port
keeps its own copy).

This is the host-side half of the fault-tolerance story (the in-process
half is the atomic checkpoint + resume in train_loop.py). On a real fleet
the cluster scheduler plays this role per host; the logic is identical:

  - launch the training command,
  - watch the heartbeat file the loop writes every step,
  - if the process dies OR the heartbeat stalls past `stall_s` (hung host,
    straggler), kill and relaunch — the relaunch resumes from the latest
    checkpoint automatically,
  - give up after `max_restarts` (page a human).

Usage:
    python -m repro_torch.train.watchdog --heartbeat CKPT_DIR/heartbeat.json \
        --stall-s 120 --max-restarts 3 -- \
        python -m repro_torch.launch.train --arch h2o-danube-1.8b --reduced \
        --ckpt-dir CKPT_DIR ...
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import List, Optional


def run_supervised(
    cmd: List[str],
    heartbeat: Path,
    stall_s: float = 120.0,
    max_restarts: int = 3,
    poll_s: float = 1.0,
    env: Optional[dict] = None,
) -> int:
    """Returns the final exit code (0 = training completed)."""
    restarts = 0
    while True:
        proc = subprocess.Popen(cmd, env=env)
        last_beat = time.time()
        killed_for_stall = False
        while True:
            ret = proc.poll()
            if ret is not None:
                break
            if heartbeat.exists():
                try:
                    beat = json.loads(heartbeat.read_text())
                    last_beat = max(last_beat, float(beat.get("t", 0)))
                except (ValueError, OSError):
                    pass  # mid-write; keep the previous beat
            if time.time() - last_beat > stall_s:
                # straggler/hang: fence and relaunch
                proc.send_signal(signal.SIGKILL)
                proc.wait()
                killed_for_stall = True
                ret = -9
                break
            time.sleep(poll_s)

        if ret == 0:
            return 0
        restarts += 1
        print(
            f"[watchdog] training {'stalled' if killed_for_stall else 'died'} "
            f"(exit {ret}); restart {restarts}/{max_restarts}",
            file=sys.stderr,
        )
        if restarts > max_restarts:
            print("[watchdog] giving up", file=sys.stderr)
            return ret if ret else 1


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--heartbeat", default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt",
                                                        "heartbeat.json"))
    ap.add_argument("--stall-s", type=float, default=120.0)
    ap.add_argument("--max-restarts", type=int, default=3)
    ap.add_argument("cmd", nargs=argparse.REMAINDER,
                    help="-- followed by the training command")
    args = ap.parse_args()
    cmd = args.cmd[1:] if args.cmd and args.cmd[0] == "--" else args.cmd
    assert cmd, "pass the training command after --"
    raise SystemExit(
        run_supervised(cmd, Path(args.heartbeat), args.stall_s, args.max_restarts)
    )


if __name__ == "__main__":
    main()
