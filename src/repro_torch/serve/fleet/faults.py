"""Deterministic fault injection for the fleet tier.

Every failure path the supervision/failover layer claims to handle —
replica crash, hung child, delayed or dropped RPC, a tenant lane going
non-finite — is exercised by TESTS, not hoped for. A `FaultPlan` is a
frozen schedule of `Fault` events threaded through the replica
transports (`LocalReplica(faults=...)` / `ProcessReplica(faults=...)`);
the plan is pure data (pickles into a spawned child unchanged), and a
`FaultRuntime` holds the mutable firing counters, one per transport
side, so parent and child each consume their own events:

- `crash` / `hang` fire in the replica's serving loop when its served
  chunk counter reaches `at_chunk` (child side: `os._exit` /
  sleep-without-replying; local transport: both fail-stop — there is no
  pipe to hang).
- `delay` / `drop` fire on the parent's transport send path for the
  matching RPC `op`, `count` times: delay sleeps `delay_s` before the
  send; drop discards the request BEFORE it reaches the pipe, which is
  what makes the retry-with-backoff path deterministic (the child never
  sees the dropped request, so a retry cannot double-execute it).
- `nan` poisons one input row of session `sid` at submit time (the row
  becomes NaN before the engine coerces it), driving the engine's lane
  quarantine without touching any co-tenant lane.

Determinism is the contract: the same plan produces the same firing
sequence every run, and `FaultPlan.random(seed)` builds the same
schedule for the same seed (tests/test_torch_fleet_faults.py pins both).
The plan is plain numpy and scalars; on a CUDA fleet it still only ever
touches host data (a session's input stream is host numpy by the engine's
contract).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serve.state_store import _host

FAULT_KINDS = ("crash", "hang", "delay", "drop", "nan")

#: exit code a fault-injected child crashes with (visible in the
#: ReplicaError a parent raises after detecting the death)
CRASH_EXIT_CODE = 57


@dataclasses.dataclass(frozen=True)
class Fault:
    """One scheduled failure event.

    kind      one of FAULT_KINDS.
    at_chunk  crash/hang trigger: fire when the replica's served-chunk
              counter reaches this value (0 = before the first chunk).
    op        delay/drop: which RPC op to hit ("*" = any op).
    count     delay/drop: how many sends are affected before the fault
              is spent.
    delay_s   delay: seconds added before the matching send.
    sid       nan: the target session id.
    tick      nan: the input row poisoned at submit.
    """

    kind: str
    at_chunk: int = 0
    op: str = "*"
    count: int = 1
    delay_s: float = 0.0
    sid: Optional[int] = None
    tick: int = 0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"fault kind must be one of {FAULT_KINDS}; got {self.kind!r}"
            )
        if not isinstance(self.at_chunk, int) or isinstance(self.at_chunk, bool) or self.at_chunk < 0:
            raise ValueError(f"at_chunk must be an int >= 0; got {self.at_chunk!r}")
        if not isinstance(self.count, int) or isinstance(self.count, bool) or self.count < 1:
            raise ValueError(f"count must be an int >= 1; got {self.count!r}")
        if self.delay_s < 0:
            raise ValueError(f"delay_s must be >= 0; got {self.delay_s!r}")
        if self.kind == "delay" and self.delay_s == 0:
            raise ValueError("a delay fault needs delay_s > 0")
        if self.kind == "nan":
            if self.sid is None:
                raise ValueError("a nan fault needs a target sid")
            if not isinstance(self.tick, int) or isinstance(self.tick, bool) or self.tick < 0:
                raise ValueError(f"tick must be an int >= 0; got {self.tick!r}")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A frozen, deterministic schedule of faults for one replica.

    Construct explicitly from `Fault` events, or draw a reproducible
    schedule from a seed via `FaultPlan.random(seed)`. The plan itself
    never mutates; call `runtime()` for the per-transport-side firing
    state (parent and child each hold their own runtime, so a plan
    pickled into a spawned child fires its child-side events exactly
    once regardless of what the parent consumed)."""

    faults: Tuple[Fault, ...] = ()
    seed: int = 0

    def __post_init__(self):
        object.__setattr__(self, "faults", tuple(self.faults))
        for f in self.faults:
            if not isinstance(f, Fault):
                raise TypeError(f"FaultPlan takes Fault events; got {f!r}")

    @classmethod
    def random(
        cls,
        seed: int,
        *,
        n_faults: int = 3,
        kinds: Tuple[str, ...] = ("delay", "drop"),
        ops: Tuple[str, ...] = ("run_for", "stats"),
        max_delay_s: float = 0.02,
        max_count: int = 2,
        max_chunk: int = 8,
    ) -> "FaultPlan":
        """A reproducible schedule: the same seed yields the same plan."""
        rng = np.random.default_rng(seed)
        faults: List[Fault] = []
        for _ in range(n_faults):
            kind = kinds[int(rng.integers(len(kinds)))]
            if kind in ("crash", "hang"):
                faults.append(Fault(kind, at_chunk=int(rng.integers(max_chunk))))
            elif kind == "delay":
                faults.append(
                    Fault(
                        "delay",
                        op=ops[int(rng.integers(len(ops)))],
                        count=int(rng.integers(1, max_count + 1)),
                        delay_s=float(rng.uniform(1e-4, max_delay_s)),
                    )
                )
            elif kind == "drop":
                faults.append(
                    Fault(
                        "drop",
                        op=ops[int(rng.integers(len(ops)))],
                        count=int(rng.integers(1, max_count + 1)),
                    )
                )
            else:  # nan
                faults.append(
                    Fault("nan", sid=int(rng.integers(64)), tick=int(rng.integers(16)))
                )
        return cls(faults=tuple(faults), seed=seed)

    def runtime(self) -> "FaultRuntime":
        return FaultRuntime(self)


class FaultRuntime:
    """Mutable firing state over one FaultPlan (one per transport side)."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._chunks = 0  # replica-side served-chunk counter
        # remaining fire budget per delay/drop event (index into plan.faults)
        self._remaining: Dict[int, int] = {
            i: f.count
            for i, f in enumerate(plan.faults)
            if f.kind in ("delay", "drop")
        }
        self._fired_chunk_events: set = set()
        self.delays_fired = 0
        self.drops_fired = 0

    # -- replica (serving-loop) side ----------------------------------------

    def on_chunk(self) -> Optional[str]:
        """Called before each chunk the replica serves; returns "crash" or
        "hang" when a scheduled event's at_chunk is reached (each event
        fires once), else None. Increments the chunk counter."""
        action = None
        for i, f in enumerate(self.plan.faults):
            if (
                f.kind in ("crash", "hang")
                and i not in self._fired_chunk_events
                and self._chunks >= f.at_chunk
            ):
                self._fired_chunk_events.add(i)
                action = f.kind
                break
        self._chunks += 1
        return action

    def poison_session(self, session) -> None:
        """Apply scheduled nan injections to a session at submit time: the
        matching input row is replaced with NaN (on a private copy — the
        caller's array is never mutated)."""
        ticks = [
            f.tick
            for f in self.plan.faults
            if f.kind == "nan" and f.sid == session.sid
        ]
        if not ticks:
            return
        u = np.array(_host(session.u_seq), copy=True)
        for t in ticks:
            if t < u.shape[0]:
                u[t] = np.nan
        session.u_seq = u

    # -- transport (parent send-path) side ----------------------------------

    def before_send(self, op: str) -> Tuple[bool, float]:
        """Consult the plan before sending RPC `op`: returns
        (drop_this_send, seconds_of_injected_delay). Each matching
        delay/drop event decrements its remaining count."""
        drop = False
        delay = 0.0
        for i, f in enumerate(self.plan.faults):
            if f.kind not in ("delay", "drop") or self._remaining.get(i, 0) <= 0:
                continue
            if f.op != "*" and f.op != op:
                continue
            self._remaining[i] -= 1
            if f.kind == "delay":
                delay += f.delay_s
                self.delays_fired += 1
            else:
                drop = True
                self.drops_fired += 1
        return drop, delay
