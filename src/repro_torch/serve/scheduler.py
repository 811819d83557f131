"""Slot scheduler for the streaming reservoir engine.

A FIFO admission queue feeds a pool of ensemble-lane slots. Admission and
retirement happen between chunks — the batched integrate never stalls on a
straggler session, and a freed slot is refilled at the very next boundary.

The scheduler also keeps the load signals the autoscaler reads: occupancy
(served session-ticks over offered slot-ticks), queue depth, and queue wait
(ticks a session sat queued before admission). `AutoscalePolicy` is the
pluggable decision rule: given those signals it returns a target slot
count, which the engine rounds up to its power-of-two buckets and applies
by migrating the slot store.

Admission stays deliberately dumb (FIFO + first-free-slot): policies like
shortest-stream-first or tenant fairness plug in by overriding `pick`.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple


@dataclasses.dataclass
class SchedulerStats:
    submitted: int = 0
    admitted: int = 0
    retired: int = 0
    ticks: int = 0
    # aggregate session-ticks actually served (for throughput accounting)
    session_ticks: int = 0
    # aggregate slot-ticks offered (num_slots summed per tick) — occupancy
    # denominator; tracks resizes because num_slots is sampled per update
    slot_ticks: int = 0
    # total ticks sessions spent queued before admission
    queue_wait_ticks: int = 0
    max_queue_len: int = 0
    # autoscale events applied via remap()
    grows: int = 0
    shrinks: int = 0
    # rescale compiles: warm_rescales found the bucket's CompiledSim already
    # compiled; cold_rescales compiled it at the boundary, stalling the
    # serving loop for rescale_stall_s seconds in total
    cold_rescales: int = 0
    warm_rescales: int = 0
    rescale_stall_s: float = 0.0
    # sessions detached mid-stream (checkpoint/migration): they leave
    # without counting as retired, so occupancy stays honest
    detached: int = 0
    # tenant lanes the engine's nan guard force-retired
    quarantined_lanes: int = 0


class SlotScheduler:
    def __init__(self, num_slots: int):
        self.num_slots = num_slots
        self.queue: Deque = deque()
        self.running: Dict[int, object] = {}  # slot -> session
        self.stats = SchedulerStats()
        self._enq_tick: Dict[int, int] = {}  # id(session) -> tick at submit

    def submit(self, session) -> None:
        self.queue.append(session)
        self.stats.submitted += 1
        self._enq_tick[id(session)] = self.stats.ticks
        self.stats.max_queue_len = max(self.stats.max_queue_len, len(self.queue))

    def has_work(self) -> bool:
        return bool(self.queue) or bool(self.running)

    def pick(self) -> Optional[object]:
        """Next session to admit; override for non-FIFO policies."""
        return self.queue.popleft() if self.queue else None

    def admissions(self, free_slots: List[int]) -> List[Tuple[int, object]]:
        """Pair queued sessions with free slots (called between chunks)."""
        placed = []
        for slot in free_slots:
            session = self.pick()
            if session is None:
                break
            self.running[slot] = session
            placed.append((slot, session))
            self.stats.admitted += 1
            enq = self._enq_tick.pop(id(session), self.stats.ticks)
            self.stats.queue_wait_ticks += self.stats.ticks - enq
        return placed

    def retire(self, slot: int) -> object:
        session = self.running.pop(slot)
        self.stats.retired += 1
        return session

    def detach(self, slot: int) -> object:
        """Remove a RUNNING session without retiring it: the checkpoint /
        migration path, where the session continues elsewhere."""
        session = self.running.pop(slot)
        self.stats.detached += 1
        return session

    def remove_queued(self, session) -> bool:
        """Drop a not-yet-admitted session from the queue (migrating a
        queued session is moving it). Returns False if absent."""
        try:
            self.queue.remove(session)
        except ValueError:
            return False
        self._enq_tick.pop(id(session), None)
        self.stats.detached += 1
        return True

    def remap(self, slot_map: Dict[int, int], num_slots: int) -> None:
        """Apply an autoscale resize: running sessions move old -> new slot."""
        if num_slots > self.num_slots:
            self.stats.grows += 1
        elif num_slots < self.num_slots:
            self.stats.shrinks += 1
        self.running = {slot_map[s]: sess for s, sess in self.running.items()}
        self.num_slots = num_slots

    def on_tick(self) -> None:
        self.on_ticks(1, len(self.running))

    def on_ticks(self, n_ticks: int, session_ticks: int) -> None:
        """Account a served chunk: n_ticks wall ticks, session_ticks of
        actual per-session work (sessions may finish mid-chunk)."""
        self.stats.ticks += n_ticks
        self.stats.session_ticks += session_ticks
        self.stats.slot_ticks += n_ticks * self.num_slots

    # -- load signals ------------------------------------------------------

    def occupancy(self) -> float:
        """Served session-ticks / offered slot-ticks, lifetime aggregate."""
        return self.stats.session_ticks / max(1, self.stats.slot_ticks)

    def queue_depth(self) -> int:
        return len(self.queue)

    def mean_queue_wait(self) -> float:
        """Mean ticks an admitted session waited in the queue."""
        return self.stats.queue_wait_ticks / max(1, self.stats.admitted)


# ---------------------------------------------------------------------------
# Autoscale policies
# ---------------------------------------------------------------------------


class AutoscalePolicy:
    """Decide a target slot count from the scheduler's load signals.

    Called by the engine at every chunk boundary (after retirements, before
    admissions). Return a desired slot count in [min_slots, max_slots]; the
    engine rounds UP to its next bucket (power-of-two widths from min_slots)
    and never shrinks below the number of running sessions. Stateful
    policies (hysteresis, EWMAs) are fine: one policy instance belongs to
    one engine.
    """

    def target_slots(
        self,
        *,
        active: int,
        queued: int,
        num_slots: int,
        min_slots: int,
        max_slots: int,
    ) -> int:
        raise NotImplementedError


@dataclasses.dataclass
class QueueDepthPolicy(AutoscalePolicy):
    """Default policy: grow to cover demand, shrink on sustained idleness.

    Grow: whenever active + queued exceeds the current width, target the
    demand (the engine buckets it upward), so a burst is absorbed within
    one chunk. Shrink: only after `hysteresis` consecutive boundary checks
    with demand at or below `shrink_occupancy` of the width, so brief lulls
    between bursts do not thrash the buckets.
    """

    shrink_occupancy: float = 0.25
    hysteresis: int = 2
    _low_streak: int = dataclasses.field(default=0, repr=False)

    def target_slots(self, *, active, queued, num_slots, min_slots, max_slots):
        demand = active + queued
        if demand > num_slots:
            self._low_streak = 0
            return min(max_slots, demand)
        if num_slots > min_slots and demand <= self.shrink_occupancy * num_slots:
            self._low_streak += 1
            if self._low_streak >= self.hysteresis:
                self._low_streak = 0
                return max(min_slots, demand)
            return num_slots
        self._low_streak = 0
        return num_slots
