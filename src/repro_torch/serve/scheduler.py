"""Slot scheduler for the streaming reservoir engine.

A FIFO admission queue feeds a pool of ensemble-lane slots. Admission and
retirement happen between chunks — the batched integrate never stalls on a
straggler session, and a freed slot is refilled at the very next boundary.

The scheduler also keeps the load signals: occupancy (served session-ticks
over offered slot-ticks), queue depth, and queue wait (ticks a session sat
queued before admission). Autoscale policies are not ported yet (ROADMAP
queue 1 item 7).

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
    # denominator
    slot_ticks: int = 0
    # total ticks sessions spent queued before admission
    queue_wait_ticks: int = 0
    max_queue_len: int = 0
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
