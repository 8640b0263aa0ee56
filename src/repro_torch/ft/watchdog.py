"""Heartbeat watchdog: straggler and failure detection.

Controllers (training loops, pod tenants, data workers, and the serving
cluster's split-mode replica threads — see ``repro_torch.serve.cluster``, which
beats one lane per replica scheduling iteration and re-homes a dead
replica's live requests onto survivors) register lanes and beat every
step. The watchdog thread classifies lanes:

* ``ok``        — beat within `straggler_after`
* ``straggler`` — stale beyond `straggler_after` (mitigation hook fires:
  e.g. skip the lane's gradient contribution this step / reassign its shard)
* ``dead``      — stale beyond `dead_after` (failure hook fires: elastic
  shrink, or the serving cluster's re-homing)

Host-only: ``repro/ft/watchdog.py`` with the clock injectable (``clock=``)
and one classification pass callable alone (:meth:`Watchdog.sweep`), so the
tests drive it on a fake clock as well as with injected stalls (``tests/test_torch_controller.py``,
``tests/test_torch_cluster.py``).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional


@dataclass
class LaneState:
    name: str
    last_beat: float
    step: int = 0
    status: str = "ok"  # ok | straggler | dead


class Watchdog:
    def __init__(
        self,
        straggler_after: float = 1.0,
        dead_after: float = 5.0,
        on_straggler: Optional[Callable[[str, LaneState], None]] = None,
        on_dead: Optional[Callable[[str, LaneState], None]] = None,
        poll: float = 0.05,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.straggler_after = straggler_after
        self.dead_after = dead_after
        self.on_straggler = on_straggler
        self.on_dead = on_dead
        self.poll = poll
        self.clock = clock
        self._lanes: dict[str, LaneState] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------ API

    def register(self, lane: str) -> None:
        with self._lock:
            self._lanes[lane] = LaneState(lane, self.clock())

    def beat(self, lane: str, step: Optional[int] = None) -> None:
        with self._lock:
            st = self._lanes[lane]
            st.last_beat = self.clock()
            if step is not None:
                st.step = step
            if st.status != "dead":  # dead lanes need explicit revive
                st.status = "ok"

    def revive(self, lane: str) -> None:
        with self._lock:
            st = self._lanes[lane]
            st.status = "ok"
            st.last_beat = self.clock()

    def status(self, lane: str) -> str:
        with self._lock:
            return self._lanes[lane].status

    def stale_seconds(self, lane: str) -> float:
        """Seconds since the lane's last beat — telemetry for supervisors
        that want the raw staleness, not just the classified status (the
        serving cluster reports it; tests assert against thresholds)."""
        with self._lock:
            return self.clock() - self._lanes[lane].last_beat

    def snapshot(self) -> dict[str, str]:
        with self._lock:
            return {k: v.status for k, v in self._lanes.items()}

    # ------------------------------------------------------------- lifecycle

    def start(self) -> "Watchdog":
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stop the thread, waiting for the sweep in progress and the hooks
        it fires (a serving cluster's re-homing) to end."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join()

    def sweep(self) -> None:
        """One classification pass over the lanes; fires the hooks of the
        lanes that turned straggler or dead (outside the lock)."""
        now = self.clock()
        fire: list[tuple[str, str, LaneState]] = []
        with self._lock:
            for st in self._lanes.values():
                stale = now - st.last_beat
                if st.status == "dead":
                    continue
                if stale > self.dead_after:
                    st.status = "dead"
                    fire.append(("dead", st.name, st))
                elif stale > self.straggler_after and st.status == "ok":
                    st.status = "straggler"
                    fire.append(("straggler", st.name, st))
        for kind, name, st in fire:
            cb = self.on_dead if kind == "dead" else self.on_straggler
            if cb is not None:
                cb(name, st)

    def _loop(self) -> None:
        while not self._stop.is_set():
            self.sweep()
            time.sleep(self.poll)
